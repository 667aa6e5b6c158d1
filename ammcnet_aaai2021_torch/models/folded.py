"""Folded two-stream inference forward: both streams' convs as ONE stack.

Port of ``ammcnet_aaai2021_tpu/models/folded.py``.  The rgb and op
streams share conv topology at every level (reference ``unet.py:967-1007``
builds two identical UNetMem stacks), so both streams' convolutions run as
one grouped convolution (``groups=2``: the rgb stream's channels first,
the op stream's after them), the counterpart of the XLA convolution with
``feature_group_count=2`` that the JAX package's stream-axis ``vmap``
lowers to: half the convolutions, twice the channels each.

Only three leaves differ in shape between the streams and are zero-padded
exactly, as in the JAX package (no approximation):

* ``inc`` conv0's weight: the op input's 6 channels -> 12 (the padded
  input channels are zeros, so the extra taps contribute exactly 0);
* ``outc``'s weight and bias: the op output's 2 channels -> 3 (the extra
  channel is computed and sliced away).

The bridge stays per stream (it crosses streams by definition), and so do
the two memory blocks: each stream's lookup runs on kernel B1 through its
registered op (``ops/library.py``).  Inference only, with the running
BatchNorm statistics.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import BatchNorm2d, Conv2d, ConvTranspose2d
from .memory_module import EncQuanDecResTopK
from .unet_mem import BRIDGES

StateDict = Dict[str, torch.Tensor]
# the encoder's DoubleConvs, by the torch names of their Sequential
_ENCODER = ("inc.conv.conv.", "down1.mpconv.1.conv.", "down2.mpconv.1.conv.",
            "down3.mpconv.1.conv.")
_MEMORY = "vq_down3."


def _pad_to(o: torch.Tensor, target_shape) -> torch.Tensor:
    """Zero-pad trailing extents of ``o`` up to ``target_shape``."""
    pads = []
    for have, want in zip(reversed(o.shape), reversed(target_shape)):
        if have > want:
            raise ValueError(f"cannot shrink {tuple(o.shape)} to "
                             f"{tuple(target_shape)}")
        pads += [0, want - have]
    return F.pad(o, pads) if any(pads) else o


def fold_twostream_variables(state_dict: Mapping[str, torch.Tensor]
                             ) -> Tuple[StateDict, StateDict]:
    """Stack a ``TwoStreamUNetMem`` state dict's rgb and op stream entries
    along a new leading stream axis (rgb 0, op 1), zero-padding the op
    stream's shape-divergent entries (``inc`` conv0's input channels,
    ``outc``'s output channels) to the rgb stream's widths.

    Returns ``(stacked_stream_state, bridge_state)``, keyed by the
    stream's and the bridge's own names (``inc.conv.conv.0.weight``,
    ``O2F.conv.0.weight``)."""
    stacked: StateDict = {}
    bridge: StateDict = {}
    for key, value in state_dict.items():
        if key.startswith("rgb."):
            name = key[len("rgb."):]
            op = state_dict[f"op.{name}"]
            stacked[name] = torch.stack([value, _pad_to(op, value.shape)])
        elif key.startswith("bridge."):
            bridge[key[len("bridge."):]] = value
    return stacked, bridge


def _gconv(weight: torch.Tensor, bias=None, padding: int = 1) -> Conv2d:
    """Both streams' convolution, from the stacked (2, out, in, kh, kw)
    weight, as one ``groups=2`` convolution."""
    _, cout, cin, kh, kw = weight.shape
    conv = Conv2d(2 * cin, 2 * cout, kh, padding=padding,
                  bias=bias is not None, groups=2)
    with torch.no_grad():
        conv.weight.copy_(weight.reshape(2 * cout, cin, kh, kw))
        if bias is not None:
            conv.bias.copy_(bias.reshape(-1))
    return conv


def _bn(sd: StateDict, prefix: str) -> BatchNorm2d:
    c = sd[f"{prefix}weight"].numel()
    bn = BatchNorm2d(c, eps=1e-5, momentum=0.1)
    bn.load_state_dict({name: sd[f"{prefix}{name}"].reshape(-1)
                        if name != "num_batches_tracked"
                        else sd[f"{prefix}{name}"][0]
                        for name in ("weight", "bias", "running_mean",
                                     "running_var", "num_batches_tracked")})
    return bn


def _double(sd: StateDict, prefix: str) -> nn.Sequential:
    layers = []
    for conv, bn in (("0", "1"), ("3", "4")):
        layers += [_gconv(sd[f"{prefix}{conv}.weight"]),
                   _bn(sd, f"{prefix}{bn}."), nn.ReLU(inplace=True)]
    return nn.Sequential(*layers)


def _fold_cat(skip: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Each stream's ``[skip, up]`` concat, in the folded channel order
    (the rgb stream's channels, then the op stream's)."""
    s_rgb, s_op = skip.chunk(2, dim=1)
    u_rgb, u_op = up.chunk(2, dim=1)
    return torch.cat([s_rgb, u_rgb, s_op, u_op], dim=1)


class _FoldedUp(nn.Module):
    """Both streams' ``Up`` (unet.py:44-59): the transposed conv as one
    ``groups=2`` transposed conv, the concat per stream, the DoubleConv
    folded."""

    def __init__(self, sd: StateDict, prefix: str):
        super().__init__()
        w = sd[f"{prefix}up.weight"]  # (2, in, out, 2, 2)
        _, cin, cout, kh, kw = w.shape
        self.up = ConvTranspose2d(2 * cin, 2 * cout, kh, stride=2, groups=2)
        with torch.no_grad():
            self.up.weight.copy_(w.reshape(2 * cin, cout, kh, kw))
            self.up.bias.copy_(sd[f"{prefix}up.bias"].reshape(-1))
        self.conv = _double(sd, f"{prefix}conv.conv.")

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = self.up(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(_fold_cat(x2, x1))


class FoldedTwoStreamUNetMem(nn.Module):
    """The released generator's inference forward with both streams'
    convolutions folded (``groups=2``), built from
    :func:`fold_twostream_variables`' output.  ``forward(rgb_x, op_x)``
    takes NCHW clips and returns ``(rgb_pred, op_pred, (rgb_diff,
    op_diff), None)`` as ``TwoStreamUNetMem`` in eval mode does (its
    straight-through codes omitted: no inference consumer reads them)."""

    def __init__(self, stream_state: Mapping[str, torch.Tensor],
                 bridge_state: Mapping[str, torch.Tensor],
                 rgb_in: int = 12, op_out: int = 2, embed_dim: int = 64,
                 n_embed: int = 256, k: int = 2,
                 dtype: torch.dtype = torch.bfloat16,
                 use_kernel: bool = False, per_sample_diff: bool = False,
                 bridge_kind: str = "amft"):
        super().__init__()
        sd = dict(stream_state)
        self.dtype = dtype
        self.rgb_in, self.op_out = rgb_in, op_out
        self.inc = _double(sd, _ENCODER[0])
        self.down = nn.ModuleList(
            nn.Sequential(nn.MaxPool2d(2), _double(sd, p))
            for p in _ENCODER[1:])
        self.mem = nn.ModuleList()
        for s in range(2):
            block = EncQuanDecResTopK(512, embed_dim, n_embed, k, use_kernel,
                                      per_sample_diff)
            block.load_state_dict({key[len(_MEMORY):]: v[s]
                                   for key, v in sd.items()
                                   if key.startswith(_MEMORY)})
            self.mem.append(block)
        self.bridge = BRIDGES[bridge_kind](512)
        self.bridge.load_state_dict(dict(bridge_state))
        self.ups = nn.ModuleList(_FoldedUp(sd, f"up{i}.") for i in (1, 2, 3))
        self.outc = _gconv(sd["outc.weight"], sd["outc.bias"])
        self.eval()

    def forward(self, rgb_x: torch.Tensor, op_x: torch.Tensor):
        if self.training:
            raise RuntimeError("the folded forward is inference only")
        op_p = _pad_to(op_x, (*op_x.shape[:1], self.rgb_in, *op_x.shape[2:]))
        x1 = self.inc(torch.cat([rgb_x, op_p], dim=1).to(self.dtype))
        x2 = self.down[0](x1)
        x3 = self.down[1](x2)
        x4 = self.down[2](x3)
        r4, o4 = x4.chunk(2, dim=1)
        r4, rgb_diff, _ = self.mem[0](r4)
        o4, op_diff, _ = self.mem[1](o4)
        r4, o4 = self.bridge(r4, o4)
        y = self.ups[0](torch.cat([r4, o4], dim=1), x3)
        y = self.ups[1](y, x2)
        y = self.ups[2](y, x1)
        out = torch.tanh(self.outc(y).float())
        rgb_out = out.shape[1] // 2
        return (out[:, :rgb_out], out[:, rgb_out:rgb_out + self.op_out],
                (rgb_diff, op_diff), None)


def make_folded_forward(state_dict: Mapping[str, torch.Tensor],
                        rgb_in: int = 12, op_out: int = 2,
                        embed_dim: int = 64, n_embed: int = 256, k: int = 2,
                        dtype: torch.dtype = torch.bfloat16,
                        use_kernel: bool = False,
                        per_sample_diff: bool = False,
                        bridge_kind: str = "amft") -> FoldedTwoStreamUNetMem:
    """The folded forward of a ``TwoStreamUNetMem`` state dict (JAX
    ``make_folded_forward``, with the folded weights bound at
    construction)."""
    stream_state, bridge_state = fold_twostream_variables(state_dict)
    return FoldedTwoStreamUNetMem(stream_state, bridge_state, rgb_in, op_out,
                                  embed_dim, n_embed, k, dtype, use_kernel,
                                  per_sample_diff, bridge_kind)
