"""Memory-augmented UNet streams and the two-stream AMMC generator.

Port of ``ammcnet_aaai2021_tpu/models/unet_mem.py``:

* :class:`UNetMemStream` == ``UNetMem_v7`` (unet.py:908-938): 4-level UNet
  with a residual top-k memory block at the 512-channel bottleneck
  (``residual_memory=False``: the JAX package's single non-residual block).
* :class:`UNetMemV4` == ``UNetMem_v4`` (unet.py:393-430): residual memory
  blocks at the 256-channel (down2) and 512-channel (down3) levels.
* :class:`AMFTBridge` == ``bridge`` (unet.py:956-964): additive cross-stream
  feature transfer, ``x = zx + O2F(zy); y = zy + F2O(zx)``.  The reference
  spells the F2O submodule ``F20``; the name is kept so its state dicts load.
* :class:`ConcatBridge` / :class:`AddBridge` == ``bridge_concat_dire`` /
  ``bridge_add_dire`` (unet.py:1010-1028), the ablations: both collapse the
  two bottlenecks into one shared code.
* :class:`TwoStreamUNetMem` == ``twostream`` (unet.py:967-1007): the released
  AMMCNet generator — twin streams for RGB (12->3 ch) and optical flow
  (6->2 ch) with the AMFT bridge (or, by ``bridge_kind``, an ablation)
  between the quantized bottlenecks.

Inputs are channel-stacked clips ``(b, t*c, h, w)``; the generator casts
them to its compute ``dtype`` (parameters and codebook stay float32) and
returns float32 tanh frames plus per-stream commit distances and
straight-through codes.  On a CUDA device a stream runs channels-last
between the two (``blocks.to_compute``, in the cast's one copy): every
convolution, BatchNorm, pool and skip concatenation of the stream, and its
memory block, in NHWC memory, which cuDNN's kernels read without
transposing.  The predictions leave NCHW-contiguous, in the cast to float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from .blocks import Conv2d, DoubleConv, Down, InConv, Up, to_compute
from .memory_module import EncQuanDecResTopK, EncQuanDecTopK


class UNetMemStream(nn.Module):
    """UNetMem_v7: residual memory at the 512-ch bottleneck (unet.py:908-938).

    Alone it is the stage-1 generator: its forward casts the input to
    ``dtype`` (when given) and returns ``(tanh frame, commit distance,
    straight-through code)``.  The two-stream generator drives its
    encode / memory / decode phases itself.  ``residual_memory=False``
    makes the bottleneck block :class:`EncQuanDecTopK`, without the
    residual."""

    def __init__(self, in_channels: int, out_channels: int = 3,
                 embed_dim: int = 64, n_embed: int = 512, k: int = 1,
                 use_kernel: bool = False, per_sample_diff: bool = False,
                 dtype: Optional[torch.dtype] = None,
                 residual_memory: bool = True):
        super().__init__()
        self.dtype = dtype
        self.inc = InConv(in_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        mem = EncQuanDecResTopK if residual_memory else EncQuanDecTopK
        self.vq_down3 = mem(512, embed_dim, n_embed, k, use_kernel,
                            per_sample_diff)
        self.up1 = Up(512, 256)
        self.up2 = Up(256, 128)
        self.up3 = Up(128, 64)
        self.outc = Conv2d(64, out_channels, 3, padding=1)

    def encode(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
        """The four levels' outputs, from ``x`` cast to ``dtype`` (its own
        when None), channels-last on a CUDA device."""
        x1 = self.inc(to_compute(x, dtype))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        return x1, x2, x3, x4

    def memory(self, x4: torch.Tensor):
        return self.vq_down3(x4)

    def decode(self, x4: torch.Tensor, skips) -> torch.Tensor:
        x1, x2, x3 = skips
        y = self.up1(x4, x3)
        y = self.up2(y, x2)
        y = self.up3(y, x1)
        return torch.tanh(self.outc(y).to(torch.float32,
                                          memory_format=torch.contiguous_format))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x1, x2, x3, x4 = self.encode(x, self.dtype)
        x4, diff, q_st = self.memory(x4)
        return self.decode(x4, (x1, x2, x3)), diff, q_st


class UNetMemV4(UNetMemStream):
    """UNetMem_v4 (unet.py:393-430): the stream with a second residual
    memory, at the 256-ch level (down2).  Its forward casts the input to
    ``dtype`` (when given) and returns ``(tanh frame, diff_256 + diff_512,
    (code_256, code_512))``."""

    def __init__(self, in_channels: int, out_channels: int = 3,
                 embed_dim: int = 64, n_embed: int = 512, k: int = 1,
                 use_kernel: bool = False, per_sample_diff: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, embed_dim, n_embed, k,
                         use_kernel, per_sample_diff, dtype)
        self.vq_down2 = EncQuanDecResTopK(256, embed_dim, n_embed, k,
                                          use_kernel, per_sample_diff)

    def forward(self, x: torch.Tensor):
        x1 = self.inc(to_compute(x, self.dtype))
        x2 = self.down1(x1)
        x3, diff_3, code_3 = self.vq_down2(self.down2(x2))
        x4, diff_4, code_4 = self.vq_down3(self.down3(x3))
        return (self.decode(x4, (x1, x2, x3)), diff_3 + diff_4,
                (code_3, code_4))


class AMFTBridge(nn.Module):
    """Additive appearance-motion feature transfer (unet.py:956-964)."""

    def __init__(self, features: int = 512):
        super().__init__()
        self.O2F = DoubleConv(features, features)
        self.F20 = DoubleConv(features, features)  # F2O, as the reference spells it

    def forward(self, zx: torch.Tensor, zy: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return zx + self.O2F(zy), zy + self.F20(zx)


class ConcatBridge(nn.Module):
    """Ablation: concat, then a 1x1; one code for both streams
    (unet.py:1010-1018)."""

    def __init__(self, features: int = 512):
        super().__init__()
        self.dec = Conv2d(2 * features, features, 1)

    def forward(self, zx: torch.Tensor, zy: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.dec(torch.cat([zx, zy], dim=1))
        return z, z


class AddBridge(nn.Module):
    """Ablation: a plain add; one code for both streams (unet.py:1021-1028)."""

    def __init__(self, features: int = 512):
        super().__init__()

    def forward(self, zx: torch.Tensor, zy: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = zx + zy
        return z, z


BRIDGES = {"amft": AMFTBridge, "concat_dire": ConcatBridge,
           "add_dire": AddBridge}


class TwoStreamUNetMem(nn.Module):
    """The released AMMCNet generator (reference twostream, unet.py:967-1007).

    Returns ``(rgb_pred, op_pred, (rgb_diff, op_diff), (rgb_code, op_code))``
    mirroring the reference's 4-tuple.  ``bridge_kind`` is a key of
    :data:`BRIDGES`: ``"amft"`` (the released bridge), ``"concat_dire"`` or
    ``"add_dire"``.
    """

    def __init__(self, rgb_in: int = 12, op_in: int = 6, rgb_out: int = 3,
                 op_out: int = 2, embed_dim: int = 64, n_embed: int = 512,
                 k: int = 1, dtype: torch.dtype = torch.bfloat16,
                 use_kernel: bool = False, per_sample_diff: bool = False,
                 bridge_kind: str = "amft"):
        super().__init__()
        if bridge_kind not in BRIDGES:
            raise ValueError(f"unknown bridge_kind {bridge_kind!r}; "
                             f"want one of {sorted(BRIDGES)}")
        self.dtype = dtype
        self.rgb = UNetMemStream(rgb_in, rgb_out, embed_dim, n_embed, k,
                                 use_kernel, per_sample_diff)
        self.op = UNetMemStream(op_in, op_out, embed_dim, n_embed, k,
                                use_kernel, per_sample_diff)
        self.bridge = BRIDGES[bridge_kind](512)

    def forward(self, rgb_x: torch.Tensor, op_x: torch.Tensor):
        # the JAX forward's order: rgb encode -> rgb memory -> op encode ->
        # op memory -> bridge -> decoders
        r1, r2, r3, r4 = self.rgb.encode(rgb_x, self.dtype)
        r4, rgb_diff, rgb_code = self.rgb.memory(r4)
        o1, o2, o3, o4 = self.op.encode(op_x, self.dtype)
        o4, op_diff, op_code = self.op.memory(o4)
        r4, o4 = self.bridge(r4, o4)
        rgb_pred = self.rgb.decode(r4, (r1, r2, r3))
        op_pred = self.op.decode(o4, (o1, o2, o3))
        return rgb_pred, op_pred, (rgb_diff, op_diff), (rgb_code, op_code)
