"""int8 two-stream inference forward.

Port of ``ammcnet_aaai2021_tpu/models/quantized.py``, with its function
names: the released two-stream generator's inference forward (reference
``Code/models/unet.py:967-1007``) with every 3x3 conv and 2x2 transposed
conv in int8, through the port's own kernels (``ops/int8_kernels.py``,
``csrc/int8_conv.cu``): no PyTorch call computes an int8 convolution on
the card.

* **BatchNorm folding** at weight preparation
  (:func:`quantize_twostream_variables`, from the port's
  ``TwoStreamUNetMem`` state dict): ``W'[.., c] = W[.., c] * g[c] /
  sqrt(v[c] + eps)``, ``b'[c] = beta[c] - g[c] * mu[c] / sqrt(v[c] +
  eps)``, in float32.
* **Per-output-channel symmetric int8 weights**: ``scale_w[c] =
  max|W'[.., c]| / 127``, kept in the JAX package's layout (``w``, HWIO;
  ``(kh, kw, out, in)`` for the transposed conv) and in the kernel's
  (``wk``, channels padded once).
* **Activation quantization**: dynamic per-tensor (``scale_x = max|x| /
  127`` on the device) or calibrated static scales
  (:func:`calibrate_act_scales`); PyTorch ops, as the JAX package leaves
  it to XLA.  With calibrated scales each DoubleConv's conv0 -> conv1
  activation stays int8 (``resident=True``): conv0's epilogue quantizes to
  conv1's scale, bit-exact against the bf16 hand-off.
* int32 accumulation, the epilogue in float32 (each product and sum
  rounded), bf16 out, ReLU.

The memory block, its 1x1 codec convs and the final tanh stay on the bf16
float path (B1 runs there on the card).  The forward runs channel-last from
its entry onwards and returns the float generator's contract,
``(rgb_pred, op_pred, (rgb_diff, op_diff), None)`` with NCHW predictions,
so ``eval/infer.py:score_dataset`` takes it as it takes the generator.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.int8_kernels import (
    CIN_ALIGN,
    COLS_ALIGN,
    pad_channels,
    qconv3x3_int8,
    qconv_transpose2x2_int8,
)
from .memory_module import EncQuanDecResTopK

_BN_EPS = 1e-5
STREAMS = ("rgb", "op")
N_SITES = 40  # 18 convs a stream + 2 bridges x 2 convs
# the torch names of each generator part's DoubleConv, in the JAX tree's
# names
_DOUBLE = {"inc": "inc.conv.conv.", "down1": "down1.mpconv.1.conv.",
           "down2": "down2.mpconv.1.conv.",
           "down3": "down3.mpconv.1.conv."}


def _quant_weight(w: torch.Tensor, out_axis: int) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a float32 kernel
    (JAX ``_quant_weight``)."""
    reduce_axes = tuple(i for i in range(w.ndim) if i != out_axis)
    amax = w.abs().amax(dim=reduce_axes)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    shape = [1] * w.ndim
    shape[out_axis] = -1
    wq = torch.round(w / scale.reshape(shape)).clamp(-127, 127)
    return {"w": wq.to(torch.int8), "scale": scale.float()}


def _fold_bn(kernel: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             mean: torch.Tensor, var: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into the preceding (bias-free) HWIO kernel,
    in float32.  The square root is taken in float64 and rounded once to
    float32, which is the correctly rounded float32 root (PyTorch's
    vectorized float32 sqrt on the CPU is not, on some values)."""
    f = gamma / torch.sqrt((var + _BN_EPS).double()).float()
    return kernel * f, beta - mean * f


def _pad_rows(wk: torch.Tensor) -> torch.Tensor:
    """Zero rows up to a multiple of the kernel's column tile."""
    extra = -wk.shape[0] % COLS_ALIGN
    if extra:
        wk = torch.cat([wk, wk.new_zeros((extra, *wk.shape[1:]))])
    return wk.contiguous()


def _kernel_layout(wq: torch.Tensor, transposed: bool) -> torch.Tensor:
    """The int8 weights in the kernel's layout: a 3x3 HWIO kernel as
    (Cout_pad, 9, Cin_pad); a (2, 2, out, in) transposed one as (Cols_pad,
    1, Cin_pad), row (a * 2 + b) * out + co."""
    if transposed:
        kh, kw, cout, cin = wq.shape
        wk = wq.reshape(kh * kw * cout, 1, cin)
    else:
        kh, kw, cin, cout = wq.shape
        wk = wq.permute(3, 0, 1, 2).reshape(cout, kh * kw, cin)
    return _pad_rows(pad_channels(wk, CIN_ALIGN))


def _q_conv(kernel: torch.Tensor, bias: torch.Tensor, out_axis: int
            ) -> Dict[str, torch.Tensor]:
    q = _quant_weight(kernel, out_axis)
    q["bias"] = bias.float()
    q["wk"] = _kernel_layout(q["w"], transposed=out_axis == 2)
    return q


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    """A torch conv weight (out, in, kh, kw), or a transposed conv's (in,
    out, kh, kw), in the JAX layout: HWIO, or (kh, kw, out, in)."""
    return weight.float().permute(2, 3, 1, 0).contiguous()


def _q_double_conv(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    """A DoubleConv (``<prefix>{0,3}.weight``, BatchNorm ``<prefix>{1,4}``)
    folded and quantized (JAX ``_q_double_conv``)."""
    out = {}
    for i, (conv, bn) in enumerate((("0", "1"), ("3", "4"))):
        kernel, bias = _fold_bn(
            _hwio(sd[f"{prefix}{conv}.weight"]),
            *(sd[f"{prefix}{bn}.{name}"].float() for name in (
                "weight", "bias", "running_mean", "running_var")))
        out[f"conv{i}"] = _q_conv(kernel, bias, out_axis=3)
    return out


def quantize_twostream_variables(state_dict: Mapping[str, torch.Tensor]
                                 ) -> Dict:
    """The int8 weight tree from a ``TwoStreamUNetMem`` state dict (BN
    folded, weights int8 + per-channel scales), in the JAX tree's shape:
    ``streams/<s>/{inc,down1..3}/conv{0,1}``, ``streams/<s>/up{1..3}/up``,
    ``streams/<s>/up{1..3}/conv/conv{0,1}``, ``streams/<s>/outc``,
    ``bridge/{O2F,F2O}/conv{0,1}``, each ``{w, scale, bias, wk}``.  ``mem``
    carries each stream's original memory block (``vq_down3``) state for
    the float memory block."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    q: Dict = {"streams": {}, "bridge": {}, "mem": {}}
    for s in STREAMS:
        sq: Dict = {lvl: _q_double_conv(sd, f"{s}.{prefix}")
                    for lvl, prefix in _DOUBLE.items()}
        for lvl in ("up1", "up2", "up3"):
            sq[lvl] = {"up": _q_conv(_hwio(sd[f"{s}.{lvl}.up.weight"]),
                                     sd[f"{s}.{lvl}.up.bias"], out_axis=2),
                       "conv": _q_double_conv(sd, f"{s}.{lvl}.conv.conv.")}
        sq["outc"] = _q_conv(_hwio(sd[f"{s}.outc.weight"]),
                             sd[f"{s}.outc.bias"], out_axis=3)
        q["streams"][s] = sq
        head = f"{s}.vq_down3."
        q["mem"][s] = {k[len(head):]: v for k, v in sd.items()
                       if k.startswith(head)}
    for side, name in (("O2F", "O2F"), ("F2O", "F20")):
        q["bridge"][side] = _q_double_conv(sd, f"bridge.{name}.conv.")
    return q


def _quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(), 1e-12) / 127.0
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


def _quant_in(x: torch.Tensor, q, record: Optional[Dict], site: str
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a conv input: the site's calibrated scale if it has one,
    else dynamic per-tensor; ``record`` keeps the site's running max|x|.
    An int8 input was quantized to this site's scale by its producer."""
    if x.dtype == torch.int8:
        if record is not None:
            raise ValueError("a record pass cannot take int8 inputs")
        return x, q["act_scale"]
    if record is not None:
        m = x.float().abs().amax()
        prev = record.get(site)
        record[site] = m if prev is None else torch.maximum(prev, m)
    sx = q.get("act_scale")
    if sx is None:
        return _quant_act(x)
    xq = torch.round(x.float() / sx).clamp(-127, 127).to(torch.int8)
    return xq, sx


def _qconv(x: torch.Tensor, q, relu: bool, record: Optional[Dict] = None,
           site: str = "", out_scale: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """A 3x3 int8 conv with the JAX epilogue: NHWC in -> NHWC bf16 (int8 at
    ``out_scale``)."""
    xq, sx = _quant_in(x, q, record, site)
    return qconv3x3_int8(pad_channels(xq).contiguous(), q["wk"],
                         sx.reshape(1), q["scale"], q["bias"],
                         q["scale"].numel(), relu, out_scale)


def _qconv_transpose(x: torch.Tensor, q, record: Optional[Dict] = None,
                     site: str = "") -> torch.Tensor:
    xq, sx = _quant_in(x, q, record, site)
    return qconv_transpose2x2_int8(pad_channels(xq).contiguous(), q["wk"],
                                   sx.reshape(1), q["scale"], q["bias"],
                                   q["scale"].numel())


def _q_double(x: torch.Tensor, q, record: Optional[Dict] = None,
              site: str = "", resident: bool = True) -> torch.Tensor:
    # conv0 -> conv1 has one consumer at every site, so it carries int8
    # residency whenever conv1's scale is calibrated (never in a record
    # pass)
    nxt = (q["conv1"].get("act_scale") if resident and record is None
           else None)
    x = _qconv(x, q["conv0"], True, record, f"{site}/conv0", out_scale=nxt)
    return _qconv(x, q["conv1"], True, record, f"{site}/conv1")


def _q_down(x: torch.Tensor, q, record: Optional[Dict] = None,
            site: str = "", resident: bool = True) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    return _q_double(x, q, record, site, resident)


def _q_up(x1: torch.Tensor, skip: torch.Tensor, q,
          record: Optional[Dict] = None, site: str = "",
          resident: bool = True) -> torch.Tensor:
    x1 = _qconv_transpose(x1, q["up"], record, f"{site}/up")
    x = torch.cat([skip, x1], dim=-1)
    return _q_double(x, q["conv"], record, f"{site}/conv", resident)


class _QSite(nn.Module):
    """One quantized conv's tensors as buffers (they follow ``.to``): the
    kernel-layout weights ``wk``, ``scale``, ``bias`` and, once calibrated,
    ``act_scale`` (1,).  Read like the JAX tree's dicts."""

    KEYS = ("wk", "scale", "bias", "act_scale")

    def __init__(self, q: Mapping[str, torch.Tensor]):
        super().__init__()
        for key in self.KEYS:
            if key in q:
                self.register_buffer(key, torch.as_tensor(q[key]).reshape(
                    1) if key == "act_scale" else q[key])

    def __getitem__(self, key: str) -> torch.Tensor:
        return getattr(self, key)

    def get(self, key: str, default=None):
        return getattr(self, key, default)


def _tree(q: Mapping) -> nn.Module:
    if "wk" in q:
        return _QSite(q)
    return nn.ModuleDict({k: _tree(v) for k, v in q.items()})


class QuantizedTwoStreamUNetMem(nn.Module):
    """The released generator's int8 inference forward (JAX
    ``make_quantized_forward``'s ``forward``), built on a tree from
    :func:`quantize_twostream_variables` (or :func:`calibrate_act_scales`).
    ``forward(rgb_x, op_x, record=None)`` takes NCHW clips (any float
    dtype; the quantize reads them in float32) and returns ``(rgb_pred,
    op_pred, (rgb_diff, op_diff), None)``, predictions float32 NCHW.
    ``record`` (a dict): the record pass, every site's max|x| as a 0-d
    tensor on the device, dynamic scales, no residency."""

    def __init__(self, qvars: Mapping, embed_dim: int = 64,
                 n_embed: int = 256, k: int = 2, bridge_kind: str = "amft",
                 per_sample_diff: bool = False, use_kernel: bool = False,
                 resident: bool = True):
        super().__init__()
        if bridge_kind != "amft":
            raise NotImplementedError(
                "the quantized forward covers the released amft bridge; "
                f"got {bridge_kind!r}")
        self.dtype = torch.bfloat16  # the float path's, and the flows'
        self.resident = resident
        self.mem = nn.ModuleDict()
        for s in STREAMS:
            block = EncQuanDecResTopK(512, embed_dim, n_embed, k, use_kernel,
                                      per_sample_diff)
            block.load_state_dict(qvars["mem"][s])
            self.mem[s] = block
        self.q = _tree({"streams": qvars["streams"],
                        "bridge": qvars["bridge"]})
        self.eval()

    def _memory(self, s: str, z: torch.Tensor):
        out, diff, _ = self.mem[s](z.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1), diff

    def _encode(self, sq, x, rec, base):
        r = self.resident
        x1 = _q_double(x, sq["inc"], rec, f"{base}/inc", r)
        x2 = _q_down(x1, sq["down1"], rec, f"{base}/down1", r)
        x3 = _q_down(x2, sq["down2"], rec, f"{base}/down2", r)
        x4 = _q_down(x3, sq["down3"], rec, f"{base}/down3", r)
        return x1, x2, x3, x4

    def _decode(self, sq, x4, skips, rec, base):
        r = self.resident
        x1, x2, x3 = skips
        y = _q_up(x4, x3, sq["up1"], rec, f"{base}/up1", r)
        y = _q_up(y, x2, sq["up2"], rec, f"{base}/up2", r)
        y = _q_up(y, x1, sq["up3"], rec, f"{base}/up3", r)
        y = _qconv(y, sq["outc"], False, rec, f"{base}/outc")
        return torch.tanh(y.float()).permute(0, 3, 1, 2)

    def forward(self, rgb_x: torch.Tensor, op_x: torch.Tensor,
                record: Optional[Dict] = None):
        sq_r, sq_o = self.q["streams"]["rgb"], self.q["streams"]["op"]
        rgb_x, op_x = (x.permute(0, 2, 3, 1) for x in (rgb_x, op_x))
        r1, r2, r3, r4 = self._encode(sq_r, rgb_x, record, "streams/rgb")
        o1, o2, o3, o4 = self._encode(sq_o, op_x, record, "streams/op")
        r4m, rgb_diff = self._memory("rgb", r4)
        o4m, op_diff = self._memory("op", o4)
        # AMFT bridge (unet.py:956-964): x = zx + O2F(zy); y = zy + F2O(zx)
        bridge = self.q["bridge"]
        r4b = r4m + _q_double(o4m, bridge["O2F"], record, "bridge/O2F",
                              self.resident)
        o4b = o4m + _q_double(r4m, bridge["F2O"], record, "bridge/F2O",
                              self.resident)
        rgb_pred = self._decode(sq_r, r4b, (r1, r2, r3), record,
                                "streams/rgb")
        op_pred = self._decode(sq_o, o4b, (o1, o2, o3), record, "streams/op")
        return rgb_pred, op_pred, (rgb_diff, op_diff), None


def make_quantized_forward(qvars: Mapping, embed_dim: int = 64,
                           n_embed: int = 256, k: int = 2,
                           bridge_kind: str = "amft",
                           per_sample_diff: bool = False,
                           use_kernel: bool = False,
                           resident: bool = True
                           ) -> QuantizedTwoStreamUNetMem:
    """The int8 forward as a module (JAX ``make_quantized_forward``, with
    the weight tree bound at construction); ``resident`` as there: a no-op
    for uncalibrated trees and record passes."""
    return QuantizedTwoStreamUNetMem(qvars, embed_dim, n_embed, k,
                                     bridge_kind, per_sample_diff,
                                     use_kernel, resident)


def calibrate_act_scales(forward: QuantizedTwoStreamUNetMem, qvars: Mapping,
                         batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                         headroom: float = 1.0) -> Dict:
    """Static activation scales: run ``forward`` (built on the dynamic tree
    ``qvars``) over ``batches`` of ``(rgb_x, op_x)`` NCHW clips in record
    mode, keep each conv input's running max|x| (one fetch a batch), and
    return a copy of ``qvars`` with ``act_scale`` (float32 arithmetic, as
    the JAX package's) at every site.  Raises unless all 40 sites
    recorded."""
    record: Dict[str, float] = {}
    with torch.inference_mode():
        for rgb_x, op_x in batches:
            rec: Dict[str, torch.Tensor] = {}
            forward(rgb_x, op_x, record=rec)
            got = torch.stack([rec[s].float() for s in rec]).cpu().tolist()
            for site, m in zip(rec, got):
                record[site] = max(record.get(site, 0.0), m)
    if len(record) != N_SITES:
        raise RuntimeError(f"calibration recorded {len(record)} sites, "
                           f"expected {N_SITES}: the forward's structure "
                           "drifted")

    def apply_scales(tree: Mapping, base: str) -> Dict:
        out = {}
        for key, v in tree.items():
            path = f"{base}/{key}"
            if path in record:  # a quantized conv's dict
                m = np.maximum(np.float32(record[path]), np.float32(1e-12))
                s = np.float32(m * np.float32(headroom)) / np.float32(127.0)
                v = dict(v, act_scale=torch.tensor([s], dtype=torch.float32))
            elif isinstance(v, Mapping) and "wk" not in v:
                v = apply_scales(v, path)
            out[key] = v
        return out

    qcal = dict(qvars)
    qcal["streams"] = apply_scales(qvars["streams"], "streams")
    qcal["bridge"] = apply_scales(qvars["bridge"], "bridge")
    return qcal


def calibrated_int8_from_dataset(net_cfg, state_dict: Mapping, data_dir: str,
                                 dataset_name: str, image_size: int,
                                 calib_batches: int = 4,
                                 calib_batch_size: int = 8,
                                 use_native_loader: bool = False,
                                 device="cpu"):
    """``run_test --int8``'s serving prep (JAX
    ``calibrated_int8_from_dataset``): quantize the generator's state dict,
    then calibrate activation scales on clips the training sampler draws
    (seed 2017, as the JAX sampler) from the dataset's TRAINING split.
    ``use_native_loader``: JPEG frames and ``.flo`` flows through
    ``data/native.py`` (decoded on ``device``), for a machine without cv2.
    Returns ``(model, qcal)``: the calibrated forward on ``device``, in
    eval mode, and its weight tree."""
    from ..data import get_dataset
    from ..data.datasets import TwoStreamTrainSampler, VideoIndex

    kwargs = dict(embed_dim=net_cfg.embed_dim, n_embed=net_cfg.n_embed,
                  k=net_cfg.k, per_sample_diff=True,
                  use_kernel=net_cfg.use_memory_kernel)
    qvars = quantize_twostream_variables(state_dict)
    fwd = make_quantized_forward(qvars, **kwargs).to(device)
    train_root = os.path.join(data_dir, dataset_name, "training")
    roots = (os.path.join(train_root, "frames"),
             os.path.join(train_root, "flows"))
    if use_native_loader:
        from ..data import native

        sampler = TwoStreamTrainSampler(
            VideoIndex(roots[0]), VideoIndex(roots[1]),
            loader_rgb=native.NativeClipLoader("rgb", image_size,
                                               device=device),
            loader_op=native.NativeClipLoader("op", image_size))
    else:
        sampler = get_dataset("rgb_op", "training", rgb_root=roots[0],
                              op_root=roots[1], image_size=image_size)
    n_rgb_in, n_op_in = net_cfg.in_channel
    batches = []
    for _ in range(calib_batches):
        b = sampler.batch(calib_batch_size)
        batches.append(tuple(
            torch.from_numpy(np.ascontiguousarray(b[key][..., :n]))
            .permute(0, 3, 1, 2).to(device)
            for key, n in (("rgb", n_rgb_in), ("op", n_op_in))))
    qcal = calibrate_act_scales(fwd, qvars, batches)
    return make_quantized_forward(qcal, **kwargs).to(device), qcal
