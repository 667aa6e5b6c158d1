"""The plain reference of the int8 serving forward, and its int4 control.

A frozen copy of the arithmetic of the port's ``models/quantized.py``, in
float32 (float64 for the integer products, which are exact there):
BatchNorm folded into each 3x3 convolution (the root in float64, rounded
once to float32), symmetric per-output-channel weights at ``qmax`` (127
for int8, 7 for the int4 control), activations quantized at a static
per-tensor scale calibrated as ``calibrate_act_scales`` does it (each conv
input's max|x| over the calibration clips, from a record pass at dynamic
per-tensor scales, over ``qmax``), the epilogue ``acc * (sx * sw) + b``,
ReLU.  The memory blocks and their 1x1 codec convolutions run on the
float32 modules of :mod:`.model`; the decoder ends in tanh.

What differs from the port on purpose: between layers the activations
stay float32 here, where the port rounds each epilogue's output to bf16
(or straight to the next conv's int8 scale); so a value within an
activation's rounding of a quantization step may land one step apart.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

STREAMS = ("rgb", "op")
_DOUBLE = {"inc": "inc.conv.conv.", "down1": "down1.mpconv.1.conv.",
           "down2": "down2.mpconv.1.conv.", "down3": "down3.mpconv.1.conv."}
_BN_EPS = 1e-5


def _quant_weight(w: torch.Tensor, out_axis: int, qmax: int):
    axes = tuple(i for i in range(w.ndim) if i != out_axis)
    scale = torch.clamp_min(w.abs().amax(dim=axes), 1e-12) / qmax
    shape = [1] * w.ndim
    shape[out_axis] = -1
    return torch.round(w / scale.reshape(shape)).clamp(-qmax, qmax), scale


def _fold(sd, conv: str, bn: str):
    w = sd[f"{conv}.weight"].float()  # (out, in, 3, 3)
    g, b, m, v = (sd[f"{bn}.{n}"].float() for n in
                  ("weight", "bias", "running_mean", "running_var"))
    f = g / torch.sqrt((v + _BN_EPS).double()).float()
    return w * f[:, None, None, None], b - m * f


def memories(gen: nn.Module) -> Dict[str, nn.Module]:
    """Each stream's memory block of the reference's two-stream generator,
    which the quantized forward runs in float32."""
    return {s: getattr(gen, s).vq_down3 for s in STREAMS}


class QuantizedReference(nn.Module):
    """``forward(rgb_x, op_x) -> (rgb_pred, op_pred, (rgb_diff, op_diff),
    None)`` on NCHW clips.  ``act_scale`` maps each conv site (the port's
    site names) to its static scale; without one, a site quantizes at the
    dynamic per-tensor scale and ``record`` (a dict) keeps its max|x|."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor], memories,
                 qmax: int = 127):
        super().__init__()
        self.qmax = qmax
        self.w: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
        sd = state_dict
        for s in STREAMS:
            for lvl, prefix in _DOUBLE.items():
                self._double(sd, f"{s}.{prefix}", f"streams/{s}/{lvl}")
            for lvl in ("up1", "up2", "up3"):
                w = sd[f"{s}.{lvl}.up.weight"].float()  # (in, out, 2, 2)
                wq, sw = _quant_weight(w, 1, qmax)
                self.w[f"streams/{s}/{lvl}/up"] = (
                    wq, sw, sd[f"{s}.{lvl}.up.bias"].float())
                self._double(sd, f"{s}.{lvl}.conv.conv.",
                             f"streams/{s}/{lvl}/conv")
            wq, sw = _quant_weight(sd[f"{s}.outc.weight"].float(), 0, qmax)
            self.w[f"streams/{s}/outc"] = (wq, sw,
                                           sd[f"{s}.outc.bias"].float())
        for side, name in (("O2F", "O2F"), ("F2O", "F20")):
            self._double(sd, f"bridge.{name}.conv.", f"bridge/{side}")
        self.mem = nn.ModuleDict(memories)
        self.act_scale: Dict[str, torch.Tensor] = {}
        self.record: Optional[Dict[str, torch.Tensor]] = None

    def _double(self, sd, prefix: str, site: str) -> None:
        for i, (conv, bn) in enumerate((("0", "1"), ("3", "4"))):
            w, b = _fold(sd, prefix + conv, prefix + bn)
            wq, sw = _quant_weight(w, 0, self.qmax)
            self.w[f"{site}/conv{i}"] = (wq, sw, b)

    def _quant_in(self, x: torch.Tensor, site: str):
        if self.record is not None:
            m = x.abs().amax()
            prev = self.record.get(site)
            self.record[site] = m if prev is None else torch.maximum(prev, m)
        sx = self.act_scale.get(site)
        if sx is None:
            sx = torch.clamp_min(x.abs().amax(), 1e-12) / self.qmax
        return torch.round(x / sx).clamp(-self.qmax, self.qmax), sx

    def _conv(self, x, site: str, relu: bool):
        wq, sw, b = self.w[site]
        xq, sx = self._quant_in(x, site)
        acc = F.conv2d(xq.double(), wq.double(), padding=1)
        y = acc.float() * (sx * sw)[None, :, None, None] + b[None, :, None, None]
        return torch.relu(y) if relu else y

    def _up(self, x, site: str):
        wq, sw, b = self.w[site]
        xq, sx = self._quant_in(x, site)
        acc = F.conv_transpose2d(xq.double(), wq.double(), stride=2)
        return (acc.float() * (sx * sw)[None, :, None, None]
                + b[None, :, None, None])

    def _double_conv(self, x, site):
        return self._conv(self._conv(x, f"{site}/conv0", True),
                          f"{site}/conv1", True)

    def _encode(self, x, base):
        x1 = self._double_conv(x, f"{base}/inc")
        x2 = self._double_conv(F.max_pool2d(x1, 2), f"{base}/down1")
        x3 = self._double_conv(F.max_pool2d(x2, 2), f"{base}/down2")
        x4 = self._double_conv(F.max_pool2d(x3, 2), f"{base}/down3")
        return x1, x2, x3, x4

    def _decode(self, x4, skips, base):
        x1, x2, x3 = skips
        y = x4
        for lvl, skip in (("up1", x3), ("up2", x2), ("up3", x1)):
            up = self._up(y, f"{base}/{lvl}/up")
            y = self._double_conv(torch.cat([skip, up], dim=1),
                                  f"{base}/{lvl}/conv")
        return torch.tanh(self._conv(y, f"{base}/outc", False))

    def forward(self, rgb_x, op_x):
        r = self._encode(rgb_x.float(), "streams/rgb")
        o = self._encode(op_x.float(), "streams/op")
        r4m, rgb_diff, _ = self.mem["rgb"](r[3])
        o4m, op_diff, _ = self.mem["op"](o[3])
        r4b = r4m + self._double_conv(o4m, "bridge/O2F")
        o4b = o4m + self._double_conv(r4m, "bridge/F2O")
        return (self._decode(r4b, r[:3], "streams/rgb"),
                self._decode(o4b, o[:3], "streams/op"),
                (rgb_diff, op_diff), None)

    @torch.no_grad()
    def calibrate(self, batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                  headroom: float = 1.0) -> None:
        """Static scales from a record pass over ``batches`` (the port's
        float32 numpy arithmetic: ``max(m, 1e-12) * headroom / qmax``)."""
        self.act_scale, seen = {}, {}
        for rgb_x, op_x in batches:
            self.record = {}
            self(rgb_x, op_x)
            for site, m in self.record.items():
                seen[site] = max(seen.get(site, 0.0), float(m))
        self.record = None
        for site, m in seen.items():
            s = (np.float32(max(np.float32(m), np.float32(1e-12))
                            * np.float32(headroom)) / np.float32(self.qmax))
            self.act_scale[site] = torch.tensor(float(s), device=rgb_x.device)
