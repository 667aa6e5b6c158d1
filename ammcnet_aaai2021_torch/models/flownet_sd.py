"""FlowNetSD / FlowNet2-SD: the frozen optical-flow teacher of training
(NCHW, inference only, ``batchNorm=False``).

Port of ``ammcnet_aaai2021_tpu/models/flownet_sd.py`` (reference
``Code/models/flownet2/``: FlowNetSD.py, submodules.py, models.py).  The
training step runs it under ``torch.no_grad`` on (target, prediction) and
(target, target) pairs; its output enters the flow loss as a constant.

Architecture (FlowNetSD.py:7-100): a 13-conv encoder (LeakyReLU 0.1), four
deconv stages with five ``predict_flow`` heads and four learned 2-channel
flow upsamplers; FlowNet2-SD (models.py:9-59) subtracts the per-image
channel mean, divides by 255, concatenates the pair to 6 channels and
returns ``flow2 * 20`` upsampled x4 bilinearly (``align_corners=False``,
which ``jax.image.resize(..., "bilinear")`` matches).

Module names are the reference torch ones that the JAX package's
``tools/torch_convert.convert_flownet_sd_state`` reads (``convX.0``,
``deconvX.0``, ``inter_convX.0``, ``predict_flowX``,
``upsampled_flowX_to_Y``), and :class:`FlowNet2SD` subclasses
:class:`FlowNetSD` as the reference does, so a FlowNet2-SD ``.pth`` loads
with ``load_state_dict`` as it is.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2d, ConvTranspose2d

_SLOPE = 0.1


def _conv(in_ch: int, out_ch: int, stride: int = 1) -> nn.Sequential:
    """3x3 conv + LeakyReLU(0.1) (submodules.py conv, batchNorm=False)."""
    return nn.Sequential(Conv2d(in_ch, out_ch, 3, stride=stride, padding=1),
                         nn.LeakyReLU(_SLOPE))


def _deconv(in_ch: int, out_ch: int) -> nn.Sequential:
    """4x4 stride-2 transposed conv + LeakyReLU(0.1) (submodules.py deconv)."""
    return nn.Sequential(ConvTranspose2d(in_ch, out_ch, 4, stride=2,
                                         padding=1), nn.LeakyReLU(_SLOPE))


class FlowNetSD(nn.Module):
    """Core FlowNetSD on a (b, 6, h, w) stacked frame pair; returns flow2
    (b, 2, h/4, w/4) in the input's dtype."""

    def __init__(self):
        super().__init__()
        enc = (("conv0", 6, 64, 1), ("conv1", 64, 64, 2),
               ("conv1_1", 64, 128, 1), ("conv2", 128, 128, 2),
               ("conv2_1", 128, 128, 1), ("conv3", 128, 256, 2),
               ("conv3_1", 256, 256, 1), ("conv4", 256, 512, 2),
               ("conv4_1", 512, 512, 1), ("conv5", 512, 512, 2),
               ("conv5_1", 512, 512, 1), ("conv6", 512, 1024, 2),
               ("conv6_1", 1024, 1024, 1))
        for name, i, o, s in enc:
            self.add_module(name, _conv(i, o, s))
        self.deconv5 = _deconv(1024, 512)
        self.deconv4 = _deconv(1026, 256)
        self.deconv3 = _deconv(770, 128)
        self.deconv2 = _deconv(386, 64)
        for lvl, (i, o) in zip((5, 4, 3, 2),
                               ((1026, 512), (770, 256), (386, 128),
                                (194, 64))):
            self.add_module(f"inter_conv{lvl}",
                            nn.Sequential(Conv2d(i, o, 3, padding=1)))
        for lvl, i in zip((6, 5, 4, 3, 2), (1024, 512, 256, 128, 64)):
            self.add_module(f"predict_flow{lvl}", Conv2d(i, 2, 3, padding=1))
        for lvl in (6, 5, 4, 3):
            self.add_module(f"upsampled_flow{lvl}_to_{lvl - 1}",
                            ConvTranspose2d(2, 2, 4, stride=2, padding=1))

    def flow2(self, x: torch.Tensor) -> torch.Tensor:
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))

        flow6 = self.predict_flow6(out_conv6)
        concat = torch.cat([out_conv5, self.deconv5(out_conv6),
                            self.upsampled_flow6_to_5(flow6)], 1)
        flow5 = self.predict_flow5(self.inter_conv5(concat))
        concat = torch.cat([out_conv4, self.deconv4(concat),
                            self.upsampled_flow5_to_4(flow5)], 1)
        flow4 = self.predict_flow4(self.inter_conv4(concat))
        concat = torch.cat([out_conv3, self.deconv3(concat),
                            self.upsampled_flow4_to_3(flow4)], 1)
        flow3 = self.predict_flow3(self.inter_conv3(concat))
        concat = torch.cat([out_conv2, self.deconv2(concat),
                            self.upsampled_flow3_to_2(flow3)], 1)
        return self.predict_flow2(self.inter_conv2(concat))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.flow2(x)


class FlowNet2SD(FlowNetSD):
    """FlowNet2-SD (models.py:9-59).  Input: (b, 3, 2, h, w) frame pairs in
    the [0, 255] range, the reference's layout; output: (b, 2, h, w) float32
    flow.  The network runs in ``dtype``."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 255.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.div_flow, self.rgb_max, self.dtype = div_flow, rgb_max, dtype

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        f = frames.float()
        # per-image, per-channel mean over both frames and all pixels
        rgb_mean = f.mean(dim=(2, 3, 4), keepdim=True)
        x = (f - rgb_mean) / self.rgb_max
        x = torch.cat([x[:, :, 0], x[:, :, 1]], dim=1)  # (b, 6, h, w)
        flow2 = self.flow2(x.to(self.dtype)).float() * self.div_flow
        return F.interpolate(flow2, scale_factor=4, mode="bilinear",
                             align_corners=False)
