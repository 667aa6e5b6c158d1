"""The plain float32 reference of FlowNet 2.0 (Ilg et al., CVPR '17,
arXiv:1612.01925), written from flownet2-pytorch's ``models.py:FlowNet2``
and ``networks/FlowNetC.py``, ``FlowNetS.py``, ``FlowNetFusion.py``, and
``correlation_package``, ``resample2d_package`` and ``channelnorm_package``
(NCHW, ``batchNorm=False``).  FlowNetSD is ``model.py``'s FlowNet2-SD's
``flow2``.

It imports nothing of the port and computes in float32 throughout: no
kernel, no bf16 cast.  Module names are flownet2-pytorch's, which are the
port's, so one state dict loads into both.  Every convolution is
``model.py``'s, so ``model.set_fake`` puts a lower precision in them (the
``fp8_flow`` control); the correlation, the warps and the norms stay
float32.

Departures from the source, each shared with the port:

* the bilinear x4 upsamples after FlowNetC and FlowNetS1 use
  ``align_corners=False`` (``nn.Upsample``'s default since PyTorch 0.4; the
  source was written when ``mode='bilinear'`` aligned the corners);
* FlowNetC's towers run as one batch of both frames (the same products).

The correlation is a loop over its 441 displacements (dy the outer index,
each a product of ``f1`` and the zero-padded, shifted ``f2`` summed over
the channels, over ``C``); Resample2d is the CUDA kernel's arithmetic
(``floor``, the fractions of the unclamped coordinate, the four corner
indices clamped into the frame, the four weighted terms summed in order);
ChannelNorm is the square root of the sum of squares over the channels.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .model import Conv2d, ConvTranspose2d, FlowNet2SD, _deconv

MAX_DISPLACEMENT, STRIDE2 = 20, 2


def _conv(i: int, o: int, s: int = 1, k: int = 3) -> nn.Sequential:
    return nn.Sequential(Conv2d(i, o, k, stride=s, padding=(k - 1) // 2),
                         nn.LeakyReLU(0.1))


def correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """(b, C, h, w) x 2 -> (b, 441, h, w): channel ``i * 21 + j`` is the
    displacement ``(dy, dx) = (2 i - 20, 2 j - 20)``."""
    _, c, h, w = f1.shape
    m = MAX_DISPLACEMENT
    pad = F.pad(f2, (m, m, m, m))
    outs = [(f1 * pad[:, :, dy:dy + h, dx:dx + w]).sum(1)
            for dy in range(0, 2 * m + 1, STRIDE2)
            for dx in range(0, 2 * m + 1, STRIDE2)]
    return torch.stack(outs, dim=1) / c


def resample2d(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Resample2d (kernel size 1): ``img`` at ``(x + u, y + v)``,
    bilinear, the corner indices clamped into the frame."""
    b, c, h, w = img.shape
    xf = torch.arange(w, dtype=flow.dtype, device=flow.device) + flow[:, 0]
    yf = (torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
          + flow[:, 1])
    x0, y0 = torch.floor(xf), torch.floor(yf)
    alpha, beta = xf - x0, yf - y0
    xl = x0.long().clamp(0, w - 1)
    xr = (x0.long() + 1).clamp(0, w - 1)
    yt = y0.long().clamp(0, h - 1)
    yb = (y0.long() + 1).clamp(0, h - 1)
    flat = img.reshape(b, c, h * w)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(b, 1, h * w).expand(b, c, h * w)
        return flat.gather(2, idx).reshape(b, c, h, w)

    out = ((1 - alpha) * (1 - beta))[:, None] * at(yt, xl)
    out = out + (alpha * (1 - beta))[:, None] * at(yt, xr)
    out = out + ((1 - alpha) * beta)[:, None] * at(yb, xl)
    return out + (alpha * beta)[:, None] * at(yb, xr)


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(1, keepdim=True))


class _Decoder(nn.Module):
    def _add_decoder(self, upsample_bias: bool) -> None:
        self.deconv5 = _deconv(1024, 512)
        self.deconv4 = _deconv(1026, 256)
        self.deconv3 = _deconv(770, 128)
        self.deconv2 = _deconv(386, 64)
        for lvl, i in zip((6, 5, 4, 3, 2), (1024, 1026, 770, 386, 194)):
            self.add_module(f"predict_flow{lvl}", Conv2d(i, 2, 3, padding=1))
        for lvl in (6, 5, 4, 3):
            self.add_module(f"upsampled_flow{lvl}_to_{lvl - 1}",
                            ConvTranspose2d(2, 2, 4, stride=2, padding=1,
                                            bias=upsample_bias))

    def decode(self, c2, c3, c4, c5, c6):
        flow6 = self.predict_flow6(c6)
        cat5 = torch.cat([c5, self.deconv5(c6),
                          self.upsampled_flow6_to_5(flow6)], 1)
        flow5 = self.predict_flow5(cat5)
        cat4 = torch.cat([c4, self.deconv4(cat5),
                          self.upsampled_flow5_to_4(flow5)], 1)
        flow4 = self.predict_flow4(cat4)
        cat3 = torch.cat([c3, self.deconv3(cat4),
                          self.upsampled_flow4_to_3(flow4)], 1)
        flow3 = self.predict_flow3(cat3)
        cat2 = torch.cat([c2, self.deconv2(cat3),
                          self.upsampled_flow3_to_2(flow3)], 1)
        return self.predict_flow2(cat2)


class FlowNetC(_Decoder):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 2, 7)
        self.conv2 = _conv(64, 128, 2, 5)
        self.conv3 = _conv(128, 256, 2, 5)
        self.conv_redir = _conv(256, 32, 1, 1)
        self.conv3_1 = _conv(473, 256)
        self.conv4 = _conv(256, 512, 2)
        self.conv4_1 = _conv(512, 512)
        self.conv5 = _conv(512, 512, 2)
        self.conv5_1 = _conv(512, 512)
        self.conv6 = _conv(512, 1024, 2)
        self.conv6_1 = _conv(1024, 1024)
        self._add_decoder(True)

    def forward(self, x):
        b = x.shape[0]
        c2 = self.conv2(self.conv1(torch.cat([x[:, :3], x[:, 3:]], 0)))
        c3 = self.conv3(c2)
        corr = F.leaky_relu(correlation(c3[:b], c3[b:]), 0.1)
        c3_1 = self.conv3_1(torch.cat([self.conv_redir(c3[:b]), corr], 1))
        c4 = self.conv4_1(self.conv4(c3_1))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self.decode(c2[:b], c3_1, c4, c5, c6)


class FlowNetS(_Decoder):
    def __init__(self, input_channels: int = 12):
        super().__init__()
        self.conv1 = _conv(input_channels, 64, 2, 7)
        self.conv2 = _conv(64, 128, 2, 5)
        self.conv3 = _conv(128, 256, 2, 5)
        self.conv3_1 = _conv(256, 256)
        self.conv4 = _conv(256, 512, 2)
        self.conv4_1 = _conv(512, 512)
        self.conv5 = _conv(512, 512, 2)
        self.conv5_1 = _conv(512, 512)
        self.conv6 = _conv(512, 1024, 2)
        self.conv6_1 = _conv(1024, 1024)
        self._add_decoder(False)

    def forward(self, x):
        c2 = self.conv2(self.conv1(x))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        return self.decode(c2, c3, c4, c5, c6)


class FlowNetFusion(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = _conv(11, 64)
        self.conv1 = _conv(64, 64, 2)
        self.conv1_1 = _conv(64, 128)
        self.conv2 = _conv(128, 128, 2)
        self.conv2_1 = _conv(128, 128)
        self.deconv1 = _deconv(128, 32)
        self.deconv0 = _deconv(162, 16)
        self.inter_conv1 = nn.Sequential(Conv2d(162, 32, 3, padding=1))
        self.inter_conv0 = nn.Sequential(Conv2d(82, 16, 3, padding=1))
        self.predict_flow2 = Conv2d(128, 2, 3, padding=1)
        self.predict_flow1 = Conv2d(32, 2, 3, padding=1)
        self.predict_flow0 = Conv2d(16, 2, 3, padding=1)
        self.upsampled_flow2_to_1 = ConvTranspose2d(2, 2, 4, stride=2,
                                                    padding=1)
        self.upsampled_flow1_to_0 = ConvTranspose2d(2, 2, 4, stride=2,
                                                    padding=1)

    def forward(self, x):
        c0 = self.conv0(x)
        c1 = self.conv1_1(self.conv1(c0))
        c2 = self.conv2_1(self.conv2(c1))
        flow2 = self.predict_flow2(c2)
        cat1 = torch.cat([c1, self.deconv1(c2),
                          self.upsampled_flow2_to_1(flow2)], 1)
        flow1 = self.predict_flow1(self.inter_conv1(cat1))
        cat0 = torch.cat([c0, self.deconv0(cat1),
                          self.upsampled_flow1_to_0(flow1)], 1)
        return self.predict_flow0(self.inter_conv0(cat0))


class FlowNet2(nn.Module):
    """FlowNet 2.0: ``forward((b, 3, 2, h, w) pairs in [0, 255]) -> (b, 2,
    h, w)`` float32 flow."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 255.0):
        super().__init__()
        self.div_flow, self.rgb_max = div_flow, rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()
        self.flownets_d = FlowNet2SD()
        self.flownetfusion = FlowNetFusion()

    def forward(self, frames):
        f = frames.float()
        x = (f - f.mean(dim=(2, 3, 4), keepdim=True)) / self.rgb_max
        x = torch.cat([x[:, :, 0], x[:, :, 1]], dim=1)
        img0, img1 = x[:, :3], x[:, 3:]

        def bilinear(flow2):
            return F.interpolate(flow2 * self.div_flow, scale_factor=4,
                                 mode="bilinear", align_corners=False)

        def nearest(flow):
            return F.interpolate(flow, scale_factor=4, mode="nearest")

        flow = bilinear(self.flownetc(x))
        warped = resample2d(img1, flow)
        concat1 = torch.cat([x, warped, flow / self.div_flow,
                             channel_norm(img0 - warped)], 1)
        flow = bilinear(self.flownets_1(concat1))
        warped = resample2d(img1, flow)
        concat2 = torch.cat([x, warped, flow / self.div_flow,
                             channel_norm(img0 - warped)], 1)
        s2 = nearest(self.flownets_2(concat2) * self.div_flow)
        sd = nearest(self.flownets_d.flow2(x) / self.div_flow)
        concat3 = torch.cat([
            img0, sd, s2, channel_norm(sd), channel_norm(s2),
            channel_norm(img0 - resample2d(img1, sd)),
            channel_norm(img0 - resample2d(img1, s2))], 1)
        return self.flownetfusion(concat3)
