"""FlowNet 2.0 (Ilg et al., "FlowNet 2.0: Evolution of Optical Flow
Estimation with Deep Networks", arXiv:1612.01925, CVPR '17): the whole
network, whose offline ``.flo`` files the released AMMCNet motion stream
was trained on, as an on-the-fly flow extractor beside FlowNet2-SD (NCHW,
inference only, ``batchNorm=False``).

It follows flownet2-pytorch (github.com/NVIDIA/flownet2-pytorch) layer for
layer: ``models.py:FlowNet2`` and ``networks/FlowNetC.py``,
``FlowNetS.py``, ``FlowNetSD.py``, ``FlowNetFusion.py``.  Five networks
and the glue between them:

* ``flownetc`` (:class:`FlowNetC`): shared towers ``conv1`` 7x7/2,
  ``conv2`` 5x5/2, ``conv3`` 5x5/2 on each frame, the correlation of the
  two 256-channel maps at 441 displacements (``ops/library.py``'s
  ``ammcnet::correlation``, LeakyReLU 0.1 fused) beside ``conv_redir``
  (1x1, 256 -> 32), then ``conv3_1`` (473 -> 256) to ``conv6_1`` and the
  FlowNet decoder;
* ``flownets_1``, ``flownets_2`` (:class:`FlowNetS`, 12 channels in): the
  pair, the second frame warped by the last flow, that flow over
  ``div_flow`` and the brightness error's channel norm;
* ``flownets_d``: ``flownet_sd.FlowNetSD`` as it is;
* ``flownetfusion`` (:class:`FlowNetFusion`): at full resolution on 11
  channels, the first frame, the SD and S2 flows, their norms and their
  brightness errors;
* between them, x4 upsamples, the warp (Resample2d) and channel norms.
  Each branch keeps the source's scaling: C, S1 and S2 are ``flow2 *
  div_flow``, the SD branch ``flow2 / div_flow``; the fusion's output is
  the flow.

Module names are flownet2-pytorch's (``flownetc.*``, ``flownets_1.*``,
``flownets_2.*``, ``flownets_d.*``, ``flownetfusion.*``), so its
``FlowNet2_checkpoint.pth.tar`` ``state_dict`` loads with
``load_state_dict`` as it is (not tried: no such file is in the
repository).

Where this departs from the source's float32:

* the five networks run in ``dtype`` (bf16 by default): their inputs are
  cast to it and their flows cast back, and the correlation takes and
  gives it (a float32 sum over the channels); the parameters are held in
  it, so a checkpoint's float32 values are rounded once when they are
  loaded (FlowNet2-SD here keeps float32 parameters and casts them at every
  convolution: the same values, and a launch more a convolution);
* the warps, channel norms, upsamples and the concatenations' other
  parts are computed in float32, as FlowNet2-SD's head is;
* the bilinear x4 upsamples (after C and S1) use ``align_corners=False``,
  ``nn.Upsample``'s default since PyTorch 0.4 and FlowNet2-SD's here (the
  source was written when ``mode='bilinear'`` aligned the corners); the
  SD and S2 flows are upsampled ``nearest``, as the source's
  ``upsample3``/``upsample4`` are;
* Resample2d (kernel size 1) is ``F.grid_sample(mode="bilinear",
  padding_mode="border", align_corners=True)`` at pixel coordinates ``(x
  + u, y + v)``: the source clamps the four corner indices into the frame
  and keeps the unclamped fractions, which weighs the same clamped pixels
  as sampling at the clamped coordinate (tests/test_torch_flownet2.py
  holds it against the source's arithmetic with flows pointing out of the
  frame);
* FlowNetC's two towers run as one batch of ``2b`` images.

Spans (``utils/profiling.py``): ``flownet2.c``, ``.s1``, ``.s2``, ``.sd``
and ``.fusion`` around each network's forward, ``flownet2.warp`` around
each of the four warp blocks (resample, difference, channel norm, and the
upsample and concatenation that feed the next network) and
``flownet2.correlation`` around the op; counter ``flownet2.pairs``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.library import correlation
from ..utils.profiling import count, span
from .blocks import Conv2d, ConvTranspose2d
from .flownet_sd import FlowNetSD, _conv, _deconv

SIDE_MULTIPLE = 64  # input sides: six stride-2 levels and the x4 head


class _FlowNetDecoder(nn.Module):
    """The FlowNet decoder FlowNetC and FlowNetS share (``deconv5..2``,
    ``predict_flow6..2`` on the concatenations, ``upsampled_flowN_to_M``;
    no ``inter_conv``)."""

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

    def decode(self, out2, out3, out4, out5, out6) -> torch.Tensor:
        concat = out6
        for lvl, skip in ((6, out5), (5, out4), (4, out3), (3, out2)):
            flow = getattr(self, f"predict_flow{lvl}")(concat)
            concat = torch.cat(
                [skip, getattr(self, f"deconv{lvl - 1}")(concat),
                 getattr(self, f"upsampled_flow{lvl}_to_{lvl - 1}")(flow)], 1)
        return self.predict_flow2(concat)


class FlowNetC(_FlowNetDecoder):
    """FlowNetC on a (b, 6, h, w) stacked pair; returns flow2 (b, 2, h/4,
    w/4) in the input's dtype."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 2, kernel_size=7)
        self.conv2 = _conv(64, 128, 2, kernel_size=5)
        self.conv3 = _conv(128, 256, 2, kernel_size=5)
        self.conv_redir = _conv(256, 32, kernel_size=1)
        self.conv3_1 = _conv(473, 256)
        for name, i, o, s in (("conv4", 256, 512, 2), ("conv4_1", 512, 512, 1),
                              ("conv5", 512, 512, 2), ("conv5_1", 512, 512, 1),
                              ("conv6", 512, 1024, 2),
                              ("conv6_1", 1024, 1024, 1)):
            self.add_module(name, _conv(i, o, s))
        self._add_decoder(upsample_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        # the shared towers, both frames as one batch
        towers = self.conv2(self.conv1(torch.cat([x[:, :3], x[:, 3:]], 0)))
        out_conv2a = towers[:b]
        out_conv3 = self.conv3(towers)
        out_conv3a, out_conv3b = out_conv3[:b], out_conv3[b:]
        with span("flownet2.correlation"):
            out_corr = correlation(out_conv3a, out_conv3b, True)
        out_conv3_1 = self.conv3_1(torch.cat(
            [self.conv_redir(out_conv3a), out_corr], 1))
        out_conv4 = self.conv4_1(self.conv4(out_conv3_1))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        return self.decode(out_conv2a, out_conv3_1, out_conv4, out_conv5,
                           out_conv6)


class FlowNetS(_FlowNetDecoder):
    """FlowNetS on a (b, ``input_channels``, h, w) stack; returns flow2 (b,
    2, h/4, w/4) in the input's dtype."""

    def __init__(self, input_channels: int = 12):
        super().__init__()
        self.conv1 = _conv(input_channels, 64, 2, kernel_size=7)
        self.conv2 = _conv(64, 128, 2, kernel_size=5)
        self.conv3 = _conv(128, 256, 2, kernel_size=5)
        for name, i, o, s in (("conv3_1", 256, 256, 1), ("conv4", 256, 512, 2),
                              ("conv4_1", 512, 512, 1), ("conv5", 512, 512, 2),
                              ("conv5_1", 512, 512, 1),
                              ("conv6", 512, 1024, 2),
                              ("conv6_1", 1024, 1024, 1)):
            self.add_module(name, _conv(i, o, s))
        self._add_decoder(upsample_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_conv2 = self.conv2(self.conv1(x))
        out_conv3 = self.conv3_1(self.conv3(out_conv2))
        out_conv4 = self.conv4_1(self.conv4(out_conv3))
        out_conv5 = self.conv5_1(self.conv5(out_conv4))
        out_conv6 = self.conv6_1(self.conv6(out_conv5))
        return self.decode(out_conv2, out_conv3, out_conv4, out_conv5,
                           out_conv6)


class FlowNetFusion(nn.Module):
    """FlowNetFusion on the (b, 11, h, w) stack at full resolution; returns
    flow0 (b, 2, h, w) in the input's dtype."""

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
        for lvl, i in zip((2, 1, 0), (128, 32, 16)):
            self.add_module(f"predict_flow{lvl}", Conv2d(i, 2, 3, padding=1))
        self.upsampled_flow2_to_1 = ConvTranspose2d(2, 2, 4, stride=2,
                                                    padding=1)
        self.upsampled_flow1_to_0 = ConvTranspose2d(2, 2, 4, stride=2,
                                                    padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_conv0 = self.conv0(x)
        out_conv1 = self.conv1_1(self.conv1(out_conv0))
        out_conv2 = self.conv2_1(self.conv2(out_conv1))
        flow2 = self.predict_flow2(out_conv2)
        concat1 = torch.cat([out_conv1, self.deconv1(out_conv2),
                             self.upsampled_flow2_to_1(flow2)], 1)
        flow1 = self.predict_flow1(self.inter_conv1(concat1))
        concat0 = torch.cat([out_conv0, self.deconv0(concat1),
                             self.upsampled_flow1_to_0(flow1)], 1)
        return self.predict_flow0(self.inter_conv0(concat0))


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Resample2d (kernel size 1): ``img`` (b, c, h, w) sampled bilinearly
    at ``(x + flow[:, 0], y + flow[:, 1])``, coordinates clamped into the
    frame (the module's note)."""
    _, _, h, w = img.shape
    xs = torch.arange(w, device=img.device, dtype=torch.float32)
    ys = torch.arange(h, device=img.device, dtype=torch.float32)
    gx = (xs + flow[:, 0]) * (2.0 / (w - 1)) - 1.0
    gy = (ys[:, None] + flow[:, 1]) * (2.0 / (h - 1)) - 1.0
    return F.grid_sample(img, torch.stack([gx, gy], dim=-1), mode="bilinear",
                         padding_mode="border", align_corners=True)


def channel_norm(x: torch.Tensor) -> torch.Tensor:
    """ChannelNorm: the L2 norm over channels, (b, 1, h, w)."""
    return torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _up4(flow: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "nearest":
        return F.interpolate(flow, scale_factor=4, mode="nearest")
    return F.interpolate(flow, scale_factor=4, mode="bilinear",
                         align_corners=False)


class FlowNet2(nn.Module):
    """FlowNet 2.0 (``models.py:FlowNet2``).  Input: (b, 3, 2, h, w) frame
    pairs in the [0, 255] range, h and w multiples of 64; output: (b, 2, h,
    w) float32 flow.  The networks run in ``dtype``, which their parameters
    are held in."""

    # frame pairs a forward of the on-the-fly extractor (eval/infer.py):
    # at 16 the host's enqueue of a forward's launches paced the card, and
    # a video's latency spread 3 % between runs
    pairs_per_forward = 32

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 255.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.div_flow, self.rgb_max, self.dtype = div_flow, rgb_max, dtype
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()
        self.to(dtype)

    def _next_input(self, x: torch.Tensor, flow2: torch.Tensor
                    ) -> torch.Tensor:
        """A FlowNetS's input from the last network's flow2: the pair, the
        second frame warped by the upsampled flow, that flow over
        ``div_flow`` and the brightness error's norm."""
        flow = _up4(flow2.float() * self.div_flow, "bilinear")
        warped = warp(x[:, 3:], flow)
        return torch.cat([x, warped, flow / self.div_flow,
                          channel_norm(x[:, :3] - warped)], 1).to(self.dtype)

    @staticmethod
    def _branch(x: torch.Tensor, flow: torch.Tensor):
        """A fusion branch from an SD or S2 flow at full resolution: the
        flow, its norm and the norm of the brightness error it leaves."""
        return flow, channel_norm(flow), channel_norm(
            x[:, :3] - warp(x[:, 3:], flow))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        b, _, _, h, w = frames.shape
        if h % SIDE_MULTIPLE or w % SIDE_MULTIPLE:
            raise ValueError(f"FlowNet2 takes sides that are multiples of "
                             f"{SIDE_MULTIPLE}, got {h}x{w}")
        count("flownet2.pairs", b)
        f = frames.float()
        # per-image, per-channel mean over both frames and all pixels
        x = (f - f.mean(dim=(2, 3, 4), keepdim=True)) / self.rgb_max
        x = torch.cat([x[:, :, 0], x[:, :, 1]], dim=1)  # (b, 6, h, w)
        xd = x.to(self.dtype)
        with span("flownet2.c"):
            flow_c = self.flownetc(xd)
        with span("flownet2.warp"):
            concat1 = self._next_input(x, flow_c)
        with span("flownet2.s1"):
            flow_s1 = self.flownets_1(concat1)
        with span("flownet2.warp"):
            concat2 = self._next_input(x, flow_s1)
        with span("flownet2.s2"):
            flow_s2 = self.flownets_2(concat2)
        with span("flownet2.warp"):
            s2 = self._branch(x, _up4(flow_s2.float() * self.div_flow,
                                      "nearest"))
        with span("flownet2.sd"):
            flow_sd = self.flownets_d(xd)
        with span("flownet2.warp"):
            sd = self._branch(x, _up4(flow_sd.float() / self.div_flow,
                                      "nearest"))
            concat3 = torch.cat([x[:, :3], sd[0], s2[0], sd[1], s2[1], sd[2],
                                 s2[2]], 1).to(self.dtype)
        with span("flownet2.fusion"):
            return self.flownetfusion(concat3).float()
