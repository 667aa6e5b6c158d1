"""The plain float32 reference of the released AMMCNet generator, its
FlowNet2-SD flow teacher and its PatchGAN discriminator (NCHW).

A frozen copy of the arithmetic of the port's plain modules
(``models/blocks.py``, ``memory_module.py``, ``ops/memory.py``'s plain
lookup, ``unet_mem.py``, ``flownet_sd.py``, ``discriminator.py``), kept
here so that the yardstick does not move when the port does.  It imports
nothing of the port and computes in float32 throughout: no kernel, no
bf16 cast.  Module and buffer names are the port's (the reference torch
state-dict names), so one state dict loads into both.

Departures from the port, none of which changes a value the port would
compute in float32:

* the lookup ranks by ``||E||^2 - 2 z.E``, the squared distance less its
  row constant ``||z||^2``, as the port's kernels and their plain
  versions do (the port's ``use_kernel=False`` path adds it back, which
  can resolve a near-tie the other way);
* the EMA statistics come from a scattered one-hot (``one_hot`` has no
  meta-device kernel, which the FLOP census uses);
* BatchNorm's training mode writes its running statistics directly (the
  port routes them through ``write_buffers`` for its remat step).

Every convolution takes optional quantizers (:func:`set_fake`) for its
input and weight and for the gradient of its output: the lower-precision
control of ``benchmark/control.py`` uses them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _fq(fake: Optional[Callable], t: torch.Tensor) -> torch.Tensor:
    if fake is None:
        return t
    return t + (fake(t) - t).detach()


class _GradFake(torch.autograd.Function):
    """Identity forward; the gradient passing back is quantized."""

    @staticmethod
    def forward(ctx, t, fake):
        ctx.fake = fake
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fake(grad), None


def _gq(fake: Optional[Callable], t: torch.Tensor) -> torch.Tensor:
    return t if fake is None else _GradFake.apply(t, fake)


class Conv2d(nn.Conv2d):
    fake: Optional[Callable] = None
    grad_fake: Optional[Callable] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _gq(self.grad_fake, self._conv_forward(
            _fq(self.fake, x), _fq(self.fake, self.weight), self.bias))


class ConvTranspose2d(nn.ConvTranspose2d):
    fake: Optional[Callable] = None
    grad_fake: Optional[Callable] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _gq(self.grad_fake, F.conv_transpose2d(
            _fq(self.fake, x), _fq(self.fake, self.weight), self.bias,
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation))


def set_fake(model: nn.Module, fake: Optional[Callable],
             grad_fake: Optional[Callable] = None) -> nn.Module:
    """Quantize every convolution's input and weight with ``fake`` in the
    forward and the gradient of its output with ``grad_fake`` in the
    backward, so that each product of both passes takes quantized
    operands (None: exact float32)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.fake, m.grad_fake = fake, grad_fake
    return model


class BatchNorm2d(nn.BatchNorm2d):
    """Eval mode is torch's.  Training mode normalizes with the biased
    batch variance and updates the running statistics as flax does (and
    the port does): ``r = 0.9 r + 0.1 stat`` with the *biased* variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias,
                         training=True, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
            self.num_batches_tracked.add_(1)
        return y


class DoubleConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            BatchNorm2d(out_ch, eps=1e-5), nn.ReLU(),
            Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
            BatchNorm2d(out_ch, eps=1e-5), nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class InConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x):
        return self.conv(x)


class Down(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_ch, out_ch))

    def forward(self, x):
        return self.mpconv(x)


class Up(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.up = ConvTranspose2d(in_ch, in_ch // 2, 2, stride=2)
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dh, dw = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


def topk_smallest(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's k smallest values' indices, ascending, the lowest index
    first among equals (k rounds of argmin, the winner masked)."""
    remaining = dist.clone()
    picks = []
    for _ in range(k):
        i = remaining.argmin(dim=1)
        picks.append(i)
        remaining.scatter_(1, i[:, None], float("inf"))
    return torch.stack(picks, dim=1)


class TopKMemory(nn.Module):
    """The top-k memory (reference ``Quantize_topk``, top-1 straight-through
    mode): the k nearest codewords of each latent, gathered and
    channel-concatenated (no gradient: the codebook is a buffer), the
    commit distance against the nearest one, and in training mode the EMA
    codebook update (decay 0.99, Laplace smoothing 1e-5) from the codebook
    as it was before the forward."""

    def __init__(self, embed_dim: int, n_embed: int, k: int,
                 per_sample_diff: bool, decay: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.dim, self.n_embed, self.k = embed_dim, n_embed, k
        self.per_sample_diff, self.decay, self.eps = (per_sample_diff, decay,
                                                      eps)
        self.register_buffer("embed", torch.zeros(embed_dim, n_embed))
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", torch.zeros(embed_dim, n_embed))

    def forward(self, z: torch.Tensor):
        b = z.shape[0]
        zl = z.permute(0, 2, 3, 1)
        flat = zl.reshape(-1, self.dim)
        fd = flat.detach()
        dist = (-2.0 * (fd @ self.embed)
                + (self.embed * self.embed).sum(0, keepdim=True))
        idx = topk_smallest(dist, self.k)
        embed_t = self.embed.t()
        q_topk = embed_t[idx].reshape(-1, self.k * self.dim)
        q1 = embed_t[idx[:, 0]]
        sq = (q1 - flat).square()
        diff = (sq.reshape(b, -1).mean(-1) if self.per_sample_diff
                else sq.mean())
        if self.training:
            with torch.no_grad():
                one_hot = torch.zeros(fd.shape[0], self.n_embed,
                                      device=fd.device).scatter_(
                    1, idx[:, :1], 1.0)
                counts = one_hot.sum(0)
                embed_sum = fd.t() @ one_hot
                d = self.decay
                self.cluster_size.mul_(d).add_(counts, alpha=1 - d)
                self.embed_avg.mul_(d).add_(embed_sum, alpha=1 - d)
                n = self.cluster_size.sum()
                smoothed = ((self.cluster_size + self.eps)
                            / (n + self.n_embed * self.eps) * n)
                self.embed.copy_(self.embed_avg / smoothed[None, :])
        q_st = flat + (q1 - flat).detach()
        return (q_topk.reshape(*zl.shape[:-1], -1).permute(0, 3, 1, 2)
                .contiguous(),
                diff, q_st.reshape(zl.shape).permute(0, 3, 1, 2))


class EncQuanDecTopK(nn.Module):
    def __init__(self, in_features, embed_dim, n_embed, k, per_sample_diff):
        super().__init__()
        self.enc = Conv2d(in_features, embed_dim, 1)
        self.quantize = TopKMemory(embed_dim, n_embed, k, per_sample_diff)
        self.dec = Conv2d(k * embed_dim, in_features, 1)

    def forward(self, x):
        q_topk, diff, q_st = self.quantize(self.enc(x))
        return self.dec(q_topk), diff, q_st


class EncQuanDecResTopK(nn.Module):
    def __init__(self, in_features, embed_dim, n_embed, k, per_sample_diff):
        super().__init__()
        self.quan = EncQuanDecTopK(in_features, embed_dim, n_embed, k,
                                   per_sample_diff)

    def forward(self, x):
        out, diff, q_st = self.quan(x)
        return out + x, diff, q_st


class UNetMemStream(nn.Module):
    def __init__(self, in_channels, out_channels, embed_dim, n_embed, k,
                 per_sample_diff):
        super().__init__()
        self.inc = InConv(in_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.vq_down3 = EncQuanDecResTopK(512, embed_dim, n_embed, k,
                                          per_sample_diff)
        self.up1 = Up(512, 256)
        self.up2 = Up(256, 128)
        self.up3 = Up(128, 64)
        self.outc = Conv2d(64, out_channels, 3, padding=1)

    def encode(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        return x1, x2, x3, self.down3(x3)

    def decode(self, x4, skips):
        x1, x2, x3 = skips
        y = self.up3(self.up2(self.up1(x4, x3), x2), x1)
        return torch.tanh(self.outc(y))


class AMFTBridge(nn.Module):
    def __init__(self, features: int = 512):
        super().__init__()
        self.O2F = DoubleConv(features, features)
        self.F20 = DoubleConv(features, features)

    def forward(self, zx, zy):
        return zx + self.O2F(zy), zy + self.F20(zx)


class TwoStreamUNetMem(nn.Module):
    """``forward(rgb_x, op_x) -> (rgb_pred, op_pred, (rgb_diff, op_diff),
    (rgb_code, op_code))``, the JAX forward's order (rgb encode, rgb
    memory, op encode, op memory, bridge, decoders)."""

    def __init__(self, rgb_in=12, op_in=6, rgb_out=3, op_out=2,
                 embed_dim=64, n_embed=256, k=2, per_sample_diff=False):
        super().__init__()
        self.rgb = UNetMemStream(rgb_in, rgb_out, embed_dim, n_embed, k,
                                 per_sample_diff)
        self.op = UNetMemStream(op_in, op_out, embed_dim, n_embed, k,
                                per_sample_diff)
        self.bridge = AMFTBridge(512)

    def forward(self, rgb_x, op_x):
        r1, r2, r3, r4 = self.rgb.encode(rgb_x.float())
        r4, rgb_diff, rgb_code = self.rgb.vq_down3(r4)
        o1, o2, o3, o4 = self.op.encode(op_x.float())
        o4, op_diff, op_code = self.op.vq_down3(o4)
        r4, o4 = self.bridge(r4, o4)
        return (self.rgb.decode(r4, (r1, r2, r3)),
                self.op.decode(o4, (o1, o2, o3)), (rgb_diff, op_diff),
                (rgb_code, op_code))


def _conv_lrelu(i, o, s=1):
    return nn.Sequential(Conv2d(i, o, 3, stride=s, padding=1),
                         nn.LeakyReLU(0.1))


def _deconv(i, o):
    return nn.Sequential(ConvTranspose2d(i, o, 4, stride=2, padding=1),
                         nn.LeakyReLU(0.1))


class FlowNet2SD(nn.Module):
    """FlowNet2-SD: ``forward((b, 3, 2, h, w) pairs in [0, 255]) -> (b, 2,
    h, w)`` float32 flow (``flow2 * 20`` upsampled x4, bilinear,
    ``align_corners=False``)."""

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 255.0):
        super().__init__()
        self.div_flow, self.rgb_max = div_flow, rgb_max
        enc = (("conv0", 6, 64, 1), ("conv1", 64, 64, 2),
               ("conv1_1", 64, 128, 1), ("conv2", 128, 128, 2),
               ("conv2_1", 128, 128, 1), ("conv3", 128, 256, 2),
               ("conv3_1", 256, 256, 1), ("conv4", 256, 512, 2),
               ("conv4_1", 512, 512, 1), ("conv5", 512, 512, 2),
               ("conv5_1", 512, 512, 1), ("conv6", 512, 1024, 2),
               ("conv6_1", 1024, 1024, 1))
        for name, i, o, s in enc:
            self.add_module(name, _conv_lrelu(i, o, s))
        self.deconv5 = _deconv(1024, 512)
        self.deconv4 = _deconv(1026, 256)
        self.deconv3 = _deconv(770, 128)
        self.deconv2 = _deconv(386, 64)
        for lvl, (i, o) in zip((5, 4, 3, 2), ((1026, 512), (770, 256),
                                              (386, 128), (194, 64))):
            self.add_module(f"inter_conv{lvl}",
                            nn.Sequential(Conv2d(i, o, 3, padding=1)))
        for lvl, i in zip((6, 5, 4, 3, 2), (1024, 512, 256, 128, 64)):
            self.add_module(f"predict_flow{lvl}", Conv2d(i, 2, 3, padding=1))
        for lvl in (6, 5, 4, 3):
            self.add_module(f"upsampled_flow{lvl}_to_{lvl - 1}",
                            ConvTranspose2d(2, 2, 4, stride=2, padding=1))

    def flow2(self, x):
        c1 = self.conv1_1(self.conv1(self.conv0(x)))
        c2 = self.conv2_1(self.conv2(c1))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        c6 = self.conv6_1(self.conv6(c5))
        flow6 = self.predict_flow6(c6)
        cat = torch.cat([c5, self.deconv5(c6),
                         self.upsampled_flow6_to_5(flow6)], 1)
        flow5 = self.predict_flow5(self.inter_conv5(cat))
        cat = torch.cat([c4, self.deconv4(cat),
                         self.upsampled_flow5_to_4(flow5)], 1)
        flow4 = self.predict_flow4(self.inter_conv4(cat))
        cat = torch.cat([c3, self.deconv3(cat),
                         self.upsampled_flow4_to_3(flow4)], 1)
        flow3 = self.predict_flow3(self.inter_conv3(cat))
        cat = torch.cat([c2, self.deconv2(cat),
                         self.upsampled_flow3_to_2(flow3)], 1)
        return self.predict_flow2(self.inter_conv2(cat))

    def forward(self, frames):
        f = frames.float()
        x = (f - f.mean(dim=(2, 3, 4), keepdim=True)) / self.rgb_max
        x = torch.cat([x[:, :, 0], x[:, :, 1]], dim=1)
        return F.interpolate(self.flow2(x) * self.div_flow, scale_factor=4,
                             mode="bilinear", align_corners=False)


class PixelDiscriminator(nn.Module):
    def __init__(self, num_filters: Sequence[int] = (128, 256, 512, 512),
                 in_channels: int = 3):
        super().__init__()
        self.n_strided = len(num_filters) - 1
        ch = in_channels
        for i, width in enumerate(num_filters[:-1]):
            self.add_module(f"conv{i}", Conv2d(ch, width, 4, stride=2,
                                               padding=2))
            ch = width
        self.out = Conv2d(ch, 1, 4, stride=1, padding=2)

    def forward(self, x):
        x = x.float()
        for i in range(self.n_strided):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.1)
        return self.out(x)
