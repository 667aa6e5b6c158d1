"""UNet building blocks (NCHW).

Port of ``ammcnet_aaai2021_tpu/models/blocks.py`` (reference
``Code/models/unet.py:8-59``: double_conv / inconv / down / up).  Parameters
stay float32; the convolutions run in the dtype of their input, as the JAX
modules run in their ``dtype`` with float32 params.  BatchNorm (eps 1e-5)
keeps its statistics in float32.

BatchNorm in training mode follows flax, not ``torch.nn.BatchNorm2d``
(:class:`BatchNorm2d`): both normalize with the biased batch variance, but
torch updates ``running_var`` with the unbiased one (n/(n-1) larger) where
flax, and so the JAX package, uses the biased one.  The port is held to
the JAX package, so its running variance follows flax; a state dict it
trains differs from one the reference torch trainer would write by that
factor in ``running_var``'s updates.

Module and parameter names follow the reference torch modules, so a
reference state dict loads with ``load_state_dict`` as it is:
``inc.conv.conv.0.weight``, ``down1.mpconv.1.conv.3.weight``,
``up1.up.weight`` (see ``tools/weights.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """Conv2d whose float32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d whose float32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1, the same names and buffers) whose
    training mode is flax's ``BatchNorm(momentum=0.9)``: the output is
    torch's (normalized with the biased batch variance, statistics in
    float32, cast back to the input's dtype), and the running statistics
    are updated with the *biased* batch variance, ``r = 0.9 r + 0.1 stat``.
    Eval mode is torch's own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, training=True,
                         eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
            keep = 1.0 - self.momentum  # flax's momentum, 0.9
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
            self.num_batches_tracked.add_(1)
        return y


class DoubleConv(nn.Module):
    """(conv 3x3 -> BN -> relu) x 2 (reference double_conv, unet.py:8-20).
    The 3x3 convs carry no bias: BatchNorm follows."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_ch, out_ch, 3, padding=1, bias=False),
            BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
            Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
            BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class InConv(nn.Module):
    """The first DoubleConv under the reference's ``inconv`` name (unet.py:23-30)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Down(nn.Module):
    """maxpool 2x2 then DoubleConv (reference down, unet.py:33-41)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_ch, out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mpconv(x)


class Up(nn.Module):
    """ConvTranspose 2x2 stride 2 to ``in_ch // 2`` channels, center-pad to
    the skip's size, concat ``[skip, up]``, DoubleConv (reference up,
    unet.py:44-59).  ``in_ch`` is the incoming channel count, which equals
    the concat's, since the skip carries ``in_ch // 2``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.up = ConvTranspose2d(in_ch, in_ch // 2, 2, stride=2)
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = self.up(x1)
        dh = x2.shape[2] - x1.shape[2]
        dw = x2.shape[3] - x1.shape[3]
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=1))
