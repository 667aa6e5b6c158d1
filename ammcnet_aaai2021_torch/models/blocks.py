"""UNet building blocks, in the memory layout of their input.

Port of ``ammcnet_aaai2021_tpu/models/blocks.py`` (reference
``Code/models/unet.py:8-84``: double_conv / inconv / down / up / UNet).
Parameters stay float32; the convolutions run in the dtype of their input,
as the JAX modules run in their ``dtype`` with float32 params.  BatchNorm (eps 1e-5)
keeps its statistics in float32.

Shapes are NCHW; the layout in memory follows the input.  A channels-last
(NHWC-strided, :func:`is_channels_last`) input gets its convolution weight
cast to channels-last in the same copy as to the input's dtype, so cuDNN
runs its NHWC kernels with no transpose around them, and the pooling,
padding, concatenation, BatchNorm and ReLU after it keep the layout.  The
memory-augmented generators (``unet_mem.py``) enter channels-last on a CUDA
device (:func:`to_compute`, which also pads the input's channels to a
multiple of 8 with zeros); every other network here is fed NCHW and runs
NCHW.  Each convolution's call counts ``conv.layout.nhwc`` or
``conv.layout.nchw`` while a profiler runs (``utils/profiling.py``).

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

The training forward writes state: BatchNorm's running statistics here and
the memory's EMA codebook (``memory_module.TopKMemory``).  Both go through
:func:`write_buffers`, which a remat step (``train/steps.py``) steers:
inside :func:`deferred_buffer_updates` the first forward's new values are
recorded instead of written, the forward that the backward pass reruns
(inside :func:`recomputing`) drops its own, and the recorded values are
written once, after the backward.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.multihost import all_reduce_sum
from ..utils import profiling


class _BufferUpdates:
    """Where training forwards put their buffer updates: ``recorded`` a list
    while a remat step defers them, ``recomputing`` while the backward pass
    reruns the forward."""

    recorded: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
    recomputing: bool = False


_UPDATES = _BufferUpdates()


def is_recomputing() -> bool:
    """Whether the forward running now is a remat step's rerun."""
    return _UPDATES.recomputing


@torch.no_grad()
def write_buffers(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """``buf.copy_(value)`` for each pair, or record the pairs (deferred), or
    drop them (a rerun forward)."""
    if _UPDATES.recomputing:
        return
    if _UPDATES.recorded is not None:
        _UPDATES.recorded.extend(pairs)
        return
    for buf, value in pairs:
        buf.copy_(value)


@contextlib.contextmanager
def deferred_buffer_updates() -> Iterator[List]:
    """Record the buffer updates of the training forwards inside; yields the
    list of ``(buffer, new value)``, which :func:`write_buffers` then
    writes."""
    if _UPDATES.recorded is not None:
        raise RuntimeError("deferred_buffer_updates does not nest")
    _UPDATES.recorded = recorded = []
    try:
        yield recorded
    finally:
        _UPDATES.recorded = None


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """The forward inside is a rerun (``torch.utils.checkpoint``'s
    recompute): its buffer updates are dropped, and the memory's lookup
    reads the codebook as the first forward did."""
    saved = _UPDATES.recomputing
    _UPDATES.recomputing = True
    try:
        yield
    finally:
        _UPDATES.recomputing = saved


def is_channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` is NHWC-strided (``torch.channels_last``) and not
    NCHW-contiguous too, as a tensor of one channel or one pixel is."""
    return (x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous())


# cuDNN's NHWC bf16 tensor-core convolutions read channels in multiples of 8
# (16 bytes); a Ped2 stream input's 12 or 6 channels take a slow fallback
CHANNEL_ALIGN = 8


def to_compute(x: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` in ``dtype`` (its own when None), in one copy (none where
    nothing changes).  On a CUDA device, or for a channels-last ``x``, the
    copy is channels-last with zero channels added up to a multiple of
    :data:`CHANNEL_ALIGN`, which :class:`Conv2d` meets with zero weights
    (exact).  An NCHW ``x`` on the CPU keeps its layout: oneDNN's NHWC
    kernels sum in another order than the NCHW ones that the float32 parity
    with the JAX package is held to."""
    dtype = x.dtype if dtype is None else dtype
    if not (x.is_cuda or is_channels_last(x)):
        return x.to(dtype)
    n, c, h, w = x.shape
    pad = -c % CHANNEL_ALIGN
    if not pad:
        return x.to(dtype, memory_format=torch.channels_last)
    out = torch.empty((n, c + pad, h, w), dtype=dtype, device=x.device,
                      memory_format=torch.channels_last)
    out[:, c:].zero_()
    out[:, :c].copy_(x)
    return out


def _conv_weight(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``weight`` cast to ``x``'s dtype, and to channels-last where ``x`` is
    (cuDNN then transposes neither); the call is counted by ``x``'s
    layout."""
    if is_channels_last(x):
        profiling.count("conv.layout.nhwc")
        return weight.to(x.dtype, memory_format=torch.channels_last)
    profiling.count("conv.layout.nchw")
    return weight.to(x.dtype)


class Conv2d(nn.Conv2d):
    """Conv2d whose float32 parameters are cast to the input's dtype, the
    weight to its layout too.  A channels-last input that
    :func:`to_compute` padded with zero channels up to a multiple of
    :data:`CHANNEL_ALIGN` meets zero weight columns."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight
        aligned = self.in_channels + -self.in_channels % CHANNEL_ALIGN
        if (x.shape[1] == aligned > self.in_channels and self.groups == 1
                and is_channels_last(x)):
            weight = F.pad(weight, (0, 0, 0, 0, 0, aligned - self.in_channels))
        return self._conv_forward(x, _conv_weight(weight, x), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d whose float32 parameters are cast to the input's
    dtype, the weight to its layout too."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, _conv_weight(self.weight, x), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class _GroupSum(torch.autograd.Function):
    """A sum over the ranks of a process group that autograd goes through:
    the forward all-reduces (SUM), and so does the backward, since each
    rank's input reaches every rank's output.  Summed over the ranks, the
    gradients then are those of the sum of the ranks' losses."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return all_reduce_sum(grad, ctx.group), None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1, the same names and buffers) whose
    training mode is flax's ``BatchNorm(momentum=0.9)``: the output is
    torch's (normalized with the biased batch variance, statistics in
    float32, cast back to the input's dtype), and the running statistics
    are updated with the *biased* batch variance, ``r = 0.9 r + 0.1 stat``.
    Eval mode is torch's own.

    ``group`` (a ``torch.distributed`` process group, None by default; set
    by ``models.set_process_group``): the ranks each hold a shard of the
    batch, and training mode normalizes with the global batch's mean and
    biased variance, as the JAX step does under a ``data`` mesh.  The local
    sum and count are all-reduced for the mean, then the local sum of
    squared deviations from it for the variance (two passes: ``E[x^2] -
    mean^2`` cancels digits that bf16 activations expose), each through
    :class:`_GroupSum`, so the gradient goes through the global statistics.
    ``torch.nn.SyncBatchNorm`` is not used: it takes no CPU tensors, and it
    updates ``running_var`` with the unbiased variance."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            y, mean, var = self._group_batch_norm(x)
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias,
                             training=True, eps=self.eps)
        if is_recomputing():
            return y
        with torch.no_grad():
            if self.group is None:
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           unbiased=False)
            keep = 1.0 - self.momentum  # flax's momentum, 0.9
            write_buffers((
                (self.running_mean,
                 self.running_mean.mul(keep).add_(mean, alpha=1.0 - keep)),
                (self.running_var,
                 self.running_var.mul(keep).add_(var, alpha=1.0 - keep)),
                (self.num_batches_tracked, self.num_batches_tracked + 1)))
        return y

    def _group_batch_norm(self, x: torch.Tensor):
        """(output in x's dtype, detached float32 global mean and biased
        variance) over the group's global batch."""
        xf = x.float()
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        sums = _GroupSum.apply(torch.cat([xf.sum(dim=(0, 2, 3)), count]),
                               self.group)
        mean = sums[:c] / sums[c]
        dev = xf - mean[None, :, None, None]
        var = _GroupSum.apply(dev.square().sum(dim=(0, 2, 3)),
                              self.group) / sums[c]
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = dev * scale[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype), mean.detach(), var.detach()


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


class UNet(nn.Module):
    """Plain 4-level UNet with a tanh output (reference UNet, unet.py:61-84;
    the ``unet`` tag).  Its forward casts the input to ``dtype`` (when
    given) and returns the float32 tanh frame."""

    def __init__(self, in_channels: int, out_channels: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.inc = InConv(in_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.up1 = Up(512, 256)
        self.up2 = Up(256, 128)
        self.up3 = Up(128, 64)
        self.outc = Conv2d(64, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        y = self.up1(self.down3(x3), x3)
        y = self.up2(y, x2)
        y = self.up3(y, x1)
        return torch.tanh(self.outc(y).float())
