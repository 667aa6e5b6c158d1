"""FLOPs of FlowNet 2.0 a frame pair and the correlation's least time.

FLOPs: ``FlopCounterMode`` over the benchmark's reference
(``reference/flownet2.py``) on the meta device, as ``model.py`` counts
FlowNet2-SD: its convolutions and transposed convolutions (66.08 GFLOP a
pair at 256x256); the correlation (0.23 GFLOP there), the warps, norms
and upsamples are elementwise work and not counted.

The correlation (FlowNetC's, on two (b, C, h, w) bf16 maps at 441
displacements) reads both maps and writes its bf16 output once, ``2 * b *
C * h * w * 2 + b * 441 * h * w * 2`` bytes, against ``2 * 441 * C * h *
w * b`` operations on the bf16 tensor cores; its bound is the larger time
(the bytes: about 0.58 us a pair at FlowNet 2.0's C 256, h = w = 32).
Nothing here reads the port.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import flownet2 as ref
from .peaks import BF16_FLOPS, bound_s

DISPLACEMENTS = 441
CHANNELS = 256  # FlowNetC's conv3 width
DOWNSAMPLE = 8  # FlowNetC's conv1..conv3 strides


@functools.lru_cache(maxsize=None)
def pair_flops(size: int = 256) -> int:
    """FLOPs of FlowNet 2.0 on one ``size`` x ``size`` frame pair."""
    with torch.device("meta"):
        net = ref.FlowNet2().eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.empty(1, 3, 2, size, size, device="meta"))
    return int(counter.get_total_flops())


def correlation_bytes(b: int, c: int = CHANNELS, h: int = 32, w: int = 32
                      ) -> int:
    return 2 * b * c * h * w * 2 + b * DISPLACEMENTS * h * w * 2


def correlation_flops(b: int, c: int = CHANNELS, h: int = 32, w: int = 32
                      ) -> int:
    return 2 * DISPLACEMENTS * c * h * w * b


def correlation_bound_s(b: int, size: int = 256) -> float:
    """The least time of one correlation call on ``b`` pairs of ``size`` x
    ``size`` frames."""
    side = size // DOWNSAMPLE
    return bound_s(correlation_flops(b, h=side, w=side),
                   correlation_bytes(b, h=side, w=side), BF16_FLOPS)
