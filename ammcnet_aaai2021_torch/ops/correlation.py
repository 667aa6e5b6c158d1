"""FlowNetC's correlation layer (``csrc/correlation.cu``) and its plain
PyTorch version.

flownet2-pytorch's ``correlation_package`` as FlowNet 2.0's FlowNetC
configures it (``networks/FlowNetC.py``: pad 20, kernel 1, max
displacement 20, stride1 1, stride2 2): two maps ``f1``, ``f2`` (B, C, H,
W) give (B, 441, H, W),

    out[b, i * 21 + j, y, x] = sum_c f1[b, c, y, x] * f2[b, c, y + dy, x + dx] / C

with ``dy = 2 i - 20``, ``dx = 2 j - 20`` (the vertical displacement the
outer index) and ``f2`` zero outside the map; ``leaky`` applies FlowNetC's
``corr_activation``, LeakyReLU(0.1), after the division.  The sums are
float32 and the output takes the inputs' type.

A CUDA tensor (bf16 only: the serving path's type) launches the kernel on
the current stream or raises; a CPU tensor (bf16 or float32) gets the
plain version, 441 shifted products in ATen ops.
``correlation.launches_by_route`` counts the calls of each route
(``kernel``, ``plain``), and while a profiler runs so do the counters
``flownet2.correlation.kernel`` and ``.plain`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import cuda_build

MAX_DISPLACEMENT, STRIDE2 = 20, 2
SIDE = 2 * MAX_DISPLACEMENT // STRIDE2 + 1  # 21 displacements an axis
DISPLACEMENTS = SIDE * SIDE  # 441
SLOPE = 0.1
ROUTES = ("kernel", "plain")
# the kernel's limits: the k step, the 16-byte loads, the loads and stores
# a thread plans (C * W / 16 <= 2 * 512, 21 * W / 2 <= 2 * 512) and 32-bit
# offsets; and one output row's block has to fit in shared memory
C_ALIGN, W_ALIGN, MAX_CW, MAX_W = 16, 8, 16384, 96


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("correlation")
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.ammc_correlation.argtypes = [ptr, ptr, ptr] + [c_int] * 5 + [ptr]
    lib.ammc_correlation.restype = c_int
    lib.ammc_correlation_block_rows.argtypes = [c_int, c_int]
    lib.ammc_correlation_block_rows.restype = c_int
    lib.ammc_cuda_error_string.argtypes = [c_int]
    lib.ammc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def correlation_ref(f1: torch.Tensor, f2: torch.Tensor, leaky: bool = False
                    ) -> torch.Tensor:
    """Plain version of :func:`correlation` (arguments alike): a loop over
    the 441 displacements, each a float32 product summed over channels."""
    b, c, h, w = f1.shape
    a = f1.float()
    m = MAX_DISPLACEMENT
    pad = F.pad(f2.float(), (m, m, m, m))
    outs = []
    for dy in range(0, 2 * m + 1, STRIDE2):
        for dx in range(0, 2 * m + 1, STRIDE2):
            outs.append((a * pad[:, :, dy:dy + h, dx:dx + w]).sum(1))
    out = torch.stack(outs, dim=1) / c
    if leaky:
        out = F.leaky_relu(out, SLOPE)
    return out.to(f1.dtype)


def _check(f1: torch.Tensor, f2: torch.Tensor) -> None:
    if (f1.ndim != 4 or f1.shape != f2.shape or f1.dtype != f2.dtype
            or f1.device != f2.device
            or f1.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(
            "correlation: want f1 and f2 (B, C, H, W) of one shape, type "
            "(bf16 or float32) and device; got "
            f"{tuple(f1.shape)} {f1.dtype} {f1.device} and "
            f"{tuple(f2.shape)} {f2.dtype} {f2.device}")


def _check_kernel(f1: torch.Tensor) -> None:
    b, c, h, w = f1.shape
    if (f1.dtype != torch.bfloat16 or c % C_ALIGN or w % W_ALIGN
            or c * w > MAX_CW or w > MAX_W or c * h * w >= 2 ** 31
            or not 0 < b <= 65535 or not 0 < h <= 65535
            or not _library().ammc_correlation_block_rows(c, w)):
        raise ValueError(
            f"correlation kernel: want bf16 maps with C % {C_ALIGN} == 0, "
            f"W % {W_ALIGN} == 0, W <= {MAX_W}, C * W <= {MAX_CW}, C * H * W "
            f"< 2^31, 1 to 65,535 images; got {tuple(f1.shape)} {f1.dtype}")


def correlation(f1: torch.Tensor, f2: torch.Tensor, leaky: bool = False
                ) -> torch.Tensor:
    """FlowNetC's correlation of ``f1`` and ``f2`` (B, C, H, W) -> (B, 441,
    H, W) in their type (see the module's note), LeakyReLU(0.1) with
    ``leaky``."""
    _check(f1, f2)
    if f1.device.type == "cpu":
        out, route = correlation_ref(f1, f2, leaky), "plain"
    elif f1.device.type == "cuda":
        _check_kernel(f1)
        f1, f2 = f1.contiguous(), f2.contiguous()
        b, c, h, w = f1.shape
        out = torch.empty((b, DISPLACEMENTS, h, w), dtype=f1.dtype,
                          device=f1.device)
        lib = _library()
        with torch.cuda.device(f1.device):
            err = lib.ammc_correlation(
                f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w,
                int(leaky), torch.cuda.current_stream(f1.device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"correlation kernel launch failed: CUDA error {err} "
                f"({lib.ammc_cuda_error_string(err).decode()})")
        route = "kernel"
    else:
        raise ValueError(f"no correlation for device {f1.device}")
    correlation.launches_by_route[route] += 1
    profiling.count(f"flownet2.correlation.{route}")
    return out


correlation.launches_by_route = dict.fromkeys(ROUTES, 0)
