"""The int8 serving path's convolutions and the quantize that makes their
inputs (``csrc/int8_conv.cu``), and their plain PyTorch versions.

The counterpart of the int8 convolutions XLA runs for the JAX package's
``models/quantized.py`` (``_qconv``, ``_qconv_transpose``): int8 NHWC
activations times int8 weights, int32 accumulation, and ``_qconv``'s
epilogue in its order, in float32: ``acc * (sx * scale[c]) + bias[c]``
(each product and sum rounded), cast to bf16, then ReLU, or, with
``out_scale`` (int8 residency), ``clip(rint(y_bf16 / out_scale), -127,
127)`` with ReLU, as int8.

Layouts (the kernel's; :func:`~..models.quantized.quantize_twostream_variables`
prepares the weights once):

* ``x``: (N, H, W, Cin) int8, Cin a multiple of 32 (:func:`pad_channels`);
* 3x3 weights ``wk``: (Cout_pad, 9, Cin) int8, row ``co`` holding taps
  ``ky * 3 + kx`` and input channels, Cout_pad a multiple of 64;
* 2x2 transposed weights ``wk``: (Cols_pad, 1, Cin) int8, row ``(a * 2 +
  b) * Cout + co`` the kernel tap that writes output pixel (2i + a, 2j +
  b), Cols_pad a multiple of 64 and >= 4 * Cout;
* ``sx``: (1,) float32 on the device (a dynamic scale stays there);
  ``scale``, ``bias``: (Cout,) float32; ``out_scale``: (1,) float32.

:func:`quantize_pack_int8` makes ``x`` from a statically quantized conv
input in one pass: ``clip(rint(v / sx), -127, 127)`` as int8, channels
zero-padded to a multiple of 32, where ``v`` is the bf16 or float32 input
(any strides), the concatenation ``cat([skip, x], -1)``, or ``x``'s 2x2
stride-2 max-pool (:func:`gather_input`).

``acc=True`` returns the int32 accumulators (the checks' view).  A CUDA
tensor launches the kernel on the current stream (counted in the
wrapper's ``launches``) or raises; a CPU tensor returns the plain
version's result: a float64 convolution or product of the int8 values
(exact: |acc| <= 127^2 * 4,608 < 2^53), cast to int32, and the same
float32 epilogue as PyTorch ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

CIN_ALIGN, COLS_ALIGN = 32, 64  # the kernel's K step and column tile
MODE_ACC, MODE_BF16, MODE_INT8 = 0, 1, 2


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("int8_conv")
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.ammc_qconv_int8.argtypes = [ptr] * 7 + [c_int] * 9 + [ptr]
    lib.ammc_qconv_int8.restype = c_int
    lib.ammc_quantize_pack_int8.argtypes = [
        ptr, ptr, ctypes.POINTER(ctypes.c_int64), ptr, ptr, c_int, c_int, ptr]
    lib.ammc_quantize_pack_int8.restype = c_int
    lib.ammc_cuda_error_string.argtypes = [c_int]
    lib.ammc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pad_channels(x: torch.Tensor, align: int = CIN_ALIGN) -> torch.Tensor:
    """Zero-pad the last axis to a multiple of ``align`` (a no-op when it
    is one)."""
    extra = -x.shape[-1] % align
    return F.pad(x, (0, extra)) if extra else x


def _epilogue_ref(acc: torch.Tensor, sx: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, relu: bool,
                  out_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``_qconv``'s epilogue in float32 PyTorch ops, each rounded."""
    alpha = sx.reshape(()).float() * scale
    y = (acc.float() * alpha + bias).to(torch.bfloat16)
    if out_scale is None:
        return torch.relu(y) if relu else y
    q = torch.round(y.float() / out_scale.reshape(()).float())
    q = q.clamp(-127, 127).to(torch.int8)
    return q.clamp_min(0) if relu else q


def qconv3x3_int8_ref(x, wk, sx, scale, bias, cout: int, relu: bool = False,
                      out_scale=None, acc: bool = False) -> torch.Tensor:
    """Plain version of :func:`qconv3x3_int8` (arguments alike)."""
    n, h, w, cin = x.shape
    w4 = wk[:cout].reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)
    out = F.conv2d(x.permute(0, 3, 1, 2).double(), w4.double(), padding=1)
    out = out.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()
    return out if acc else _epilogue_ref(out, sx, scale, bias, relu,
                                         out_scale)


def qconv_transpose2x2_int8_ref(x, wk, sx, scale, bias, cout: int,
                                acc: bool = False) -> torch.Tensor:
    """Plain version of :func:`qconv_transpose2x2_int8` (arguments
    alike)."""
    n, h, w, cin = x.shape
    prod = x.reshape(-1, cin).double() @ wk[:4 * cout, 0].double().T
    out = prod.round().to(torch.int32).reshape(n, h, w, 2, 2, cout)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout)
    return out if acc else _epilogue_ref(out, sx, scale, bias, False, None)


def _check(x, wk, sx, scale, bias, cout, taps, out_scale):
    tensors = [x, wk, sx, scale, bias] + ([out_scale] if out_scale is not None
                                          else [])
    cols = cout if taps == 9 else 4 * cout
    if (x.ndim != 4 or x.dtype != torch.int8 or wk.dtype != torch.int8
            or wk.ndim != 3 or wk.shape[1] != taps or wk.shape[2] != x.shape[3]
            or x.shape[3] % CIN_ALIGN or wk.shape[0] % COLS_ALIGN
            or wk.shape[0] < cols
            or any(t.dtype != torch.float32 for t in (sx, scale, bias))
            or sx.numel() != 1 or scale.shape != (cout,)
            or bias.shape != (cout,)
            or (out_scale is not None
                and (out_scale.numel() != 1
                     or out_scale.dtype != torch.float32))
            or any(not t.is_contiguous() for t in tensors)
            or len({t.device for t in tensors}) != 1):
        raise ValueError(
            f"qconv int8 ({taps} taps): want contiguous x (N, H, W, Cin) int8 "
            f"with Cin % {CIN_ALIGN} == 0, wk (>= {cols} rows, a multiple of "
            f"{COLS_ALIGN}, {taps}, Cin) int8, float32 sx (1,), scale and "
            f"bias ({cout},) on one device; got x {tuple(x.shape)} {x.dtype}, "
            f"wk {tuple(wk.shape)} {wk.dtype}")


def _launch(x, wk, sx, scale, bias, out_scale, out, cout, taps, mode, relu):
    n, h, w, cin = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.ammc_qconv_int8(
            x.data_ptr(), wk.data_ptr(), sx.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out_scale.data_ptr() if out_scale is not None
            else None, out.data_ptr(), n, h, w, cin, cout, wk.shape[0], taps,
            mode, int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {err} "
                           f"({lib.ammc_cuda_error_string(err).decode()})")


def _out(x, shape, acc, out_scale):
    dtype = (torch.int32 if acc else torch.int8 if out_scale is not None
             else torch.bfloat16)
    return torch.empty(shape, dtype=dtype, device=x.device)


def qconv3x3_int8(x: torch.Tensor, wk: torch.Tensor, sx: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, cout: int,
                  relu: bool = False, out_scale: Optional[torch.Tensor] = None,
                  acc: bool = False) -> torch.Tensor:
    """3x3 SAME stride-1 int8 convolution: (N, H, W, Cin) int8 -> (N, H, W,
    cout) bf16 (ReLU with ``relu``), int8 with ``out_scale``, or the int32
    accumulators with ``acc``."""
    _check(x, wk, sx, scale, bias, cout, 9, out_scale)
    if x.device.type == "cpu":
        return qconv3x3_int8_ref(x, wk, sx, scale, bias, cout, relu,
                                 out_scale, acc)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n, h, w, _ = x.shape
    out = _out(x, (n, h, w, cout), acc, out_scale)
    if out.numel():
        mode = (MODE_ACC if acc else MODE_INT8 if out_scale is not None
                else MODE_BF16)
        _launch(x, wk, sx, scale, bias, out_scale, out, cout, 9, mode, relu)
        qconv3x3_int8.launches += 1
    return out


qconv3x3_int8.launches = 0


def qconv_transpose2x2_int8(x: torch.Tensor, wk: torch.Tensor,
                            sx: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, cout: int,
                            acc: bool = False) -> torch.Tensor:
    """2x2 stride-2 transposed int8 convolution (``transpose_kernel``
    semantics): (N, H, W, Cin) int8 -> (N, 2H, 2W, cout) bf16, or the int32
    accumulators with ``acc``."""
    _check(x, wk, sx, scale, bias, cout, 1, None)
    if x.device.type == "cpu":
        return qconv_transpose2x2_int8_ref(x, wk, sx, scale, bias, cout, acc)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n, h, w, _ = x.shape
    out = _out(x, (n, 2 * h, 2 * w, cout), acc, None)
    if out.numel():
        _launch(x, wk, sx, scale, bias, None, out, cout, 1,
                MODE_ACC if acc else MODE_BF16, False)
        qconv_transpose2x2_int8.launches += 1
    return out


qconv_transpose2x2_int8.launches = 0


def gather_input(x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                 pool: bool = False) -> torch.Tensor:
    """The conv input that :func:`quantize_pack_int8` quantizes, in ATen
    ops: ``x``; with ``skip``, ``cat([skip, x], -1)``; with ``pool``,
    ``x``'s 2x2 stride-2 max-pool (``amax``, NaN propagating)."""
    if skip is not None:
        x = torch.cat([skip, x], dim=-1)
    if pool:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    return x


def quantize_pack_int8_ref(x: torch.Tensor, sx: torch.Tensor,
                           skip: Optional[torch.Tensor] = None,
                           pool: bool = False) -> torch.Tensor:
    """Plain version of :func:`quantize_pack_int8` (arguments alike): the
    gather, then the static quantize in float32 ATen ops, then the
    padding."""
    x = gather_input(x, skip, pool)
    xq = torch.round(x.float() / sx).clamp(-127, 127).to(torch.int8)
    return pad_channels(xq).contiguous()


def _check_pack(x, sx, skip, pool):
    srcs = [x] if skip is None else [skip, x]
    n, h, w = x.shape[:3] if x.ndim == 4 else (0, 0, 0)
    if (any(t.ndim != 4 or t.dtype != x.dtype or not t.shape[-1]
            for t in srcs)
            or x.dtype not in (torch.bfloat16, torch.float32)
            or (skip is not None and (pool or skip.shape[:3] != x.shape[:3]))
            or (pool and (h % 2 or w % 2))
            or sx.dtype != torch.float32 or sx.numel() != 1
            or len({t.device for t in srcs + [sx]}) != 1):
        raise ValueError(
            "quantize_pack_int8: want x (N, H, W, C > 0) bf16 or float32, "
            "skip None or (N, H, W, Cs > 0) of x's type (not with pool), H "
            "and W even with pool, a float32 sx (1,), all on one device; "
            "got x "
            f"{tuple(x.shape)} {x.dtype}, skip "
            f"{None if skip is None else (tuple(skip.shape), skip.dtype)}, "
            f"pool {pool}, sx {tuple(sx.shape)} {sx.dtype}")
    pixels = n * h * w // (4 if pool else 1)
    cpad = -(-sum(t.shape[-1] for t in srcs) // CIN_ALIGN) * CIN_ALIGN
    if (pixels > 2 ** 31 - 33
            or -(-pixels // 32) * 32 * (cpad // 16) >= 2 ** 31):
        raise ValueError(f"quantize_pack_int8: {pixels} pixels of {cpad} "
                         "channels are more than the kernel indexes")
    return srcs, cpad


def quantize_pack_int8(x: torch.Tensor, sx: torch.Tensor,
                       skip: Optional[torch.Tensor] = None,
                       pool: bool = False) -> torch.Tensor:
    """A statically quantized conv input as the convolutions take it, in
    one pass: (N, H, W, C) bf16 or float32 ``x`` of any strides (with
    ``skip`` (N, H, W, Cs), the channels of ``cat([skip, x], -1)``; with
    ``pool``, ``x``'s 2x2 max-pool, H and W halved) -> (N, H', W', C_pad)
    int8, contiguous, ``clip(rint(v / sx), -127, 127)``, channels
    zero-padded to a multiple of ``CIN_ALIGN``.  ``sx``: (1,) float32."""
    srcs, cpad = _check_pack(x, sx, skip, pool)
    if x.device.type == "cpu":
        return quantize_pack_int8_ref(x, sx, skip, pool)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    n, h, w = x.shape[:3]
    if pool:
        h, w = h // 2, w // 2
    out = torch.empty((n, h, w, cpad), dtype=torch.int8, device=x.device)
    if not out.numel():
        return out
    a, b = srcs[0], srcs[1] if len(srcs) == 2 else None
    geom = (ctypes.c_int64 * 14)(
        n, h, w, cpad, a.shape[3], *a.stride(),
        *((b.shape[3], *b.stride()) if b is not None else (0,) * 5))
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.ammc_quantize_pack_int8(
            a.data_ptr(), b.data_ptr() if b is not None else None, geom,
            sx.data_ptr(), out.data_ptr(),
            0 if x.dtype == torch.bfloat16 else 1, int(pool),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"quantize_pack_int8 kernel launch failed: CUDA error {err} "
            f"({lib.ammc_cuda_error_string(err).decode()})")
    quantize_pack_int8.launches += 1
    return out


quantize_pack_int8.launches = 0
