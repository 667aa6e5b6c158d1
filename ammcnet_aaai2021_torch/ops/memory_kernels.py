"""Fused top-k memory lookup: the CUDA kernels' wrappers and plain versions.

Counterparts of the JAX package's two Pallas kernels: B1
``quantize_topk_pallas`` (``ammcnet_aaai2021_tpu/ops/memory_pallas.py:201-255``)
and B2 ``quantize_topk_pallas_train`` (``memory_pallas.py:137-198``), the
training variant that also returns the EMA statistics.  Both kernels are
``csrc/quantize_topk.cu`` (its header says what bounds them on an H100 and
what the design does about that).

* :func:`quantize_topk_fused` (B1) and :func:`quantize_topk_train_fused`
  (B2) are the wrappers: each checks its inputs, launches its kernel for
  CUDA tensors (or raises) and counts its launches in its own ``launches``
  attribute; for CPU tensors it returns the plain version's result.
* :func:`quantize_topk_fused_ref` and :func:`quantize_topk_train_fused_ref`
  are the plain PyTorch versions, the same formula (``-2 flat@E + ||E||^2``
  in fp32 with TF32 off) and the same tie-break (lowest index), used by the
  CPU tests and held against the kernels on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Tuple

import torch

from . import cuda_build

# codebook sizes the kernel is instantiated for (n_embed / 32 codewords per lane)
KERNEL_N_EMBEDS = (32, 64, 128, 256, 512)


@contextlib.contextmanager
def exact_fp32_matmul():
    """fp32 matmuls in full fp32 (TF32 off) inside the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def topk_smallest(dist: torch.Tensor, k: int) -> torch.Tensor:
    """(N, k) int64 indices of each row's k smallest values, ascending, the
    lowest index first among equal values: k rounds of ``argmin`` (which
    returns the first minimum) with the winner masked to +inf.  ``torch.topk``
    promises no order among ties."""
    remaining = dist.clone()
    picks = []
    for _ in range(k):
        i = remaining.argmin(dim=1)
        picks.append(i)
        remaining.scatter_(1, i[:, None], float("inf"))
    return torch.stack(picks, dim=1)


def quantize_topk_fused_ref(flat: torch.Tensor, embed: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(q_topk (N, k*dim) f32,
    q1 (N, dim) f32, top1_idx (N,) int32)``."""
    n, dim = flat.shape
    flat32, embed32 = flat.float(), embed.float()
    with exact_fp32_matmul():
        cross = flat32 @ embed32
    # ranking distance; the row-constant ||z||^2 is dropped as in the kernel
    dist = -2.0 * cross + (embed32 * embed32).sum(0, keepdim=True)
    topk_idx = topk_smallest(dist, k)
    q = embed32.t()[topk_idx]  # (N, k, dim)
    return (q.reshape(n, k * dim), q[:, 0].contiguous(),
            topk_idx[:, 0].to(torch.int32))


def quantize_topk_train_fused_ref(
        flat: torch.Tensor, embed: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Plain PyTorch version of B2: B1's outputs plus the EMA statistics of
    the top-1 picks, ``counts (n_embed,) = one_hot.sum(0)`` and
    ``embed_sum (dim, n_embed) = flat^T @ one_hot``, in fp32 (TF32 off)."""
    q_topk, q1, idx = quantize_topk_fused_ref(flat, embed, k)
    one_hot = torch.nn.functional.one_hot(
        idx.long(), embed.shape[1]).to(torch.float32)
    with exact_fp32_matmul():
        embed_sum = flat.float().t() @ one_hot
    return q_topk, q1, idx, one_hot.sum(0), embed_sum


def _check(flat: torch.Tensor, embed: torch.Tensor, k: int) -> None:
    if flat.ndim != 2 or embed.ndim != 2 or flat.shape[1] != embed.shape[0]:
        raise ValueError(f"want flat (N, dim) and embed (dim, n_embed), got "
                         f"{tuple(flat.shape)} and {tuple(embed.shape)}")
    if flat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flat must be float32 or bfloat16, got {flat.dtype}")
    if embed.dtype != torch.float32:
        raise ValueError(f"embed must be float32, got {embed.dtype}")
    if not 1 <= k <= embed.shape[1]:
        raise ValueError(f"k={k} outside [1, n_embed={embed.shape[1]}]")
    if flat.device != embed.device:
        raise ValueError(f"flat on {flat.device}, embed on {embed.device}")
    if not (flat.is_contiguous() and embed.is_contiguous()):
        raise ValueError("flat and embed must be contiguous")
    if flat.shape[0] >= 2 ** 31:
        raise ValueError(f"{flat.shape[0]} rows: the kernel counts rows in int32")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (once per process)."""
    lib = cuda_build.load("quantize_topk")
    ptr = ctypes.c_void_p
    lib.ammc_quantize_topk.argtypes = [
        ptr, ctypes.c_int, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
    lib.ammc_quantize_topk.restype = ctypes.c_int
    lib.ammc_quantize_topk_train.argtypes = [
        ptr, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ptr]
    lib.ammc_quantize_topk_train.restype = ctypes.c_int
    lib.ammc_quantize_topk_grid.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.ammc_quantize_topk_grid.restype = ctypes.c_int
    lib.ammc_quantize_topk_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int,
                                                  ctypes.c_int]
    lib.ammc_quantize_topk_smem_bytes.restype = ctypes.c_longlong
    lib.ammc_max_optin_smem.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.ammc_max_optin_smem.restype = ctypes.c_int
    lib.ammc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ammc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ammc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


@functools.cache
def _grid(device: int, bf16: bool, n: int, dim: int, n_embed: int,
          stats: bool) -> int:
    """Blocks one launch takes, after checking that the codebook (and B2's
    partial statistics) fit the card's shared memory.  The C sizing call
    queries the device and sets the kernel's shared-memory attribute, so it
    runs once per device and sizes, not on every launch."""
    lib = _library()
    with torch.cuda.device(device):
        smem = lib.ammc_quantize_topk_smem_bytes(dim, n_embed, int(stats))
        limit = ctypes.c_int(0)
        _raise_on(lib, lib.ammc_max_optin_smem(ctypes.byref(limit)),
                  "reading the shared-memory limit")
        if smem > limit.value:
            what = "the training kernel (codebook and statistics)" if stats \
                else "the kernel"
            raise ValueError(
                f"a ({dim}, {n_embed}) codebook needs {smem} B of shared "
                f"memory per block in {what}; this card allows "
                f"{limit.value} B")
        grid = ctypes.c_int(0)
        _raise_on(lib, lib.ammc_quantize_topk_grid(
            int(bf16), n, dim, n_embed, int(stats), ctypes.byref(grid)),
            "sizing the quantize_topk launch")
    return grid.value


def _kernel_device(flat: torch.Tensor, embed: torch.Tensor) -> None:
    if flat.device.type != "cuda":
        raise ValueError(f"no kernel for device {flat.device}")
    if embed.shape[1] not in KERNEL_N_EMBEDS:
        raise ValueError(f"the kernel takes n_embed in {KERNEL_N_EMBEDS}, "
                         f"got {embed.shape[1]}")


def quantize_topk_fused(flat: torch.Tensor, embed: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused distance + top-k + gather.

    Args:
      flat: (N, dim) latents, float32 or bfloat16, contiguous.
      embed: (dim, n_embed) float32 codebook, contiguous, same device.
      k: codewords per row.

    Returns:
      ``(q_topk (N, k*dim) f32, q1 (N, dim) f32, top1_idx (N,) int32)``.
    """
    _check(flat, embed, k)
    if flat.device.type == "cpu":
        return quantize_topk_fused_ref(flat, embed, k)
    _kernel_device(flat, embed)
    n, dim = flat.shape
    n_embed = embed.shape[1]
    q_topk = torch.empty((n, k * dim), dtype=torch.float32, device=flat.device)
    q1 = torch.empty((n, dim), dtype=torch.float32, device=flat.device)
    idx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    if n == 0:
        return q_topk, q1, idx
    lib = _library()
    bf16 = flat.dtype == torch.bfloat16
    grid = _grid(flat.device.index, bf16, n, dim, n_embed, False)
    with torch.cuda.device(flat.device):
        err = lib.ammc_quantize_topk(
            flat.data_ptr(), int(bf16), embed.data_ptr(), q_topk.data_ptr(),
            q1.data_ptr(), idx.data_ptr(), grid, n, dim, n_embed, k,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "quantize_topk kernel launch")
    quantize_topk_fused.launches += 1
    return q_topk, q1, idx


quantize_topk_fused.launches = 0


def quantize_topk_train_fused(
        flat: torch.Tensor, embed: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Fused distance + top-k + gather + EMA statistics (kernel B2).

    Args: as :func:`quantize_topk_fused`.

    Returns:
      ``(q_topk (N, k*dim) f32, q1 (N, dim) f32, top1_idx (N,) int32,
      counts (n_embed,) f32, embed_sum (dim, n_embed) f32)``; the statistics
      are bitwise equal across calls on the same input.
    """
    _check(flat, embed, k)
    if flat.device.type == "cpu":
        return quantize_topk_train_fused_ref(flat, embed, k)
    _kernel_device(flat, embed)
    n, dim = flat.shape
    n_embed = embed.shape[1]
    dev = flat.device
    q_topk = torch.empty((n, k * dim), dtype=torch.float32, device=dev)
    q1 = torch.empty((n, dim), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return (q_topk, q1, idx,
                torch.zeros((n_embed,), dtype=torch.float32, device=dev),
                torch.zeros((dim, n_embed), dtype=torch.float32, device=dev))
    counts = torch.empty((n_embed,), dtype=torch.float32, device=dev)
    embed_sum = torch.empty((dim, n_embed), dtype=torch.float32, device=dev)
    lib = _library()
    bf16 = flat.dtype == torch.bfloat16
    grid = _grid(dev.index, bf16, n, dim, n_embed, True)
    # one workspace: grid partial embed_sums (f32), then grid partial counts
    # (int32, the same 4 bytes an entry)
    work = torch.empty((grid * (dim + 1) * n_embed,), dtype=torch.float32,
                       device=dev)
    part_counts = work[grid * dim * n_embed:]
    with torch.cuda.device(dev):
        err = lib.ammc_quantize_topk_train(
            flat.data_ptr(), int(bf16), embed.data_ptr(), q_topk.data_ptr(),
            q1.data_ptr(), idx.data_ptr(), counts.data_ptr(),
            embed_sum.data_ptr(), work.data_ptr(), part_counts.data_ptr(),
            grid, n, dim, n_embed, k, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "quantize_topk_train kernel launch")
    quantize_topk_train_fused.launches += 1
    return q_topk, q1, idx, counts, embed_sum


quantize_topk_train_fused.launches = 0
