"""Fused top-k memory lookup: the CUDA kernels' wrappers and plain versions.

Counterparts of the JAX package's two Pallas kernels: B1
``quantize_topk_pallas`` (``ammcnet_aaai2021_tpu/ops/memory_pallas.py:201-255``)
and B2 ``quantize_topk_pallas_train`` (``memory_pallas.py:137-198``), the
training variant that also returns the EMA statistics.  Each has two CUDA
routes, chosen by one rule, :func:`lookup_route`: bf16 latents of width 64
with k <= 4 and a codebook size the tensor-core kernels are built for go
to ``csrc/quantize_topk_mma.cu``; the rest (float32 latents, other widths
and codebook sizes, larger k) to the general route ``csrc/quantize_topk.cu``
(key ``CUDA_CORE``), which runs the distances on the bf16 tensor cores at
float32 accuracy (a three-part bf16 split), streams the codebook through
shared memory 64 codewords by 64 dims at a time, and so takes any width,
any n_embed and any k <= n_embed.  On both routes B2 is B1's kernel, then a
statistics kernel.
Each file's header says what bounds its kernels on an H100 and what the
design does about that.

* :func:`quantize_topk_fused` (B1) and :func:`quantize_topk_train_fused`
  (B2) are the wrappers: each checks its inputs, launches its route's
  kernels for CUDA tensors (or raises) and counts its launches in its own
  ``launches`` attribute, and by route in ``launches_by_route``; for CPU
  tensors it returns the plain version's result.
* :func:`quantize_topk_fused_ref` and :func:`quantize_topk_train_fused_ref`
  are the plain PyTorch versions, the same formula (``-2 flat@E + ||E||^2``
  in fp32 with TF32 off) and the same tie-break (lowest index), used by the
  CPU tests and held against the kernels on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build

# codebook sizes the tensor-core kernel is instantiated for
KERNEL_N_EMBEDS = (32, 64, 128, 256, 512)
# the routes of B1 and B2: the specialised tensor-core kernels (bf16 latents
# of width 64) and the general route (any input; its distances run on the
# tensor cores too, the key is the name it was given first)
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"
ROUTES = (TENSOR_CORE, CUDA_CORE)
# what the tensor-core kernel is built for: latent width, largest k
MMA_DIM, MMA_MAX_K = 64, 4


def lookup_route(dtype: torch.dtype, dim: int, n_embed: int, k: int) -> str:
    """The route of B1 and B2 for these inputs: bf16 latents of width
    ``MMA_DIM``, ``k <= MMA_MAX_K`` and ``n_embed`` in ``KERNEL_N_EMBEDS``
    take the tensor-core kernels; everything else the general route
    (``CUDA_CORE``)."""
    if (dtype == torch.bfloat16 and dim == MMA_DIM and 1 <= k <= MMA_MAX_K
            and n_embed in KERNEL_N_EMBEDS):
        return TENSOR_CORE
    return CUDA_CORE


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
    """The built general-route kernel library (``csrc/quantize_topk.cu``,
    the other route of B1 and B2), its C functions typed (once per
    process)."""
    lib = cuda_build.load("quantize_topk")
    ptr = ctypes.c_void_p
    lib.ammc_quantize_topk.argtypes = [
        ptr, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
    lib.ammc_quantize_topk.restype = ctypes.c_int
    lib.ammc_quantize_topk_train.argtypes = [
        ptr, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
    lib.ammc_quantize_topk_train.restype = ctypes.c_int
    lib.ammc_quantize_topk_grid.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.ammc_quantize_topk_grid.restype = ctypes.c_int
    lib.ammc_quantize_topk_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ammc_quantize_topk_smem_bytes.restype = ctypes.c_longlong
    lib.ammc_quantize_topk_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.ammc_quantize_topk_scratch_bytes.restype = ctypes.c_longlong
    lib.ammc_ema_stats_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ammc_ema_stats_smem_bytes.restype = ctypes.c_longlong
    _type_common(lib)
    return lib


@functools.cache
def _mma_library() -> ctypes.CDLL:
    """The built tensor-core kernel library (the bf16 route of B1 and B2),
    typed."""
    lib = cuda_build.load("quantize_topk_mma")
    ptr = ctypes.c_void_p
    lib.ammc_quantize_topk_mma.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ptr]
    lib.ammc_quantize_topk_mma.restype = ctypes.c_int
    lib.ammc_quantize_topk_mma_train.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ptr]
    lib.ammc_quantize_topk_mma_train.restype = ctypes.c_int
    lib.ammc_quantize_topk_mma_grid.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ammc_quantize_topk_mma_grid.restype = ctypes.c_int
    lib.ammc_quantize_topk_mma_smem_bytes.argtypes = [ctypes.c_int,
                                                      ctypes.c_int]
    lib.ammc_quantize_topk_mma_smem_bytes.restype = ctypes.c_longlong
    _type_common(lib)
    return lib


def _type_common(lib: ctypes.CDLL) -> None:
    """Types the helpers both libraries export."""
    lib.ammc_max_optin_smem.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.ammc_max_optin_smem.restype = ctypes.c_int
    lib.ammc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ammc_cuda_error_string.restype = ctypes.c_char_p


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ammc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _check_smem(lib: ctypes.CDLL, smem: int, what: str) -> None:
    limit = ctypes.c_int(0)
    _raise_on(lib, lib.ammc_max_optin_smem(ctypes.byref(limit)),
              "reading the shared-memory limit")
    if smem > limit.value:
        raise ValueError(f"{what} needs {smem} B of shared memory per block; "
                         f"this card allows {limit.value} B")


@functools.cache
def _grid(device: int, bf16: bool, n: int, dim: int, n_embed: int,
          k: int) -> Tuple[int, int]:
    """Blocks one launch of the general-route lookup kernel takes (B1, and
    B2's lookup) and the bytes of its scratch, after checking that the
    block's shared memory fits the card.  Stages of 64 codewords by 64 dims
    stream through a block, so neither the width nor n_embed sets a limit;
    past k 16 the lanes' running lists sit in shared memory where they fit,
    else in the scratch.  The C sizing call queries the device and sets the
    kernels' shared-memory attributes, so it runs once per device and sizes,
    not on every launch."""
    lib = _library()
    with torch.cuda.device(device):
        _check_smem(lib, lib.ammc_quantize_topk_smem_bytes(
            int(bf16), dim, n_embed, k), f"the general-route kernel at "
            f"latent width {dim}, n_embed {n_embed}, k {k}")
        grid = ctypes.c_int(0)
        _raise_on(lib, lib.ammc_quantize_topk_grid(
            int(bf16), n, dim, n_embed, k, ctypes.byref(grid)),
            "sizing the quantize_topk launch")
        scratch = lib.ammc_quantize_topk_scratch_bytes(
            int(bf16), dim, n_embed, k, grid.value)
    return grid.value, scratch


@functools.cache
def _check_stats(device: int, bf16: bool, dim: int) -> None:
    """Raise unless the general route's statistics kernel fits the card at
    this width: a cluster's block keeps its warps' staged rows and partials
    of at least one codeword's dim sums (about width 8,100 for float32
    latents and 9,700 for bf16 on an H100)."""
    lib = _library()
    with torch.cuda.device(device):
        _check_smem(lib, lib.ammc_ema_stats_smem_bytes(int(bf16), dim),
                    f"the general-route statistics kernel at latent width "
                    f"{dim}")


@functools.cache
def _mma_grid(device: int, n: int, n_embed: int, k: int) -> int:
    """Blocks one launch of the tensor-core lookup takes (as :func:`_grid`),
    for B1 and B2 alike; the C call also readies B2's statistics kernel."""
    lib = _mma_library()
    with torch.cuda.device(device):
        _check_smem(lib, lib.ammc_quantize_topk_mma_smem_bytes(n_embed, k),
                    f"the tensor-core kernel at n_embed {n_embed}")
        grid = ctypes.c_int(0)
        _raise_on(lib, lib.ammc_quantize_topk_mma_grid(
            n, n_embed, k, ctypes.byref(grid)),
            "sizing the quantize_topk_mma launch")
    return grid.value


def _kernel_device(flat: torch.Tensor) -> None:
    """Raise for a device no kernel runs on: anything but CUDA (the
    general route's limits are the shared-memory checks of :func:`_grid`
    and :func:`_check_stats`)."""
    if flat.device.type != "cuda":
        raise ValueError(f"no kernel for device {flat.device}")


def _cuda_core_scratch(embed: torch.Tensor, nbytes: int) -> torch.Tensor:
    """The general route's scratch, ``nbytes`` from :func:`_grid`: the
    codebook's bf16 parts in the stages the kernel streams, each with its
    codewords' squared norms and scales, a codeword-major float32 copy for
    the gather (both written by the kernels' prologue), and for k > 16 the
    running lists that do not fit shared memory."""
    return torch.empty((nbytes,), dtype=torch.uint8, device=embed.device)


def _route(flat: torch.Tensor, n_embed: int, k: int,
           route: Optional[str]) -> str:
    """The route a wrapper takes: ``route`` if given and allowed, else
    :func:`lookup_route`'s.  The CUDA-core kernels may be asked for any
    input; a tensor-core route the rule would not give raises."""
    dim = flat.shape[1]
    rule = lookup_route(flat.dtype, dim, n_embed, k)
    if route is None:
        return rule
    if route not in ROUTES or (route == TENSOR_CORE and rule != route):
        raise ValueError(f"route {route!r} does not take {flat.dtype} "
                         f"latents of width {dim}, n_embed {n_embed}, k {k}")
    return route


def _check_aligned(flat: torch.Tensor) -> None:
    if flat.data_ptr() % 16:
        raise ValueError("the tensor-core kernel needs flat's data "
                         "16-byte aligned")


def quantize_topk_fused(flat: torch.Tensor, embed: torch.Tensor, k: int,
                        route: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused distance + top-k + gather.

    Args:
      flat: (N, dim) latents, float32 or bfloat16, contiguous.
      embed: (dim, n_embed) float32 codebook, contiguous, same device.
      k: codewords per row.
      route: the kernel for a CUDA launch, ``TENSOR_CORE`` or
        ``CUDA_CORE`` (the general route); by default :func:`lookup_route`
        decides.  The general route takes any width, any n_embed and any
        k <= n_embed.  Asking for the tensor-core kernel where the rule
        would not give it raises.

    Returns:
      ``(q_topk (N, k*dim) f32, q1 (N, dim) f32, top1_idx (N,) int32)``.
    """
    _check(flat, embed, k)
    n, dim = flat.shape
    n_embed = embed.shape[1]
    route = _route(flat, n_embed, k, route)
    if flat.device.type == "cpu":
        return quantize_topk_fused_ref(flat, embed, k)
    _kernel_device(flat)
    q_topk = torch.empty((n, k * dim), dtype=torch.float32, device=flat.device)
    q1 = torch.empty((n, dim), dtype=torch.float32, device=flat.device)
    idx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    if n == 0:
        return q_topk, q1, idx
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    if route == TENSOR_CORE:
        _check_aligned(flat)
        lib = _mma_library()
        grid = _mma_grid(flat.device.index, n, n_embed, k)
        with torch.cuda.device(flat.device):
            err = lib.ammc_quantize_topk_mma(
                flat.data_ptr(), embed.data_ptr(), q_topk.data_ptr(),
                q1.data_ptr(), idx.data_ptr(), grid, n, n_embed, k, stream)
    else:
        lib = _library()
        bf16 = flat.dtype == torch.bfloat16
        grid, nbytes = _grid(flat.device.index, bf16, n, dim, n_embed, k)
        scratch = _cuda_core_scratch(embed, nbytes)
        with torch.cuda.device(flat.device):
            err = lib.ammc_quantize_topk(
                flat.data_ptr(), int(bf16), embed.data_ptr(),
                scratch.data_ptr(), q_topk.data_ptr(), q1.data_ptr(),
                idx.data_ptr(), grid, n, dim, n_embed, k, stream)
    _raise_on(lib, err, f"quantize_topk kernel launch ({route})")
    quantize_topk_fused.launches += 1
    quantize_topk_fused.launches_by_route[route] += 1
    return q_topk, q1, idx


quantize_topk_fused.launches = 0  # the sum over routes
quantize_topk_fused.launches_by_route = dict.fromkeys(ROUTES, 0)


def quantize_topk_train_fused(
        flat: torch.Tensor, embed: torch.Tensor, k: int,
        route: Optional[str] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Fused distance + top-k + gather + EMA statistics (kernel B2).

    Args: as :func:`quantize_topk_fused`, ``route`` and its rule included.
    On either route the lookup is B1's kernel of that route, so ``q_topk``,
    ``q1`` and ``top1_idx`` are bitwise B1's on the same input and route.
    The general route's statistics kernel raises ``ValueError`` naming
    shared memory past a width of about 8,100 (float32 latents) on an
    H100.

    Returns:
      ``(q_topk (N, k*dim) f32, q1 (N, dim) f32, top1_idx (N,) int32,
      counts (n_embed,) f32, embed_sum (dim, n_embed) f32)``; the statistics
      are bitwise equal across calls on the same input and route.
    """
    _check(flat, embed, k)
    n, dim = flat.shape
    n_embed = embed.shape[1]
    route = _route(flat, n_embed, k, route)
    if flat.device.type == "cpu":
        return quantize_topk_train_fused_ref(flat, embed, k)
    _kernel_device(flat)
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == TENSOR_CORE:
        _check_aligned(flat)
        lib = _mma_library()
        grid = _mma_grid(dev.index, n, n_embed, k)
        with torch.cuda.device(dev):
            err = lib.ammc_quantize_topk_mma_train(
                flat.data_ptr(), embed.data_ptr(), q_topk.data_ptr(),
                q1.data_ptr(), idx.data_ptr(), counts.data_ptr(),
                embed_sum.data_ptr(), grid, n, n_embed, k, stream)
    else:
        lib = _library()
        bf16 = flat.dtype == torch.bfloat16
        _check_stats(dev.index, bf16, dim)
        grid, nbytes = _grid(dev.index, bf16, n, dim, n_embed, k)  # B1's
        scratch = _cuda_core_scratch(embed, nbytes)
        with torch.cuda.device(dev):
            err = lib.ammc_quantize_topk_train(
                flat.data_ptr(), int(bf16), embed.data_ptr(),
                scratch.data_ptr(), q_topk.data_ptr(), q1.data_ptr(),
                idx.data_ptr(), counts.data_ptr(), embed_sum.data_ptr(), grid,
                n, dim, n_embed, k, stream)
    _raise_on(lib, err, f"quantize_topk_train kernel launch ({route})")
    quantize_topk_train_fused.launches += 1
    quantize_topk_train_fused.launches_by_route[route] += 1
    return q_topk, q1, idx, counts, embed_sum


quantize_topk_train_fused.launches = 0  # the sum over routes
quantize_topk_train_fused.launches_by_route = dict.fromkeys(ROUTES, 0)
