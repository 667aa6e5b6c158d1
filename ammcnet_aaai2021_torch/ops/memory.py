"""Top-k discrete memory addressing (VQ-VAE-style codebook quantizer).

Port of ``ammcnet_aaai2021_tpu/ops/memory.py`` (reference
``Code/models/unet.py:267-331`` ``Quantize_topk``): L2-nearest-codeword
lookup over ``n_embed`` codewords of dim ``embed_dim``, top-k codewords
gathered and channel-concatenated, the EMA codebook update (decay 0.99,
Laplace-smoothed cluster sizes) in training, straight-through estimator, and
the commit distance ``mean((sg[q] - z)^2)``.  Layout is the JAX package's:
``z`` is ``(..., dim)`` channel-last.

The lookup carries no gradient (indices are integers, the codebook is a
buffer); the encoder's only gradient from this op is the commit distance's.
The EMA statistics of a training lookup come from kernel B2
(:func:`~.memory_kernels.quantize_topk_train_fused`) where the JAX package
takes its Pallas training kernel, else from :func:`ema_update`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .memory_kernels import (
    exact_fp32_matmul,
    quantize_topk_fused,
    quantize_topk_train_fused,
    topk_smallest,
)


class Codebook(NamedTuple):
    """EMA codebook state (reference registers these as buffers, unet.py:276-280)."""

    embed: torch.Tensor  # (dim, n_embed) float32
    cluster_size: torch.Tensor  # (n_embed,) float32
    embed_avg: torch.Tensor  # (dim, n_embed) float32


def codebook_distances(flat: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances ``(N, n_embed)`` via the expanded quadratic form
    ``||z||^2 - 2 z.E + ||E||^2``, in full fp32 (TF32 would flip near-tie
    argmins)."""
    flat = flat.float()
    embed = embed.float()
    z_sq = (flat * flat).sum(1, keepdim=True)
    e_sq = (embed * embed).sum(0, keepdim=True)
    with exact_fp32_matmul():
        cross = flat @ embed
    return z_sq - 2.0 * cross + e_sq


@torch.no_grad()
def ema_apply(codebook: Codebook, counts: torch.Tensor,
              embed_sum: torch.Tensor, decay: float = 0.99, eps: float = 1e-5,
              axis_name: Optional[str] = None) -> Codebook:
    """Apply the EMA + Laplace smoothing given the batch statistics
    (unet.py:298-309).  ``axis_name`` (the statistics' all-reduce across
    data-parallel processes) comes with the multi-process slice."""
    if axis_name is not None:
        raise NotImplementedError(
            "ema_apply(axis_name=...): reducing the EMA statistics across "
            "processes comes with the multi-process slice of the port")
    n_embed = codebook.embed.shape[1]
    cluster_size = codebook.cluster_size * decay + (1.0 - decay) * counts
    embed_avg = codebook.embed_avg * decay + (1.0 - decay) * embed_sum
    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + n_embed * eps) * n
    embed = embed_avg / smoothed[None, :]
    return Codebook(embed=embed, cluster_size=cluster_size,
                    embed_avg=embed_avg)


@torch.no_grad()
def ema_update(codebook: Codebook, flat: torch.Tensor,
               top1_idx: torch.Tensor, decay: float = 0.99,
               eps: float = 1e-5, axis_name: Optional[str] = None
               ) -> Codebook:
    """EMA update computing the one-hot statistics from indices (the plain
    path), in fp32 with TF32 off."""
    n_embed = codebook.embed.shape[1]
    one_hot = torch.nn.functional.one_hot(
        top1_idx.long(), n_embed).to(torch.float32)
    with exact_fp32_matmul():
        embed_sum = flat.float().t() @ one_hot
    return ema_apply(codebook, one_hot.sum(0), embed_sum, decay, eps,
                     axis_name)


def quantize_topk(
    z: torch.Tensor,
    codebook: Codebook,
    k: int,
    *,
    train: bool = False,
    decay: float = 0.99,
    eps: float = 1e-5,
    use_kernel: bool = False,
    st_mode: str = "top1",
    per_sample: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Codebook]:
    """Top-k memory addressing.

    Args:
      z: ``(..., dim)`` latent.
      codebook: current :class:`Codebook` state.
      k: number of nearest codewords gathered and channel-concatenated.
      train: also return the EMA-updated codebook (reference gates on
        ``self.training``); the lookup reads the codebook as given.
      decay, eps: the EMA decay and the Laplace smoothing.
      use_kernel: fuse the lookup into a CUDA kernel where the JAX package
        takes its Pallas kernel: B2
        (:func:`~.memory_kernels.quantize_topk_train_fused`, which also
        returns the EMA statistics) when ``train and st_mode == "top1"``, B1
        (:func:`~.memory_kernels.quantize_topk_fused`) when not ``train``.
      st_mode: ``"top1"`` (``Code/models/unet.py:282-313``): the gather is a
        pure lookup and the commit distance is against the top-1 codeword.
        ``"topk"`` (``Code/models/vqvae.py:283-319``): the input is tiled k
        times, the straight-through estimator covers the whole top-k output
        and the commit distance compares all k codewords.
      per_sample: commit distance per leading-axis element instead of the
        scalar mean.

    Returns:
      ``(q_topk, diff, q_st, codebook)`` — ``q_topk`` is ``(..., k*dim)`` in
      ``z``'s dtype, ``diff`` the commit distance (f32), ``q_st`` the
      straight-through top-1 quantization, and the EMA-updated codebook
      (new tensors; the given one is untouched) if ``train``, else the given
      codebook.
    """
    if st_mode not in ("top1", "topk"):
        raise ValueError(f"unknown st_mode {st_mode!r}")
    dim = codebook.embed.shape[0]
    lead_shape = z.shape[:-1]
    flat = z.reshape(-1, dim)
    # the lookup carries no gradient (indices are integers, the codebook is a
    # buffer), so the kernels take detached inputs
    flat_ng = flat.detach()

    ema_stats = None
    if use_kernel and train and st_mode == "top1":
        q_topk_flat, q1_flat, top1_idx, counts, embed_sum = (
            quantize_topk_train_fused(flat_ng.contiguous(), codebook.embed, k))
        ema_stats = (counts, embed_sum)
    elif use_kernel and not train:
        q_topk_flat, q1_flat, top1_idx = quantize_topk_fused(
            flat_ng.contiguous(), codebook.embed, k)
    else:
        dist = codebook_distances(flat_ng, codebook.embed)
        topk_idx = topk_smallest(dist, k)
        top1_idx = topk_idx[:, 0]
        embed_t = codebook.embed.float().t()
        q_topk_flat = embed_t[topk_idx].reshape(-1, k * dim)
        q1_flat = embed_t[top1_idx]

    def _diff(sq_err: torch.Tensor) -> torch.Tensor:
        if not per_sample:
            return sq_err.mean()
        per_elem = sq_err.reshape(lead_shape[0], -1) if lead_shape else sq_err
        return per_elem.mean(dim=-1)

    zf = flat.float()
    if st_mode == "top1":
        diff = _diff((q1_flat.detach() - zf).square()
                     .reshape(*lead_shape, dim))
        q_out_flat = q_topk_flat
    else:
        z_tiled = zf.repeat(1, k)  # input.repeat(1,1,1,k), vqvae.py:312
        diff = _diff((q_topk_flat.detach() - z_tiled).square()
                     .reshape(*lead_shape, k * dim))
        q_out_flat = z_tiled + (q_topk_flat - z_tiled).detach()
    q_st_flat = zf + (q1_flat - zf).detach()

    new_codebook = codebook
    if train:
        if ema_stats is not None:
            new_codebook = ema_apply(codebook, *ema_stats, decay=decay,
                                     eps=eps)
        else:
            new_codebook = ema_update(codebook, flat_ng, top1_idx,
                                      decay=decay, eps=eps)

    q_topk = q_out_flat.reshape(*lead_shape, k * dim).to(z.dtype)
    q_st = q_st_flat.reshape(*lead_shape, dim).to(z.dtype)
    return q_topk, diff, q_st, new_codebook
