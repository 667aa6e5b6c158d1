"""Top-k discrete memory addressing (VQ-VAE-style codebook quantizer),
inference branches.

Port of ``ammcnet_aaai2021_tpu/ops/memory.py`` (reference
``Code/models/unet.py:267-331`` ``Quantize_topk``): L2-nearest-codeword
lookup over ``n_embed`` codewords of dim ``embed_dim``, top-k codewords
gathered and channel-concatenated, straight-through estimator, and the
commit distance ``mean((sg[q] - z)^2)``.  Layout is the JAX package's:
``z`` is ``(..., dim)`` channel-last.

The EMA codebook update (``train=True``, ``ema_apply``/``ema_update``) and
its fused kernel come with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .memory_kernels import exact_fp32_matmul, quantize_topk_fused, topk_smallest


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


def quantize_topk(
    z: torch.Tensor,
    codebook: Codebook,
    k: int,
    *,
    train: bool = False,
    use_kernel: bool = False,
    st_mode: str = "top1",
    per_sample: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Codebook]:
    """Top-k memory addressing (inference).

    Args:
      z: ``(..., dim)`` latent.
      codebook: current :class:`Codebook` state.
      k: number of nearest codewords gathered and channel-concatenated.
      train: must be False here; the EMA update is the training slice's.
      use_kernel: fuse distance + top-k + gather into the CUDA kernel
        (:func:`~.memory_kernels.quantize_topk_fused`), where the JAX package
        takes its Pallas kernel.
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
      straight-through top-1 quantization, and the unchanged codebook.
    """
    if st_mode not in ("top1", "topk"):
        raise ValueError(f"unknown st_mode {st_mode!r}")
    if train:
        raise NotImplementedError(
            "quantize_topk(train=True): the EMA codebook update comes with "
            "the training slice of the port")
    dim = codebook.embed.shape[0]
    lead_shape = z.shape[:-1]
    flat = z.reshape(-1, dim)

    if use_kernel:
        # the lookup carries no gradient (indices are integers, the codebook
        # is a buffer), so the kernel takes detached inputs
        q_topk_flat, q1_flat, _ = quantize_topk_fused(
            flat.detach().contiguous(), codebook.embed, k)
    else:
        dist = codebook_distances(flat, codebook.embed)
        topk_idx = topk_smallest(dist, k)
        embed_t = codebook.embed.float().t()
        q_topk_flat = embed_t[topk_idx].reshape(-1, k * dim)
        q1_flat = embed_t[topk_idx[:, 0]]

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

    q_topk = q_out_flat.reshape(*lead_shape, k * dim).to(z.dtype)
    q_st = q_st_flat.reshape(*lead_shape, dim).to(z.dtype)
    return q_topk, diff, q_st, codebook
