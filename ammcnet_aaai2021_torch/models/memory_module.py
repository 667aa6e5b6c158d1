"""Memory blocks around the functional memory op (NCHW shapes, either layout).

Port of ``ammcnet_aaai2021_tpu/models/memory_module.py`` (reference
``Code/models/unet.py:267-331,379-387``, ``Quantize_topk`` /
``enc_quan_dec_topk`` / ``enc_quan_dec_res_topk``): a 1x1 conv squeezes the
trunk channels to ``embed_dim``, the top-k quantizer addresses the codebook,
and a 1x1 conv expands ``k * embed_dim`` back, optionally with a residual
connection around the whole block.  The codebook (``embed``,
``cluster_size``, ``embed_avg``) is a set of float32 buffers, as in the
reference; in training mode each forward applies the EMA update to them in
place (the JAX package threads them through its step as mutable state),
through ``blocks.write_buffers``, which a remat step defers until after its
backward pass (its rerun forward takes the inference lookup and writes
nothing).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..ops.memory import Codebook, quantize_topk
from .blocks import Conv2d, is_channels_last, is_recomputing, write_buffers


class TopKMemory(nn.Module):
    """The quantizer (reference Quantize_topk, unet.py:267-313; with
    ``st_mode="topk"`` the VQ-VAE family's, vqvae.py:283-319, see
    :func:`~..ops.memory.quantize_topk`).  Takes and returns NCHW shapes;
    the op itself runs channel-last, so a channels-last input goes to it
    without a copy, and ``q_topk`` comes back in the input's layout.  In
    training mode the lookup reads the codebook as it was before the
    forward, and the EMA update is then written into the buffers under
    ``no_grad``.  ``group`` (None by
    default; set by ``models.set_process_group``): the EMA statistics are
    summed over this process group's ranks first."""

    group = None

    def __init__(self, embed_dim: int, n_embed: int, k: int = 1,
                 use_kernel: bool = False, per_sample_diff: bool = False,
                 decay: float = 0.99, eps: float = 1e-5,
                 st_mode: str = "top1"):
        super().__init__()
        self.embed_dim, self.n_embed, self.k = embed_dim, n_embed, k
        self.decay, self.eps = decay, eps
        self.use_kernel = use_kernel
        self.per_sample_diff = per_sample_diff
        self.st_mode = st_mode
        embed = torch.randn(embed_dim, n_embed)
        self.register_buffer("embed", embed)
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", embed.clone())

    def forward(self, z: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cb = Codebook(self.embed, self.cluster_size, self.embed_avg)
        # a remat step's rerun needs the lookup only, not the EMA statistics:
        # the inference lookup (B1), whose indices are B2's
        update = self.training and not is_recomputing()
        q_topk, diff, q_st, new_cb = quantize_topk(
            z.permute(0, 2, 3, 1), cb, self.k, train=update,
            decay=self.decay, eps=self.eps, use_kernel=self.use_kernel,
            st_mode=self.st_mode, per_sample=self.per_sample_diff,
            group=self.group)
        if update:
            write_buffers(((self.embed, new_cb.embed),
                           (self.cluster_size, new_cb.cluster_size),
                           (self.embed_avg, new_cb.embed_avg)))
        layout = (torch.channels_last if is_channels_last(z)
                  else torch.contiguous_format)
        return (q_topk.permute(0, 3, 1, 2).contiguous(memory_format=layout),
                diff, q_st.permute(0, 3, 1, 2))


class EncQuanDecTopK(nn.Module):
    """1x1 conv -> quantize -> 1x1 conv (reference enc_quan_dec_topk)."""

    def __init__(self, in_features: int, embed_dim: int, n_embed: int,
                 k: int = 1, use_kernel: bool = False,
                 per_sample_diff: bool = False):
        super().__init__()
        self.enc = Conv2d(in_features, embed_dim, 1)
        self.quantize = TopKMemory(embed_dim, n_embed, k, use_kernel,
                                   per_sample_diff)
        self.dec = Conv2d(k * embed_dim, in_features, 1)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        z = self.enc(x)
        q_topk, diff, q_st = self.quantize(z)
        # q_topk comes back in z's (the compute) dtype
        return self.dec(q_topk), diff, q_st


class EncQuanDecResTopK(nn.Module):
    """Residual wrapper: out += x (reference enc_quan_dec_res_topk)."""

    def __init__(self, in_features: int, embed_dim: int, n_embed: int,
                 k: int = 1, use_kernel: bool = False,
                 per_sample_diff: bool = False):
        super().__init__()
        self.quan = EncQuanDecTopK(in_features, embed_dim, n_embed, k,
                                   use_kernel, per_sample_diff)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        out, diff, q_st = self.quan(x)
        return out + x, diff, q_st
