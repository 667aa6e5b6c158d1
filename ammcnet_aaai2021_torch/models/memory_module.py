"""Memory blocks around the functional memory op (NCHW).

Port of ``ammcnet_aaai2021_tpu/models/memory_module.py`` (reference
``Code/models/unet.py:267-331,379-387``, ``Quantize_topk`` /
``enc_quan_dec_topk`` / ``enc_quan_dec_res_topk``): a 1x1 conv squeezes the
trunk channels to ``embed_dim``, the top-k quantizer addresses the codebook,
and a 1x1 conv expands ``k * embed_dim`` back, optionally with a residual
connection around the whole block.  The codebook (``embed``,
``cluster_size``, ``embed_avg``) is a set of float32 buffers, as in the
reference; in training mode each forward applies the EMA update to them in
place (the JAX package threads them through its step as mutable state).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..ops.memory import Codebook, quantize_topk
from .blocks import Conv2d


class TopKMemory(nn.Module):
    """The quantizer (reference Quantize_topk, unet.py:267-313).  Takes and
    returns NCHW; the op itself runs channel-last.  In training mode the
    lookup reads the codebook as it was before the forward, and the EMA
    update is then written into the buffers under ``no_grad``."""

    def __init__(self, embed_dim: int, n_embed: int, k: int = 1,
                 use_kernel: bool = False, per_sample_diff: bool = False,
                 decay: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.embed_dim, self.n_embed, self.k = embed_dim, n_embed, k
        self.decay, self.eps = decay, eps
        self.use_kernel = use_kernel
        self.per_sample_diff = per_sample_diff
        embed = torch.randn(embed_dim, n_embed)
        self.register_buffer("embed", embed)
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", embed.clone())

    def forward(self, z: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cb = Codebook(self.embed, self.cluster_size, self.embed_avg)
        q_topk, diff, q_st, new_cb = quantize_topk(
            z.permute(0, 2, 3, 1), cb, self.k, train=self.training,
            decay=self.decay, eps=self.eps, use_kernel=self.use_kernel,
            per_sample=self.per_sample_diff)
        if self.training:
            with torch.no_grad():
                self.embed.copy_(new_cb.embed)
                self.cluster_size.copy_(new_cb.cluster_size)
                self.embed_avg.copy_(new_cb.embed_avg)
        return (q_topk.permute(0, 3, 1, 2).contiguous(), diff,
                q_st.permute(0, 3, 1, 2))


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
