"""Model factory: net_tag string -> generator module.

Port of ``ammcnet_aaai2021_tpu/models/__init__.py``.
``unet_vq_twostream`` and its as-shipped alias ``twostream_concat_dire``
(the reference wires the same additive AMFT bridge into both,
unet.py:1043) build :class:`TwoStreamUNetMem`; ``unet_vq_topk_res`` builds
the stage-1 single-stream :class:`UNetMemStream` for ``cfg.data_type``
(rgb: 4x3 channels in, 3 out; op: 3x2 in, 2 out).  The four tags that
dispatch to non-runnable reference classes raise ``ValueError`` as in the
JAX package; the other runnable tags come with the model-family slice.
``build_model(cfg, "training")`` also returns the PatchGAN discriminator
(on the c-channel prediction) and the FlowNet2-SD teacher
(models/__init__.py:140-152).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..configs import DISC_FILTERS, NetConfig
from .blocks import (
    BatchNorm2d,
    ConvTranspose2d,
    Conv2d,
    DoubleConv,
    Down,
    InConv,
    Up,
)
from .discriminator import PixelDiscriminator
from .flownet_sd import FlowNet2SD, FlowNetSD
from .memory_module import EncQuanDecResTopK, EncQuanDecTopK, TopKMemory
from .unet_mem import AMFTBridge, TwoStreamUNetMem, UNetMemStream

__all__ = [
    "BatchNorm2d", "Conv2d", "ConvTranspose2d", "DoubleConv", "InConv",
    "Down", "Up", "TopKMemory", "EncQuanDecTopK", "EncQuanDecResTopK",
    "UNetMemStream", "AMFTBridge", "TwoStreamUNetMem", "PixelDiscriminator",
    "FlowNetSD", "FlowNet2SD", "build_generator", "build_model",
    "init_weights", "init_flownet_weights", "Model", "NET_TAGS",
]

# runnable reference tags (the reference's net_map minus its four entries
# that dispatch to non-runnable dead code)
NET_TAGS = (
    "unet", "unet_vq_topk_res", "unet_vq_twostream",
    "twostream_concat_dire",
    "vqvae", "vqvae_topk", "vqvae_topk_res", "vqvae_twostream",
)


def _single(cfg: NetConfig, channels: Tuple[int, int]) -> int:
    """The rgb or op entry of an (rgb, op) channel pair: single-stream nets
    read the one matching their data_type (JAX ``_single_out``)."""
    return channels[1] if cfg.data_type == "op" else channels[0]


def build_generator(cfg: NetConfig, per_sample_diff: bool = False
                    ) -> nn.Module:
    """net_tag -> constructed generator (reference net_map dispatch).

    ``per_sample_diff=True`` makes the memory blocks emit per-frame commit
    distances (for the scorer) instead of batch-mean scalars.
    """
    tag = cfg.net_tag
    if tag == "unet_vq_topk_res":
        return UNetMemStream(
            _single(cfg, cfg.in_channel), _single(cfg, cfg.out_channel),
            cfg.embed_dim, cfg.n_embed, cfg.k, cfg.use_memory_kernel,
            per_sample_diff, dtype=getattr(torch, cfg.dtype))
    if tag in ("unet_vq", "unet_vq_res", "unet_vq_topk",
               "twostream_add_dire"):
        # UNetMem_v1/v2/v3 and twostream_add_dire are non-runnable in the
        # reference (tuple-called outc, unet.py:349; undefined `diff`,
        # unet.py:1125) — fail loudly rather than guess semantics
        raise ValueError(
            f"net_tag {tag!r} maps to a non-runnable reference class; "
            "use unet_vq_topk_res / unet_vq_twostream")
    if tag in ("unet_vq_twostream", "twostream_concat_dire"):
        return TwoStreamUNetMem(
            rgb_in=cfg.in_channel[0], op_in=cfg.in_channel[1],
            rgb_out=cfg.out_channel[0], op_out=cfg.out_channel[1],
            embed_dim=cfg.embed_dim, n_embed=cfg.n_embed, k=cfg.k,
            dtype=getattr(torch, cfg.dtype), use_kernel=cfg.use_memory_kernel,
            per_sample_diff=per_sample_diff)
    if tag in NET_TAGS:
        raise NotImplementedError(
            f"net_tag {tag!r} comes with the model-family slice of the port")
    raise ValueError(f"unknown net_tag {tag!r}")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization mirroring the JAX package's flax init: every
    conv kernel normal(0, 0.02) (reference utils.py:328-334), biases zero,
    BatchNorm scale 1 / shift 0 with fresh running statistics, codebooks
    standard normal with ``embed_avg`` a copy and zero cluster sizes.
    Draws come from ``generator``, in module order, on the CPU."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * 0.02)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, TopKMemory):
            m.embed.copy_(torch.randn(m.embed.shape, generator=generator))
            m.embed_avg.copy_(m.embed)
            m.cluster_size.zero_()
    return model


@torch.no_grad()
def init_flownet_weights(model: nn.Module, generator: torch.Generator
                         ) -> nn.Module:
    """Seeded random FlowNet2-SD weights, for runs without a checkpoint:
    flax's default conv init (LeCun normal, std ``1/sqrt(fan_in)``, here
    untruncated), biases zero."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(fan_in))
            m.bias.zero_()
    return model


@dataclass
class Model:
    """Holder mirroring the reference Model struct (models/__init__.py:149):
    generator + (training-only) discriminator and frozen flow teacher."""

    generator: nn.Module
    discriminator: Optional[PixelDiscriminator] = None
    flow_network: Optional[FlowNet2SD] = None


def build_model(cfg: NetConfig, mode: str = "testing",
                per_sample_diff: bool = False, with_flow: bool = True
                ) -> Model:
    """The generator, and in training mode the discriminator (on the RGB
    prediction, or on a single-stream net's own c channels) and, with
    ``with_flow`` (the loss tags with a flow term), the FlowNet2-SD
    teacher."""
    gen = build_generator(cfg, per_sample_diff)
    if mode != "training":
        return Model(generator=gen)
    dtype = getattr(torch, cfg.dtype)
    d_in = 3
    if cfg.net_tag == "unet_vq_topk_res":
        d_in = _single(cfg, cfg.out_channel)
    return Model(generator=gen,
                 discriminator=PixelDiscriminator(DISC_FILTERS, d_in,
                                                  dtype=dtype),
                 flow_network=FlowNet2SD(dtype=dtype) if with_flow else None)
