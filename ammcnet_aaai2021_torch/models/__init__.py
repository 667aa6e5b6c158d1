"""Model factory: net_tag string -> generator module.

Port of ``ammcnet_aaai2021_tpu/models/__init__.py``: every runnable tag of
the reference's net_map builds, as in the JAX package.

====================  =========================================================
net_tag               module
====================  =========================================================
unet                  plain UNet (:class:`~.blocks.UNet`)
unet_vq_topk_res      :class:`UNetMemStream` (UNetMem_v7, the stage-1 net)
unet_vq_twostream     :class:`TwoStreamUNetMem` (the released generator)
twostream_concat_dire as shipped, the same net: the reference wires the
                      additive AMFT bridge into both (unet.py:1043)
vqvae                 :class:`~.vqvae.VQVAE`
vqvae_topk            :class:`~.vqvae.VQVAETopK`
vqvae_topk_res        :class:`~.vqvae.VQVAETopKRes`
vqvae_twostream       :class:`~.vqvae.VQVAETopKTwoStream`
====================  =========================================================

A single-stream net takes the (rgb, op) entry of ``in_channel`` and
``out_channel`` that matches ``cfg.data_type`` (rgb, or rgb_op: 4x3
channels in, 3 out; op: 3x2 in, 2 out); a two-stream net takes both.  The
four tags that dispatch to non-runnable reference classes raise
``ValueError`` as in the JAX package.  :class:`UNetMemV4` and the
concat/add bridges (``TwoStreamUNetMem(bridge_kind=...)``) are built by
hand, as there.  ``build_model(cfg, "training")`` also returns the PatchGAN
discriminator (on the two-stream net's RGB prediction, or on a
single-stream net's own channels) and the FlowNet2-SD teacher
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
    UNet,
    Up,
)
from .discriminator import PixelDiscriminator
from .flownet2 import FlowNet2
from .flownet_sd import FlowNet2SD, FlowNetSD
from .memory_module import EncQuanDecResTopK, EncQuanDecTopK, TopKMemory
from .unet_mem import (
    AddBridge,
    AMFTBridge,
    ConcatBridge,
    TwoStreamUNetMem,
    UNetMemStream,
    UNetMemV4,
)
from .vqvae import (
    VQVAE,
    VQMemory,
    VQVAETopK,
    VQVAETopKRes,
    VQVAETopKTwoStream,
    bridge_only_mask,
)

__all__ = [
    "BatchNorm2d", "Conv2d", "ConvTranspose2d", "DoubleConv", "InConv",
    "Down", "Up", "UNet", "TopKMemory", "EncQuanDecTopK",
    "EncQuanDecResTopK", "UNetMemStream", "UNetMemV4", "AMFTBridge",
    "ConcatBridge", "AddBridge", "TwoStreamUNetMem", "VQMemory", "VQVAE",
    "VQVAETopK", "VQVAETopKRes", "VQVAETopKTwoStream", "bridge_only_mask",
    "PixelDiscriminator", "FlowNetSD", "FlowNet2SD", "FlowNet2",
    "build_generator",
    "build_model", "init_weights", "init_flownet_weights", "Model",
    "NET_TAGS", "TWO_STREAM_TAGS", "set_process_group",
]

# runnable reference tags (the reference's net_map minus its four entries
# that dispatch to non-runnable dead code)
NET_TAGS = (
    "unet", "unet_vq_topk_res", "unet_vq_twostream",
    "twostream_concat_dire",
    "vqvae", "vqvae_topk", "vqvae_topk_res", "vqvae_twostream",
)
# the tags whose generator takes an rgb and an op clip
TWO_STREAM_TAGS = ("unet_vq_twostream", "twostream_concat_dire",
                   "vqvae_twostream")


def _single(cfg: NetConfig, channels: Tuple[int, int]) -> int:
    """The rgb or op entry of an (rgb, op) channel pair: single-stream nets
    read the one matching their data_type (JAX ``_single_out``)."""
    return channels[1] if cfg.data_type == "op" else channels[0]


def set_process_group(model: nn.Module, group) -> nn.Module:
    """Set ``group`` on every BatchNorm and memory of ``model`` (a
    ``torch.distributed`` process group, or None for a single process):
    their training mode then reduces its statistics over the group's
    global batch.  Returns ``model``."""
    for m in model.modules():
        if isinstance(m, (BatchNorm2d, TopKMemory)):
            m.group = group
    return model


def build_generator(cfg: NetConfig, per_sample_diff: bool = False,
                    group=None) -> nn.Module:
    """net_tag -> constructed generator (reference net_map dispatch).

    ``per_sample_diff=True`` makes the UNet family's memory blocks emit
    per-frame commit distances (for the scorer) instead of batch-mean
    scalars; the VQ-VAE nets have none, as in the JAX package.
    ``group`` (JAX ``axis_name``): a process group whose ranks each train
    on a shard of the batch (:func:`set_process_group`).
    """
    return set_process_group(_build_generator(cfg, per_sample_diff), group)


def _build_generator(cfg: NetConfig, per_sample_diff: bool) -> nn.Module:
    tag = cfg.net_tag
    dtype = getattr(torch, cfg.dtype)
    in_ch, out_ch = _single(cfg, cfg.in_channel), _single(cfg, cfg.out_channel)
    vq = dict(embed_dim=cfg.embed_dim, n_embed=cfg.n_embed, k=cfg.k,
              use_kernel=cfg.use_memory_kernel, dtype=dtype)
    if tag == "unet":
        return UNet(in_ch, out_ch, dtype=dtype)
    if tag == "unet_vq_topk_res":
        return UNetMemStream(in_ch, out_ch, per_sample_diff=per_sample_diff,
                             **vq)
    if tag in ("unet_vq", "unet_vq_res", "unet_vq_topk",
               "twostream_add_dire"):
        # UNetMem_v1/v2/v3 and twostream_add_dire are non-runnable in the
        # reference (tuple-called outc, unet.py:349; undefined `diff`,
        # unet.py:1125) — fail loudly rather than guess semantics
        raise ValueError(
            f"net_tag {tag!r} maps to a non-runnable reference class; "
            "use unet_vq_topk_res / unet_vq_twostream (or UNetMemV4 / the "
            "bridge_kind ablations programmatically)")
    two = dict(rgb_in=cfg.in_channel[0], op_in=cfg.in_channel[1],
               rgb_out=cfg.out_channel[0], op_out=cfg.out_channel[1], **vq)
    if tag in ("unet_vq_twostream", "twostream_concat_dire"):
        return TwoStreamUNetMem(per_sample_diff=per_sample_diff, **two)
    if tag == "vqvae":
        return VQVAE(in_ch, out_ch, **vq)
    if tag == "vqvae_topk":
        return VQVAETopK(in_ch, out_ch, **vq)
    if tag == "vqvae_topk_res":
        return VQVAETopKRes(in_ch, out_ch, **vq)
    if tag == "vqvae_twostream":
        return VQVAETopKTwoStream(**two)
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
    """Seeded random FlowNet2-SD or FlowNet 2.0 weights, for runs without a
    checkpoint: flax's default conv init (LeCun normal, std
    ``1/sqrt(fan_in)``, here untruncated), biases zero (FlowNetS's
    bias-free flow upsamplers have none)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           / math.sqrt(fan_in))
            if m.bias is not None:
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
                per_sample_diff: bool = False, with_flow: bool = True,
                group=None) -> Model:
    """The generator, and in training mode the discriminator (on the
    two-stream net's RGB prediction, or on a single-stream net's own
    channels) and, with ``with_flow`` (the loss tags with a flow term), the
    FlowNet2-SD teacher.  ``group`` as in :func:`build_generator` (the
    discriminator holds no BatchNorm, and the teacher runs in eval mode)."""
    gen = build_generator(cfg, per_sample_diff, group)
    if mode != "training":
        return Model(generator=gen)
    dtype = getattr(torch, cfg.dtype)
    d_in = (cfg.out_channel[0] if cfg.net_tag in TWO_STREAM_TAGS
            else _single(cfg, cfg.out_channel))
    return Model(generator=gen,
                 discriminator=PixelDiscriminator(DISC_FILTERS, d_in,
                                                  dtype=dtype),
                 flow_network=FlowNet2SD(dtype=dtype) if with_flow else None)
