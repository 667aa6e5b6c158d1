"""VQ-VAE-2 generator family (stage-1-era and ablation nets, NCHW).

Port of ``ammcnet_aaai2021_tpu/models/vqvae.py`` (reference
``Code/models/vqvae.py``): the two-level (top + bottom) VQ-VAE with
stride-4 / stride-2 encoders, its ``_topk`` / ``_topk_res`` variants whose
memories use the VQ-VAE straight-through estimator (``st_mode="topk"``,
vqvae.py:283-319), and the ``_twostream`` variant with a ``middle_unet``
concat bridge at both levels.

Module and parameter names are the JAX package's flax names (``enc_b.conv0``,
``enc_b.res0.conv1``, ``quantize_t.enc``, ``upsample_t``, ``bridge_b.O2F``);
a memory's codebook sits in its ``quantize`` child, a
:class:`~.memory_module.TopKMemory`.  ``tools/weights.py:vqvae_state_from_jax``
carries JAX variables across.  Input channel counts are constructor
arguments (flax infers them).  Parameters stay float32 and the convolutions
run in the input's dtype; a net's forward first casts its input to
``dtype`` when one is given.  As in the JAX package, the decoders' outputs
are returned in the compute dtype, without a tanh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2d, ConvTranspose2d
from .memory_module import TopKMemory


def _up4x4(in_ch: int, out_ch: int) -> ConvTranspose2d:
    """flax ``ConvTranspose(4, 2, "SAME", transpose_kernel=True)``, which is
    torch's ``ConvTranspose2d(k=4, s=2, p=1)`` (JAX
    tests/test_models.py::test_conv_transpose_4x4_s2_p1)."""
    return ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1)


class ResBlock(nn.Module):
    """relu -> conv3x3 -> relu -> conv1x1, added to the input (vqvae.py:58-73).
    The input itself is not rectified: the ReLU is not in place."""

    def __init__(self, channels: int, res_channel: int):
        super().__init__()
        self.conv0 = Conv2d(channels, res_channel, 3, padding=1)
        self.conv1 = Conv2d(res_channel, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv1(F.relu(self.conv0(F.relu(x))))


class Encoder(nn.Module):
    """Strided conv encoder, stride 2, 4 or 8 (vqvae.py:75-114): 4x4
    stride-2 convolutions (padding 1), a 3x3, residual blocks, a ReLU."""

    def __init__(self, in_channel: int, channel: int, n_res_block: int,
                 n_res_channel: int, stride: int):
        super().__init__()
        if stride not in (2, 4, 8):
            raise ValueError(f"unsupported stride {stride}")
        c = channel
        widths = {2: [c // 2], 4: [c // 2, c], 8: [c // 2, c, c]}[stride]
        self.strided = len(widths)
        for i, (cin, cout) in enumerate(zip([in_channel] + widths, widths)):
            setattr(self, f"conv{i}", Conv2d(cin, cout, 4, stride=2,
                                             padding=1))
        setattr(self, f"conv{self.strided}",
                Conv2d(widths[-1], c, 3, padding=1))
        self.n_res_block = n_res_block
        for i in range(n_res_block):
            setattr(self, f"res{i}", ResBlock(c, n_res_channel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.strided):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = getattr(self, f"conv{self.strided}")(x)
        for i in range(self.n_res_block):
            x = getattr(self, f"res{i}")(x)
        return F.relu(x)


class Decoder(nn.Module):
    """conv3x3 -> residual blocks -> ReLU -> 4x4 transposed-conv upsampling
    by ``stride`` 2, 4 or 8 (vqvae.py:117-161); no activation after the
    last."""

    def __init__(self, in_channel: int, out_channel: int, channel: int,
                 n_res_block: int, n_res_channel: int, stride: int):
        super().__init__()
        if stride not in (2, 4, 8):
            raise ValueError(f"unsupported stride {stride}")
        c = channel
        self.conv_in = Conv2d(in_channel, c, 3, padding=1)
        self.n_res_block = n_res_block
        for i in range(n_res_block):
            setattr(self, f"res{i}", ResBlock(c, n_res_channel))
        widths = {2: [c, out_channel],
                  4: [c, c // 2, out_channel],
                  8: [c, c // 2, out_channel, out_channel]}[stride]
        self.n_up = len(widths) - 1
        for i in range(self.n_up):
            setattr(self, f"up{i}", _up4x4(widths[i], widths[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for i in range(self.n_res_block):
            x = getattr(self, f"res{i}")(x)
        x = F.relu(x)
        for i in range(self.n_up):
            x = getattr(self, f"up{i}")(x)
            if i + 1 < self.n_up:
                x = F.relu(x)
        return x


class VQMemory(nn.Module):
    """The VQ-VAE memory block: 1x1 ``enc`` to ``embed_dim``, the top-k
    lookup with the ``"topk"`` straight-through estimator, 1x1 ``dec`` back
    to ``embed_dim`` (vqvae.py:321-336).  ``residual_proj`` adds the
    ``enc_x`` 1x1 projection of the input (vqvae.py:436-446).
    ``use_dec=False`` is the classic VQ-VAE's memory (vqvae.py:164-240):
    the lookup's ``k * embed_dim`` channels go out as they are, in the
    compute dtype.  Returns ``(out, commit distance, straight-through top-1
    code)``."""

    def __init__(self, in_features: int, embed_dim: int, n_embed: int,
                 k: int = 1, residual_proj: bool = False,
                 use_dec: bool = True, use_kernel: bool = False):
        super().__init__()
        self.enc = Conv2d(in_features, embed_dim, 1)
        self.quantize = TopKMemory(embed_dim, n_embed, k, use_kernel,
                                   st_mode="topk")
        self.dec = Conv2d(k * embed_dim, embed_dim, 1) if use_dec else None
        self.enc_x = (Conv2d(in_features, embed_dim, 1) if residual_proj
                      else None)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        q_topk, diff, q_st = self.quantize(self.enc(x))
        if self.dec is None:
            return q_topk, diff, q_st
        out = self.dec(q_topk)
        if self.enc_x is not None:
            out = out + self.enc_x(x)
        return out, diff, q_st


class _VQVAEBase(nn.Module):
    """Two-level VQ-VAE trunk (vqvae.py:164-240); the subclass picks the
    memory.  ``forward(x)`` returns ``(decoded, diff_t + diff_b)``."""

    residual_proj = False
    classic = False  # the plain VQVAE: k 1, no 1x1 after the lookup

    def __init__(self, in_channel: int, out_channel: int = 3,
                 channel: int = 128, n_res_block: int = 2,
                 n_res_channel: int = 32, embed_dim: int = 64,
                 n_embed: int = 512, k: int = 1, use_kernel: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        c, rb, rc, e = channel, n_res_block, n_res_channel, embed_dim

        def memory(in_features):
            return VQMemory(in_features, e, n_embed, 1 if self.classic else k,
                            residual_proj=self.residual_proj,
                            use_dec=not self.classic, use_kernel=use_kernel)

        self.enc_b = Encoder(in_channel, c, rb, rc, stride=4)
        self.enc_t = Encoder(c, c, rb, rc, stride=2)
        self.quantize_t = memory(c)
        self.dec_t = Decoder(e, e, c, rb, rc, stride=2)
        self.quantize_b = memory(e + c)
        self.upsample_t = _up4x4(e, e)
        self.dec = Decoder(2 * e, out_channel, c, rb, rc, stride=4)

    def encode(self, x: torch.Tensor):
        enc_b = self.enc_b(x)
        enc_t = self.enc_t(enc_b)
        quant_t, diff_t, id_t = self.quantize_t(enc_t)
        enc_b = torch.cat([self.dec_t(quant_t), enc_b], dim=1)
        quant_b, diff_b, id_b = self.quantize_b(enc_b)
        return quant_t, quant_b, diff_t + diff_b, id_t, id_b

    def decode(self, quant_t: torch.Tensor, quant_b: torch.Tensor
               ) -> torch.Tensor:
        return self.dec(torch.cat([self.upsample_t(quant_t), quant_b], dim=1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        quant_t, quant_b, diff, _, _ = self.encode(x)
        return self.decode(quant_t, quant_b), diff


class VQVAE(_VQVAEBase):
    """Classic two-level VQ-VAE (vqvae.py:164-240): k 1, straight-through
    quantize fed to the decoders as it is."""

    classic = True


class VQVAETopK(_VQVAEBase):
    """VQVAE_topk (vqvae.py:336-398)."""


class VQVAETopKRes(_VQVAEBase):
    """VQVAE_topk_res (vqvae.py:436-501): projection-residual memory."""

    residual_proj = True


class MiddleUNet(nn.Module):
    """The concat bridge of the VQ-VAE two-stream (vqvae.py:526-539):
    residual cross paths, then 1x1 reducers of each stream's concat."""

    def __init__(self, features: int = 64):
        super().__init__()
        self.O2F = ResBlock(features, features)
        self.F2O = ResBlock(features, features)
        self.dec_x = Conv2d(2 * features, features, 1)
        self.dec_y = Conv2d(2 * features, features, 1)

    def forward(self, zx: torch.Tensor, zy: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x1 = torch.cat([zx, self.O2F(zy)], dim=1)
        y1 = torch.cat([zy, self.F2O(zx)], dim=1)
        return self.dec_x(x1), self.dec_y(y1)


class VQVAETopKTwoStream(nn.Module):
    """Two-stream VQ-VAE with ``middle_unet`` bridges at both levels
    (vqvae.py:541-643).  ``forward(rgb, op)`` returns ``(rgb decoded, op
    decoded, the sum of the four commit distances)``.  The reference names
    the bottom bridge ``bride_b``; the port, like the JAX package, spells it
    ``bridge_b``.  Branch freezing is :func:`bridge_only_mask`."""

    def __init__(self, rgb_in: int, op_in: int, rgb_out: int = 3,
                 op_out: int = 2, channel: int = 128, n_res_block: int = 2,
                 n_res_channel: int = 32, embed_dim: int = 64,
                 n_embed: int = 512, k: int = 1, use_kernel: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        c, rb, rc, e = channel, n_res_block, n_res_channel, embed_dim

        def memory(in_features):
            return VQMemory(in_features, e, n_embed, k, use_kernel=use_kernel)

        # the JAX setup's order, which is init_weights' draw order too
        self.enc_b_1 = Encoder(rgb_in, c, rb, rc, stride=4)
        self.enc_t_1 = Encoder(c, c, rb, rc, stride=2)
        self.enc_b_2 = Encoder(op_in, c, rb, rc, stride=4)
        self.enc_t_2 = Encoder(c, c, rb, rc, stride=2)
        self.quantize_t_1 = memory(c)
        self.dec_t_1 = Decoder(e, e, c, rb, rc, stride=2)
        self.quantize_t_2 = memory(c)
        self.dec_t_2 = Decoder(e, e, c, rb, rc, stride=2)
        self.bridge_t = MiddleUNet(e)
        self.quantize_b_1 = memory(e + c)
        self.upsample_t_1 = _up4x4(e, e)
        self.dec_1 = Decoder(2 * e, rgb_out, c, rb, rc, stride=4)
        self.quantize_b_2 = memory(e + c)
        self.upsample_t_2 = _up4x4(e, e)
        self.dec_2 = Decoder(2 * e, op_out, c, rb, rc, stride=4)
        self.bridge_b = MiddleUNet(e)

    def forward(self, rgb: torch.Tensor, op: torch.Tensor):
        if self.dtype is not None:
            rgb, op = rgb.to(self.dtype), op.to(self.dtype)
        enc_b_1 = self.enc_b_1(rgb)
        enc_t_1 = self.enc_t_1(enc_b_1)
        enc_b_2 = self.enc_b_2(op)
        enc_t_2 = self.enc_t_2(enc_b_2)
        quant_t_1, diff_t_1, _ = self.quantize_t_1(enc_t_1)
        quant_t_2, diff_t_2, _ = self.quantize_t_2(enc_t_2)
        quant_t_1, quant_t_2 = self.bridge_t(quant_t_1, quant_t_2)
        enc_b_1 = torch.cat([self.dec_t_1(quant_t_1), enc_b_1], dim=1)
        enc_b_2 = torch.cat([self.dec_t_2(quant_t_2), enc_b_2], dim=1)
        quant_b_1, diff_b_1, _ = self.quantize_b_1(enc_b_1)
        quant_b_2, diff_b_2, _ = self.quantize_b_2(enc_b_2)
        quant_b_1, quant_b_2 = self.bridge_b(quant_b_1, quant_b_2)
        dec_1 = self.dec_1(torch.cat([self.upsample_t_1(quant_t_1),
                                      quant_b_1], dim=1))
        dec_2 = self.dec_2(torch.cat([self.upsample_t_2(quant_t_2),
                                      quant_b_2], dim=1))
        return dec_1, dec_2, diff_t_1 + diff_t_2 + diff_b_1 + diff_b_2


def bridge_only_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether it trains when the branches are frozen:
    True only under a top-level ``bridge*`` module (the JAX package's optax
    mask, itself the reference's ``fixed_rgb_op_branch``, vqvae.py:634-643)."""
    return {name: name.split(".")[0].startswith("bridge")
            for name, _ in model.named_parameters()}
