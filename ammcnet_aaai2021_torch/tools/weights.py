"""Weight bridge: JAX variables and torch checkpoints -> the port's state
dicts.

:func:`discriminator_state_from_jax` and :func:`flownet_state_from_jax`
do the same for the training slice's PatchGAN discriminator and FlowNet2-SD
teacher (the latter the inverse of the JAX package's
``convert_flownet_sd_state``: ``params/net/<mod>/{conv,deconv}`` ->
``<mod>.0.*``, ``params/net/{predict_flowX,upsampled_flowX_to_Y}`` ->
``<mod>.*``).

:func:`load_generator_checkpoint` reads every generator checkpoint the
two packages write: a torch ``.pth``, a step directory of the port's
training loop, and the JAX package's flax ``.msgpack`` files and orbax step
directories (through :mod:`.jax_checkpoint`, which needs no JAX; an orbax
directory needs tensorstore).

:func:`state_dict_from_jax` inverts the JAX package's
``tools/torch_convert.convert_twostream``: it takes the flax
``{'params', 'batch_stats', 'codebook'}`` tree of the two-stream generator
(numpy arrays) and returns a state dict with the reference torch names,
which :class:`~..models.TwoStreamUNetMem` loads with ``load_state_dict``,
for each ``bridge_kind`` (``bridge.dec`` of the concat bridge, no entry for
the add bridge); :func:`single_stream_state_from_jax` inverts
``convert_unetmem_stream`` for the stage-1 generator (the same stream's
names without the ``rgb.`` / ``op.`` prefix), and takes the other nets of
that trunk too: the plain ``UNet`` (no memory), ``UNetMemV4`` (``vq_down2``
and ``vq_down3``) and ``UNetMemStream(residual_memory=False)`` (the block's
``enc`` / ``quantize`` / ``dec`` without ``quan``).  A stage-1 ``.pth`` in
those names loads as it is (:func:`load_generator_checkpoint`), and
``run_train --pretrain`` grafts it.  :func:`vqvae_state_from_jax` carries
the VQ-VAE nets across, whose port keeps the flax module names.

==============================================  ================================
flax path                                       torch key
==============================================  ================================
params/<m>/conv0.kernel  [T]                    <m>.conv.conv.0.weight
params/<m>/bn0.{scale,bias}                     <m>.conv.conv.1.{weight,bias}
batch_stats/<m>/bn0.{mean,var}                  <m>.conv.conv.1.running_{mean,var}
conv1 / bn1                                     <m>.conv.conv.{3,4}.*
down*/conv/...                                  down*.mpconv.1.conv.*
up*/up.{kernel,bias}     [T]                    up*.up.{weight,bias}
up*/conv/...                                    up*.conv.conv.*
outc.{kernel,bias}       [T]                    outc.{weight,bias}
vq_down3/quan/{enc,dec}  [T]                    vq_down3.quan.{enc,dec}.*
codebook/vq_down3/quan/quantize/...             vq_down3.quan.quantize.*
bridge/{O2F,F2O}/...                            bridge.{O2F,F20}.conv.*
==============================================  ================================

[T]: Conv kernels (kh, kw, in, out) and ConvTranspose kernels (kh, kw, out,
in) both map back with ``transpose(3, 2, 0, 1)``, the inverse of the JAX
converter's ``transpose(2, 3, 1, 0)``.  BatchNorm's ``num_batches_tracked``
(which flax does not keep) is set to 0.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kernel(a) -> torch.Tensor:
    return _t(np.transpose(np.asarray(a), (3, 2, 0, 1)))


def double_conv_state(prefix: str, params: Mapping, stats: Mapping
                      ) -> StateDict:
    """One flax DoubleConv (conv0/bn0/conv1/bn1) -> ``<prefix>.conv.{0,1,3,4}.*``."""
    out: StateDict = {}
    for conv, bn, ci, bi in (("conv0", "bn0", 0, 1), ("conv1", "bn1", 3, 4)):
        out[f"{prefix}.conv.{ci}.weight"] = _kernel(params[conv]["kernel"])
        out[f"{prefix}.conv.{bi}.weight"] = _t(params[bn]["scale"])
        out[f"{prefix}.conv.{bi}.bias"] = _t(params[bn]["bias"])
        out[f"{prefix}.conv.{bi}.running_mean"] = _t(stats[bn]["mean"])
        out[f"{prefix}.conv.{bi}.running_var"] = _t(stats[bn]["var"])
        out[f"{prefix}.conv.{bi}.num_batches_tracked"] = torch.tensor(0)
    return out


def conv_state(prefix: str, params: Mapping) -> StateDict:
    """A flax Conv/ConvTranspose with bias -> ``<prefix>.{weight,bias}``."""
    return {f"{prefix}.weight": _kernel(params["kernel"]),
            f"{prefix}.bias": _t(params["bias"])}


def down_state(prefix: str, params: Mapping, stats: Mapping) -> StateDict:
    return double_conv_state(f"{prefix}.mpconv.1", params["conv"],
                             stats["conv"])


def up_state(prefix: str, params: Mapping, stats: Mapping) -> StateDict:
    return {**conv_state(f"{prefix}.up", params["up"]),
            **double_conv_state(f"{prefix}.conv", params["conv"],
                                stats["conv"])}


def memory_state(prefix: str, params: Mapping, codebook: Mapping) -> StateDict:
    """A flax EncQuanDecResTopK (``quan/{enc,quantize,dec}``), or an
    EncQuanDecTopK (``{enc,quantize,dec}``, no ``quan``)."""
    if "quan" in params:
        return memory_state(f"{prefix}.quan", params["quan"],
                            codebook["quan"])
    cb = codebook["quantize"]
    out = {**conv_state(f"{prefix}.enc", params["enc"]),
           **conv_state(f"{prefix}.dec", params["dec"])}
    for leaf in ("embed", "cluster_size", "embed_avg"):
        out[f"{prefix}.quantize.{leaf}"] = _t(cb[leaf])
    return out


def stream_state(prefix: str, params: Mapping, stats: Mapping,
                 codebook: Mapping) -> StateDict:
    """A flax UNetMemStream, UNetMemV4 or UNet ->
    ``<prefix>.{inc,down*,vq_down*,up*,outc}.*``."""
    out = double_conv_state(f"{prefix}.inc.conv", params["inc"], stats["inc"])
    for name in ("down1", "down2", "down3"):
        out.update(down_state(f"{prefix}.{name}", params[name], stats[name]))
    for name in ("vq_down2", "vq_down3"):
        if name in params:
            out.update(memory_state(f"{prefix}.{name}", params[name],
                                    codebook[name]))
    for name in ("up1", "up2", "up3"):
        out.update(up_state(f"{prefix}.{name}", params[name], stats[name]))
    out.update(conv_state(f"{prefix}.outc", params["outc"]))
    return out


def state_dict_from_jax(variables: Mapping) -> StateDict:
    """The JAX two-stream generator's variables -> the port's state dict
    (its bridge told apart by its params: AMFT's ``O2F``/``F2O``, the
    concat bridge's ``dec``, none for the add bridge)."""
    params, stats = variables["params"], variables["batch_stats"]
    codebook = variables["codebook"]
    out: StateDict = {}
    for s in ("rgb", "op"):
        out.update(stream_state(s, params[s], stats[s], codebook[s]))
    bridge = params.get("bridge", {})
    if "dec" in bridge:
        out.update(conv_state("bridge.dec", bridge["dec"]))
    elif bridge:
        for flax_name, torch_name in (("O2F", "O2F"), ("F2O", "F20")):
            out.update(double_conv_state(f"bridge.{torch_name}",
                                         bridge[flax_name],
                                         stats["bridge"][flax_name]))
    return out


def single_stream_state_from_jax(variables: Mapping) -> StateDict:
    """The JAX stage-1 generator's variables (``UNetMemStream``, tag
    ``unet_vq_topk_res``; or ``UNetMemV4``, or the plain ``UNet``, tag
    ``unet``) -> the port's module's state dict: one stream's entries
    without a prefix, the inverse of the JAX package's
    ``convert_unetmem_stream``."""
    sd = stream_state("s", variables["params"], variables["batch_stats"],
                      variables.get("codebook", {}))
    return {k[len("s."):]: v for k, v in sd.items()}


def _leaves(tree: Mapping, path=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), val


def vqvae_state_from_jax(variables: Mapping) -> StateDict:
    """The JAX VQ-VAE nets' variables (tags ``vqvae``, ``vqvae_topk``,
    ``vqvae_topk_res``, ``vqvae_twostream``) -> the port's state dict.  The
    port keeps the flax names, so ``params/<path>/{kernel,bias}`` becomes
    ``<path>.{weight,bias}`` (kernels transposed, [T] above) and a memory's
    ``codebook/<path>/<leaf>`` becomes ``<path>.quantize.<leaf>``.  Applied
    to a gradient tree (``{"params": grads}``) it names the gradients as
    the port's parameters."""
    out: StateDict = {}
    for path, leaf in _leaves(variables["params"]):
        name = ".".join(path[:-1])
        if path[-1] == "kernel":
            out[f"{name}.weight"] = _kernel(leaf)
        else:
            out[f"{name}.{path[-1]}"] = _t(leaf)
    for path, leaf in _leaves(variables.get("codebook", {})):
        out[".".join(path[:-1] + ("quantize", path[-1]))] = _t(leaf)
    return out


def discriminator_state_from_jax(params: Mapping) -> StateDict:
    """The JAX ``PixelDiscriminator``'s params (``conv0``.. ``out``, each
    ``{kernel, bias}``) -> the port's state dict."""
    out: StateDict = {}
    for name, leaf in params.items():
        out.update(conv_state(name, leaf))
    return out


def flownet_state_from_jax(variables: Mapping) -> StateDict:
    """The JAX ``FlowNet2SD``'s variables -> the port's (and the reference
    torch module's) state dict."""
    out: StateDict = {}
    for mod, leaf in variables["params"]["net"].items():
        if mod.startswith(("predict_flow", "upsampled_flow")):
            out.update(conv_state(mod, leaf))
        else:  # convX / inter_convX (inner "conv") and deconvX ("deconv")
            inner = "deconv" if mod.startswith("deconv") else "conv"
            out.update(conv_state(f"{mod}.0", leaf[inner]))
    return out


def load_generator_checkpoint(path: str) -> StateDict:
    """The generator's state dict from a checkpoint path: a torch ``.pth``
    (the reference's own, or one this bridge wrote; a ``{'state_dict': ...}``
    wrapper is unwrapped), a step directory the port's training loop wrote
    (``<run>/training/checkpoints/<step>``), a flax ``.msgpack`` of the JAX
    package, or an orbax step directory of the JAX package (generator
    variables or a full train state; needs tensorstore, else
    ``ImportError`` naming the converter)."""
    from ..train.checkpoint import STATE_FILE, load_state_file

    if path.endswith(".msgpack") or (
            os.path.isdir(path) and not os.path.exists(
                os.path.join(path, STATE_FILE))):
        from .jax_checkpoint import (generator_state_dict,
                                     generator_variables, read_jax_checkpoint)

        return generator_state_dict(generator_variables(
            read_jax_checkpoint(path)))
    if os.path.isdir(path):
        return dict(load_state_file(path)["generator"])
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return dict(raw)
