"""Weight bridge: JAX variables and torch checkpoints -> the port's state
dicts.

:func:`discriminator_state_from_jax` and :func:`flownet_state_from_jax`
do the same for the training slice's PatchGAN discriminator and FlowNet2-SD
teacher (the latter the inverse of the JAX package's
``convert_flownet_sd_state``: ``params/net/<mod>/{conv,deconv}`` ->
``<mod>.0.*``, ``params/net/{predict_flowX,upsampled_flowX_to_Y}`` ->
``<mod>.*``).

:func:`state_dict_from_jax` inverts the JAX package's
``tools/torch_convert.convert_twostream``: it takes the flax
``{'params', 'batch_stats', 'codebook'}`` tree of the two-stream generator
(numpy arrays) and returns a state dict with the reference torch names,
which :class:`~..models.TwoStreamUNetMem` loads with ``load_state_dict``;
:func:`single_stream_state_from_jax` inverts ``convert_unetmem_stream`` for
the stage-1 generator (the same stream's names without the ``rgb.`` /
``op.`` prefix).  A stage-1 ``.pth`` in those names loads as it is
(:func:`load_generator_checkpoint`), and ``run_train --pretrain`` grafts it.

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
    """A flax EncQuanDecResTopK (``quan/{enc,quantize,dec}``)."""
    quan = params["quan"]
    cb = codebook["quan"]["quantize"]
    out = {**conv_state(f"{prefix}.quan.enc", quan["enc"]),
           **conv_state(f"{prefix}.quan.dec", quan["dec"])}
    for leaf in ("embed", "cluster_size", "embed_avg"):
        out[f"{prefix}.quan.quantize.{leaf}"] = _t(cb[leaf])
    return out


def stream_state(prefix: str, params: Mapping, stats: Mapping,
                 codebook: Mapping) -> StateDict:
    """A flax UNetMemStream -> ``<prefix>.{inc,down*,vq_down3,up*,outc}.*``."""
    out = double_conv_state(f"{prefix}.inc.conv", params["inc"], stats["inc"])
    for name in ("down1", "down2", "down3"):
        out.update(down_state(f"{prefix}.{name}", params[name], stats[name]))
    out.update(memory_state(f"{prefix}.vq_down3", params["vq_down3"],
                            codebook["vq_down3"]))
    for name in ("up1", "up2", "up3"):
        out.update(up_state(f"{prefix}.{name}", params[name], stats[name]))
    out.update(conv_state(f"{prefix}.outc", params["outc"]))
    return out


def state_dict_from_jax(variables: Mapping) -> StateDict:
    """The JAX two-stream generator's variables -> the port's state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    codebook = variables["codebook"]
    out: StateDict = {}
    for s in ("rgb", "op"):
        out.update(stream_state(s, params[s], stats[s], codebook[s]))
    for flax_name, torch_name in (("O2F", "O2F"), ("F2O", "F20")):
        out.update(double_conv_state(f"bridge.{torch_name}",
                                     params["bridge"][flax_name],
                                     stats["bridge"][flax_name]))
    return out


def single_stream_state_from_jax(variables: Mapping) -> StateDict:
    """The JAX stage-1 generator's variables (``UNetMemStream``, tag
    ``unet_vq_topk_res``) -> the port's :class:`~..models.UNetMemStream`
    state dict: one stream's entries without a prefix, the inverse of the
    JAX package's ``convert_unetmem_stream``."""
    sd = stream_state("s", variables["params"], variables["batch_stats"],
                      variables["codebook"])
    return {k[len("s."):]: v for k, v in sd.items()}


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
    wrapper is unwrapped), or a step directory the port's training loop
    wrote (``<run>/training/checkpoints/<step>``)."""
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: the JAX package's msgpack checkpoints are not read by "
            "the port yet; they come with the export-and-tools slice")
    if os.path.isdir(path):
        from ..train.checkpoint import STATE_FILE, load_state_file

        if not os.path.exists(os.path.join(path, STATE_FILE)):
            raise NotImplementedError(
                f"{path} holds no {STATE_FILE}: the JAX package's orbax "
                "checkpoints are not read by the port yet; they come with the "
                "export-and-tools slice")
        return dict(load_state_file(path)["generator"])
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return dict(raw)
