"""Composed generator losses per loss_tag.

Port of ``ammcnet_aaai2021_tpu/losses/zoo.py`` (reference
``Code/models/losses/loss_zoo.py`` and the tag dispatch of
``losses/__init__.py:36-142``).  Each composition is a function
``(batch_dict, weights) -> (scalar, components_dict)``; the components are
the scalars the reference logs.

batch_dict keys (present per recipe), tensors NCHW:
  rgb_pred / rgb_target          — generator RGB prediction vs gt frame
  op_pred / op_target            — flow prediction vs gt flow field
  d_gen                          — discriminator score map of the prediction
  flow_pred / flow_gt            — FlowNet outputs on (target, pred) / (target, gt)
  latent_diff                    — commit loss (scalar or tuple of scalars)
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..configs import LossConfig
from .primitives import (
    adversarial_loss,
    discriminate_loss,
    flow_loss,
    gradient_loss,
    intensity_loss,
)

Scalars = Dict[str, torch.Tensor]


def _latent_sum(latent_diff) -> torch.Tensor:
    """The two-stream generator returns its commit distances as a per-stream
    tuple (unet.py:1004) and the stage-2 loss needs one scalar
    (loss_zoo.py:335 would throw on the tuple): sum them."""
    if isinstance(latent_diff, (tuple, list)):
        return sum(latent_diff)
    return latent_diff


def rgb_loss(b: Dict, w: LossConfig) -> Tuple[torch.Tensor, Scalars]:
    """rgb_int_gdl_flow_adv (loss_zoo.py:64-98)."""
    c = {
        "g_adv_loss": adversarial_loss(b["d_gen"]),
        "g_flow_loss": flow_loss(b["flow_pred"], b["flow_gt"]),
        "g_int_loss": intensity_loss(b["rgb_pred"], b["rgb_target"], w.l_num),
        "g_gd_loss": gradient_loss(b["rgb_pred"], b["rgb_target"], w.alpha_num),
    }
    g = (w.lam_adv * c["g_adv_loss"] + w.lam_gdl * c["g_gd_loss"]
         + w.lam_flow * c["g_flow_loss"] + w.lam_lp * c["g_int_loss"])
    return g, c


def rgb_vq_loss(b: Dict, w: LossConfig) -> Tuple[torch.Tensor, Scalars]:
    """rgb_int_gdl_flow_adv_vq (loss_zoo.py:101-139)."""
    g, c = rgb_loss(b, w)
    c["g_latent_loss"] = _latent_sum(b["latent_diff"])
    return g + w.lam_latent * c["g_latent_loss"], c


def op_loss(b: Dict, w: LossConfig) -> Tuple[torch.Tensor, Scalars]:
    """op_int_adv (loss_zoo.py:142-168)."""
    c = {
        "g_adv_loss": adversarial_loss(b["d_gen"]),
        "g_int_loss_op": intensity_loss(b["op_pred"], b["op_target"], w.l_num),
    }
    return w.lam_adv * c["g_adv_loss"] + w.lam_lp_op * c["g_int_loss_op"], c


def op_vq_loss(b: Dict, w: LossConfig) -> Tuple[torch.Tensor, Scalars]:
    """op_int_adv_vq (loss_zoo.py:171-205)."""
    g, c = op_loss(b, w)
    c["g_latent_loss"] = _latent_sum(b["latent_diff"])
    return g + w.lam_latent * c["g_latent_loss"], c


def twostream_loss(b: Dict, w: LossConfig) -> Tuple[torch.Tensor, Scalars]:
    """twostream (loss_zoo.py:265-305)."""
    c = {
        "g_adv_loss": adversarial_loss(b["d_gen"]),
        "g_flow_loss": flow_loss(b["flow_pred"], b["flow_gt"]),
        "g_int_loss": intensity_loss(b["rgb_pred"], b["rgb_target"], w.l_num),
        "g_gd_loss": gradient_loss(b["rgb_pred"], b["rgb_target"], w.alpha_num),
        "g_int_loss_op": intensity_loss(b["op_pred"], b["op_target"], w.l_num),
    }
    g = (w.lam_adv * c["g_adv_loss"] + w.lam_gdl * c["g_gd_loss"]
         + w.lam_flow * c["g_flow_loss"] + w.lam_lp * c["g_int_loss"]
         + w.lam_lp_op * c["g_int_loss_op"])
    return g, c


def twostream_vq_loss(b: Dict, w: LossConfig) -> Tuple[torch.Tensor, Scalars]:
    """twostream_vq — the stage-2 joint loss (loss_zoo.py:307-350)."""
    g, c = twostream_loss(b, w)
    c["g_latent_loss"] = _latent_sum(b["latent_diff"])
    return g + w.lam_latent * c["g_latent_loss"], c


LOSS_TAGS: Dict[str, Callable] = {
    "rgb_int_gdl_flow_adv": rgb_loss,
    "op_int_adv": op_loss,
    "rgb_int_gdl_flow_adv_vq": rgb_vq_loss,
    "op_int_adv_vq": op_vq_loss,
    "twostream": twostream_loss,
    "twostream_vq": twostream_vq_loss,
}


def get_loss(loss_tag: str):
    """loss_tag -> (g_loss_fn, d_loss_fn) pair (reference get_loss)."""
    if loss_tag not in LOSS_TAGS:
        raise ValueError(f"unknown loss_tag {loss_tag!r}; "
                         f"have {sorted(LOSS_TAGS)}")
    return LOSS_TAGS[loss_tag], discriminate_loss
