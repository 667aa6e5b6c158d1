"""Optimizer factory.

Port of ``ammcnet_aaai2021_tpu/train/optim.py`` (reference
``Code/models/optimizer/__init__.py:29-63``): Adam for G and Adam for D
(b1 0.9, b2 0.999, eps 1e-8), each under a MultiStepLR schedule (gamma 0.5
at the configured milestones) stepped once per iteration.  After ``u``
updates the next one runs at ``lr * gamma ** #{m : m <= u}``, as optax's
``piecewise_constant_schedule`` counts: update 40,001 is the first at half
rate.  ``g_mask`` names which top-level generator modules train (the
reference filters parameters by ``requires_grad``, optimizer/__init__.py:
40-42); the others are left out of the optimizer and get no update.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import MultiStepLR

from ..configs import OptimConfig


def make_optimizers(cfg: OptimConfig, generator: nn.Module,
                    discriminator: nn.Module,
                    g_mask: Optional[Mapping[str, bool]] = None
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam,
                               MultiStepLR, MultiStepLR]:
    """``(g_opt, d_opt, g_sched, d_sched)``.  ``g_mask`` maps each
    top-level child of the generator (``rgb``, ``op``, ``bridge``) to whether
    it trains, as ``{k: k == "bridge" ...}`` for ``fix_branches``."""
    g_params = [p for name, p in generator.named_parameters()
                if g_mask is None or g_mask[name.split(".")[0]]]
    g_opt = torch.optim.Adam(g_params, lr=cfg.lr_g, betas=(0.9, 0.999),
                             eps=1e-8)
    d_opt = torch.optim.Adam(discriminator.parameters(), lr=cfg.lr_d,
                             betas=(0.9, 0.999), eps=1e-8)
    milestones = [int(m) for m in cfg.lr_milestones]
    return (g_opt, d_opt,
            MultiStepLR(g_opt, milestones, gamma=cfg.lr_gamma),
            MultiStepLR(d_opt, milestones, gamma=cfg.lr_gamma))
