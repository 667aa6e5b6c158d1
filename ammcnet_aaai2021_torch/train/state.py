"""Training state: everything a step mutates, in one object.

Port of ``ammcnet_aaai2021_tpu/train/state.py``.  The JAX package threads an
immutable pytree through its jitted step; here the modules, optimizers and
schedulers are updated in place and :class:`TrainState` holds them together
with the step count, which is what the checkpoint saves and restores.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LRScheduler

from ..configs import OptimConfig
from ..models import init_weights
from .optim import make_optimizers

STREAMS = ("rgb", "op")


@dataclass
class TrainState:
    step: int
    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_sched: LRScheduler
    d_sched: LRScheduler


def create_train_state(generator: nn.Module, discriminator: nn.Module,
                       cfg: OptimConfig, seed: int,
                       g_mask: Optional[Mapping[str, bool]] = None,
                       device: torch.device | str = "cpu") -> TrainState:
    """Seeded weights (generator from ``seed``, discriminator from
    ``seed + 1``, as the JAX package folds its key), both modules on
    ``device`` in training mode, fresh optimizers at step 0."""
    init_weights(generator, torch.Generator().manual_seed(seed))
    init_weights(discriminator, torch.Generator().manual_seed(seed + 1))
    generator.to(device).train()
    discriminator.to(device).train()
    return TrainState(0, generator, discriminator,
                      *make_optimizers(cfg, generator, discriminator, g_mask))


@torch.no_grad()
def graft_branches(generator: nn.Module, rgb_state: Mapping[str, torch.Tensor],
                   op_state: Mapping[str, torch.Tensor]) -> None:
    """Stage-1 -> stage-2 branch grafting (reference loader_rgb_op_branch,
    utils.py:236-263): two single-stream state dicts are mounted under the
    two-stream generator's ``rgb.`` / ``op.`` prefixes — parameters,
    BatchNorm statistics and codebook buffers alike; the bridge keeps its
    own weights.  Every entry of each stream must be given
    (``num_batches_tracked`` excepted)."""
    sd = generator.state_dict()
    for prefix, branch in zip(STREAMS, (rgb_state, op_state)):
        want = {k[len(prefix) + 1:] for k in sd if k.startswith(prefix + ".")}
        missing = sorted(k for k in want - set(branch)
                         if not k.endswith("num_batches_tracked"))
        extra = sorted(set(branch) - want)
        if missing or extra:
            raise KeyError(f"{prefix} branch: missing {missing[:5]}, "
                           f"unexpected {extra[:5]}")
        for key, val in branch.items():
            sd[f"{prefix}.{key}"] = val
    generator.load_state_dict(sd)
