"""Full-state training checkpoints.

Port of ``ammcnet_aaai2021_tpu/train/checkpoint.py``.  A checkpoint holds
the whole training state: generator (parameters, BatchNorm statistics and
codebook buffers), discriminator, both optimizer states, both scheduler
states and the step — the reference saved weights only and reset Adam's
moments on resume.  Layout is the JAX package's,
``<ckpt_dir>/<step:06d>/``, here holding one ``torch.save`` file
(:data:`STATE_FILE`); a step directory is written under a temporary name and
renamed when complete, so the digits-only :func:`latest_step` never sees a
partial one.  The JAX package's orbax and msgpack checkpoints are not read
here (no flax or orbax on the card's machine).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import torch

from .state import TrainState

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Save the full state under ``<ckpt_dir>/<step:06d>``; returns the path."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"{state.step:06d}")
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save({
        "step": state.step,
        "generator": state.generator.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "g_sched": state.g_sched.state_dict(),
        "d_sched": state.d_sched.state_dict(),
    }, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit()]
    return max(steps) if steps else None


def prune_checkpoints(ckpt_dir: str, keep_last: Optional[int] = None,
                      keep_every: Optional[int] = None) -> List[int]:
    """Retention: keep the union of the newest ``keep_last`` steps, every
    step divisible by ``keep_every``, and always the latest.  ``None``
    disables a criterion; both ``None`` keeps everything (the reference
    never pruned).  Returns the deleted steps."""
    if keep_last is None and keep_every is None:
        return []
    if not os.path.isdir(ckpt_dir):
        return []
    steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    if not steps:
        return []
    keep = {steps[-1]}
    if keep_last:
        keep.update(steps[-keep_last:])
    if keep_every:
        keep.update(s for s in steps if s % keep_every == 0)
    deleted = []
    for s in steps:
        if s not in keep:
            shutil.rmtree(os.path.join(ckpt_dir, f"{s:06d}"))
            deleted.append(s)
    return deleted


def load_state_file(step_dir: str, map_location="cpu") -> Dict:
    """The raw saved dict of one step directory."""
    return torch.load(os.path.join(step_dir, STATE_FILE),
                      map_location=map_location, weights_only=True)


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Load the given (or latest) step into ``state`` in place: modules,
    optimizers, schedulers and step.  The file is read to the CPU and each
    ``load_state_dict`` puts its tensors where the module or optimizer keeps
    them (Adam's moments beside their parameters, its step counts on the
    CPU, as a fresh optimizer has them)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    raw = load_state_file(os.path.join(ckpt_dir, f"{step:06d}"))
    state.generator.load_state_dict(raw["generator"])
    state.discriminator.load_state_dict(raw["discriminator"])
    state.g_opt.load_state_dict(raw["g_opt"])
    state.d_opt.load_state_dict(raw["d_opt"])
    state.g_sched.load_state_dict(raw["g_sched"])
    state.d_sched.load_state_dict(raw["d_sched"])
    state.step = int(raw["step"])
    return state
