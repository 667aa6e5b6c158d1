"""Full-state training checkpoints.

Port of ``ammcnet_aaai2021_tpu/train/checkpoint.py``.  A checkpoint holds
the whole training state: generator (parameters, BatchNorm statistics and
codebook buffers), discriminator, both optimizer states, both scheduler
states and the step — the reference saved weights only and reset Adam's
moments on resume.  Layout is the JAX package's,
``<ckpt_dir>/<step:06d>/``, here holding one ``torch.save`` file
(:data:`STATE_FILE`); a step directory is written under a temporary name and
renamed when complete, so the digits-only :func:`latest_step` never sees a
partial one.  :func:`restore_checkpoint` also takes a step directory the
JAX package's training loop wrote (an orbax full train state, read by
``tools/jax_checkpoint.py`` where tensorstore is installed).

:func:`snapshot` copies a state's payload (on its device) so a writer
thread can save step N while the loop goes on stepping; the file it writes
is byte for byte the one :func:`save_checkpoint` writes at step N.
"""

from __future__ import annotations

import copy
import os
import shutil
from typing import Dict, List, Optional

import torch

from .state import TrainState

STATE_FILE = "state.pt"


def checkpoint_payload(state: TrainState) -> Dict:
    """What a checkpoint file holds: the live state dicts (no copies)."""
    return {
        "step": state.step,
        "generator": state.generator.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "g_sched": state.g_sched.state_dict(),
        "d_sched": state.d_sched.state_dict(),
    }


def snapshot(state: TrainState) -> Dict:
    """A copy of :func:`checkpoint_payload` that the next steps leave as it
    is: every tensor's storage is copied on its device (in stream order, so
    the copy holds this step's values), containers keep their types and
    state dicts their ``_metadata``; ``torch.save`` of it writes the same
    bytes as of the live payload."""
    return copy.deepcopy(checkpoint_payload(state))


def write_checkpoint(ckpt_dir: str, payload: Dict) -> str:
    """Write ``payload`` under ``<ckpt_dir>/<step:06d>``; returns the path."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"{payload['step']:06d}")
    tmp = f"{path}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Save the full state under ``<ckpt_dir>/<step:06d>``; returns the path."""
    return write_checkpoint(ckpt_dir, checkpoint_payload(state))


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
    CPU, as a fresh optimizer has them).  A step directory of the JAX
    package (orbax, no :data:`STATE_FILE`) is converted into the fresh
    ``state`` (``tools/jax_checkpoint.restore_jax_train_state``)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    step_dir = os.path.join(ckpt_dir, f"{step:06d}")
    if not os.path.exists(os.path.join(step_dir, STATE_FILE)):
        from ..tools.jax_checkpoint import read_orbax, restore_jax_train_state

        return restore_jax_train_state(read_orbax(step_dir), state)
    raw = load_state_file(step_dir)
    state.generator.load_state_dict(raw["generator"])
    state.discriminator.load_state_dict(raw["discriminator"])
    state.g_opt.load_state_dict(raw["g_opt"])
    state.d_opt.load_state_dict(raw["d_opt"])
    state.g_sched.load_state_dict(raw["g_sched"])
    state.d_sched.load_state_dict(raw["d_sched"])
    state.step = int(raw["step"])
    return state
