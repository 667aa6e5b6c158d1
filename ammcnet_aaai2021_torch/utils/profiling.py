"""Profiling hooks.

Port of ``ammcnet_aaai2021_tpu/utils/profiling.py``.  The reference's
only tracing is ad-hoc ``time.time()`` deltas (train_helper.py:286-293,
362-368, which even logs sec/frame under the name "fps", :423-426).  Here:
a ``torch.profiler`` trace context (CPU activity, and CUDA activity where
a GPU is visible) that writes a Chrome trace, plus a host-side step timer
that reports frames/sec.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Iterator, Optional

import numpy as np

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block with ``torch.profiler`` and write a Chrome trace
    to ``<log_dir>/trace.json`` (viewable in Perfetto or
    chrome://tracing); yields the profiler, whose ``key_averages()`` the
    caller may read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def card_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them for a CUDA ``device``
    (a card below its maximum power runs slower under load, so a time is
    kept beside it); ``"cpu"`` for the CPU."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else 0
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


class StepTimer:
    """Rolling step/data timing with frames/sec accounting."""

    def __init__(self, window: int = 100):
        self.window = window
        self.step_times: list = []
        self.data_times: list = []
        self._t0: Optional[float] = None

    def data_tick(self, dt: float) -> None:
        self.data_times.append(dt)
        del self.data_times[: -self.window]

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.step_times.append(time.perf_counter() - t0)
        del self.step_times[: -self.window]

    def fps(self, frames_per_step: int) -> float:
        if not self.step_times:
            return 0.0
        return frames_per_step / float(np.mean(self.step_times))

    def summary(self, frames_per_step: int) -> str:
        return (f"step={np.mean(self.step_times or [0]):.4f}s "
                f"data={np.mean(self.data_times or [0]):.4f}s "
                f"fps/chip={self.fps(frames_per_step):.1f}")
