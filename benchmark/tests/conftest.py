"""Fixtures of the benchmark's CPU tests: tiny specifications of each cell
(64x64 frames, a few short videos or a batch of 2; every width as
published), and the card fixture of the tests marked ``cuda``."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import harness


def tiny_spec(workload: str, seed: int = 7, seconds: float = 0.5,
              control=None) -> harness.Spec:
    spec = harness.load_spec(workload, seed, seconds, False,
                             torch.device("cpu"), time.perf_counter())
    spec.config = copy.deepcopy(spec.config)
    spec.config["net"]["image_size"] = 64
    spec.config["train_split"]["lengths"] = [12, 10, 11]
    spec.config["calibration"] = {"batches": 1, "batch": 2}
    if spec.mix["driver"] == "score":
        spec.mix.update(lengths=[12, 9], bucket=8, window_batch=8,
                        check_videos=2, trace_videos=1)
        if "pad_to" in spec.mix:
            spec.mix["pad_to"] = 16
    else:
        spec.mix.update(batch=2, warmup_steps=4, trace_steps=2, step_log=2)
    spec.control = control
    return spec


@pytest.fixture
def tiny():
    torch.manual_seed(0)
    return tiny_spec


@pytest.fixture
def card():
    """Skips unless a CUDA device is visible (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda", 0)
