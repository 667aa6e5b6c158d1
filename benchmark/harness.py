"""What the drivers share: the run's specification, its outcome, the
readings the per-layer metrics take, the comparison against limits, and
the plain reference's float32 setting.

The manifest (``BENCHMARK.json``) names each cell's configuration and
traffic mix; the harness finds every file by those names:

* ``benchmark/configs/<config>.json`` (the configuration's ``file``),
* ``benchmark/mixes/<traffic>.json``, whose ``driver`` names
  ``benchmark/drivers/<driver>.py``,
* ``benchmark/limits/<workload>.json``, the limits of the numbers that
  decide ``correct``,
* ``benchmark/metrics/<metric>.py`` for each per-layer metric.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

ROOT = Path(__file__).resolve().parent
MANIFEST = ROOT.parent / "BENCHMARK.json"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ammcnet_aaai2021_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(path: Path = MANIFEST) -> dict:
    return load_json(path)


def find(items: List[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in {MANIFEST.name}")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Spec:
    """One run of one cell."""

    workload: str
    config: dict
    mix: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float  # perf_counter() reading of the process's start
    control: Optional[str] = None  # benchmark/control.py's substitutions
    diagnose: bool = False  # benchmark/control.py: readings beyond the check


def load_spec(workload: str, seed: int, seconds: float, trace: bool, device,
              t_process: float, doc: Optional[dict] = None) -> Spec:
    doc = doc or manifest()
    cell = find(doc["workloads"], workload, "workload")
    cfg = find(doc["configs"], cell["config"], "configuration")
    return Spec(workload=workload,
                config=load_json(ROOT.parent / cfg["file"]),
                mix=load_json(ROOT / "mixes" / f"{cell['traffic']}.json"),
                limits=load_json(ROOT / "limits" / f"{workload}.json"),
                seed=seed, seconds=seconds, trace=trace, device=device,
                t_process=t_process)


@dataclass
class Readings:
    """What a run measured, for the per-layer metrics' readers
    (``benchmark/metrics/<name>.py``: ``read(readings) -> float | None``)."""

    kind: str  # "score" or "train"
    trace: Any = None  # tracing.TraceSummary of the traced segment
    traced_units: int = 0  # videos or steps in the traced segment
    timings: Dict[str, List[float]] = field(default_factory=dict)
    window_s: float = 0.0
    window_flops: float = 0.0  # model FLOPs of the window's work
    peak_flops: float = 0.0  # the configuration's declared peak
    bounds: Dict[str, float] = field(default_factory=dict)


@dataclass
class Outcome:
    attempted: int
    failed: int
    checks: Dict[str, tuple]  # name -> (value, limit)
    e2e: Dict[str, float]
    readings: Readings
    memory_peak_bytes: int
    values: Dict[str, float] = field(default_factory=dict)  # every reading
    setup_phases: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)  # what the check saw

    @property
    def correct(self) -> bool:
        return (self.attempted > 0 and self.failed == 0 and bool(self.checks)
                and all(math.isfinite(v) and v <= lim
                        for v, lim in self.checks.values()))


def checks(values: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, tuple]:
    """Each compared number beside its limit (a number without a limit is
    not compared, and raises: the limits file and the driver disagree)."""
    missing = sorted(set(limits) - set(values))
    if missing:
        raise KeyError(f"no reading for the limits {missing}")
    return {name: (float(values[name]), float(limits[name]))
            for name in limits}


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """The plain reference's setting: float32 products in float32 (TF32
    off for matrix products and cuDNN convolutions), restored after."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Phases:
    """Host seconds of the named phases of set-up, each from the end of
    the one before (the first from the process's start)."""

    def __init__(self, t0: float):
        import time

        self.clock, self.last, self.seconds = time.perf_counter, t0, {}

    def mark(self, name: str) -> None:
        now = self.clock()
        self.seconds[name] = now - self.last
        self.last = now


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str) -> Callable:
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules(modules) -> List[str]:
    """The loaded modules whose top-level name is one the benchmark may not
    load (compared whole: ``ammcnet_aaai2021_torch`` is not
    ``ammcnet_aaai2021_tpu``)."""
    return sorted({m for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})
