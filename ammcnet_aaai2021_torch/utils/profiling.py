"""The port's spans and counters, and its trace exporter.

Port of ``ammcnet_aaai2021_tpu/utils/profiling.py``.  The reference's
only tracing is ad-hoc ``time.time()`` deltas (train_helper.py:286-293,
362-368, which even logs sec/frame under the name "fps", :423-426).

Here every span and counter of the port goes through this module, and
records only while a ``torch.profiler`` profile runs.  With none running,
:func:`span` returns one shared null context and :func:`count` returns,
after one check (``torch._C._autograd._profiler_enabled()``, a fraction of
a microsecond).  A span opens ``torch.profiler.record_function(name)``, so
it lies in the profiler's trace on the kernels' clock (a gap in a
timeline is named by the span open around it), and keeps a record in
memory: its name, the span open around it on its thread, the host clock
(``perf_counter_ns``) at its ends and, once CUDA is initialised, a pair of
CUDA events on the current stream.  :func:`summary` resolves the records
by name; :func:`counts` gives the counters; :func:`reset` clears both.

One-time set-up (:func:`add_setup`) runs once a process, so it is timed
always, on the host clock alone, and :func:`reset` keeps it.

The names, each at a layer boundary:

* ``int8.quantize`` (span; ``models/quantized.py``): a conv input's
  quantize and the padding that makes the kernel's input, an up level's
  skip concatenation and a down level's max-pool included; counters
  ``int8.inputs.resident`` (already int8), ``int8.inputs.static``
  (calibrated scale) and ``int8.inputs.dynamic``, and the quantize
  kernel's forms ``int8.pack.plain``, ``int8.pack.cat`` and
  ``int8.pack.pool``;
* ``train_step`` (``train/steps.py``) and its phases ``train_step.forward``,
  ``.teacher``, ``.discriminator``, ``.backward``, ``.optimizer``;
* ``train_loop.start``, ``.data_wait``, ``.fetch``, ``.stop``
  (``train/loop.py``);
* ``scorer.forward`` (``eval/export.py:ChunkScorer``), ``flow.extract``
  (``eval/infer.py:make_otf_flow_extractor``);
* inside ``flow.extract`` with FlowNet 2.0 (``models/flownet2.py``):
  ``flownet2.c``, ``.s1``, ``.s2``, ``.sd``, ``.fusion`` (each network's
  forward), ``flownet2.warp`` (each of the four warp blocks) and
  ``flownet2.correlation`` (the op's call, inside ``flownet2.c``); counters
  ``flownet2.pairs`` and the correlation's routes
  ``flownet2.correlation.kernel`` and ``.plain`` (``ops/correlation.py``);
* counters ``conv.layout.nhwc`` and ``conv.layout.nchw``
  (``models/blocks.py``): each ``Conv2d`` / ``ConvTranspose2d`` call, by
  its input's memory layout (the generator's channels-last on the card,
  FlowNet's and the discriminator's NCHW);
* ``setup.ops`` (set-up): ``ops/library.py``'s body and each kernel
  library's build or load (``ops/cuda_build.load``).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

TRACE_FILE = "trace.json"

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_records: List["_Span"] = []
_counts: Dict[str, int] = defaultdict(int)
_setup: Dict[str, List[float]] = {}  # name -> [calls, host seconds]


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """An open span, then its record."""

    __slots__ = ("name", "parent", "t0", "t1", "events", "device_s",
                 "_range")

    def __init__(self, name: str):
        self.name = name
        self.parent: Optional[_Span] = None
        self.events = self.device_s = None

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        self._range = None
        _stack().pop()
        _records.append(self)


def span(name: str):
    """The span ``name`` around a block: recorded while a profiler runs,
    the shared null context otherwise."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name)


class _Timed:
    __slots__ = ("name", "seconds", "_span", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "_Timed":
        self._span = _Span(self.name).__enter__() if _profiler_enabled() \
            else None
        self._t0 = (self._span.t0 if self._span is not None
                    else time.perf_counter_ns())
        return self

    def __exit__(self, *exc) -> None:
        if self._span is not None:
            self._span.__exit__(*exc)
            t1 = self._span.t1
        else:
            t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) / 1e9


def timed(name: str) -> _Timed:
    """A block's host seconds (``seconds``, after it), read always; while a
    profiler runs the block is also the span ``name``, whose record holds
    the same two clock readings: one measurement, two readers."""
    return _Timed(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if _profiler_enabled():
        with _lock:
            _counts[name] += n


def add_setup(name: str, t0_ns: int) -> None:
    """One-time set-up, profiler or not: the host seconds from the
    ``perf_counter_ns()`` reading ``t0_ns`` to now, added to ``name``."""
    seconds = (time.perf_counter_ns() - t0_ns) / 1e9
    with _lock:
        entry = _setup.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += seconds


def summary() -> Dict[str, Dict[str, Optional[float]]]:
    """By name: ``calls``, ``host_s``, ``device_s`` (the spans' CUDA events'
    elapsed time; None where a span has none) and ``self_device_s`` (less
    the device time of the spans directly inside).  Call it once the spans'
    work is done on the card (after a synchronise).  Set-up names have
    host seconds alone."""
    out: Dict[str, Dict[str, Optional[float]]] = {}
    records = list(_records)
    for rec in records:
        if rec.device_s is None and rec.events is not None:
            rec.device_s = rec.events[0].elapsed_time(rec.events[1]) / 1e3
            rec.events = None
    child_s: Dict[int, float] = defaultdict(float)
    for rec in records:
        if rec.parent is not None and rec.device_s is not None:
            child_s[id(rec.parent)] += rec.device_s
    for rec in records:
        s = out.setdefault(rec.name, {"calls": 0, "host_s": 0.0,
                                      "device_s": None,
                                      "self_device_s": None})
        s["calls"] += 1
        s["host_s"] += (rec.t1 - rec.t0) / 1e9
        if rec.device_s is not None:
            s["device_s"] = (s["device_s"] or 0.0) + rec.device_s
            s["self_device_s"] = ((s["self_device_s"] or 0.0) + rec.device_s
                                  - child_s[id(rec)])
    with _lock:
        for name, (calls, seconds) in _setup.items():
            out[name] = {"calls": calls, "host_s": seconds, "device_s": None,
                         "self_device_s": None}
    return out


def counts() -> Dict[str, int]:
    """The counters, by name."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Clear the spans' records and the counters (set-up stays)."""
    with _lock:
        _records.clear()
        _counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block with ``torch.profiler`` and write a Chrome trace
    to ``<log_dir>/trace.json`` (viewable in Perfetto or
    chrome://tracing), the port's spans in it; yields the profiler, whose
    ``key_averages()`` the caller may read after the block.  The registry
    is reset first, so :func:`summary` and :func:`counts` after the block
    cover it alone."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def card_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them for a CUDA ``device``
    (a card below its maximum power runs slower under load, so a time is
    kept beside it); ``"cpu"`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else 0
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]
