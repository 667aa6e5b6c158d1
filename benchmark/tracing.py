"""The benchmark's own spans, CUDA-event timers and trace reduction.

Spans are ``torch.profiler.record_function`` ranges around the calls the
drivers make into the port's layers; they cost nothing unless a profiler
runs.  :class:`Segment` profiles a stretch of work (the CPU and the card,
``torch.profiler``), writes the Chrome trace into ``TMPDIR``, reads it
back and deletes it, and reduces it to what the per-layer metrics and the
result's ``breakdown`` read: device time by kernel name, the kernel-launch
calls, the device's busy time (the union of kernel, copy and memset
intervals) within the traced window, and its idle gaps labelled by the
host span that was open.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# coarse kernel groups, first match wins (lower-case name fragments; the
# table of the port's scripts/kernel_trace.py)
GROUPS = (
    ("memory lookup kernels (B1, B2)", ("quantize_topk", "prep_codebook",
                                        "ema_stats")),
    ("int8 convolution kernels", ("qconv_int8", "qconv_wgmma")),
    ("optimizer (Adam, foreach)", ("multi_tensor", "adam")),
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("convolution (fwd, dgrad, wgrad)", ("conv", "xmma", "gemm", "cutlass",
                                         "implicit", "winograd", "fft",
                                         "dgrad", "wgrad")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("pooling and upsampling", ("pool", "upsample")),
    ("reductions (statistics, losses)", ("reduce",)),
    ("elementwise (casts, ReLU, adds, copies)",
     ("elementwise", "vectorized", "unrolled", "cat", "copy", "index",
      "gather", "fill", "scatter")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SEGMENT = "segment"


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def span(name: str, enabled: bool):
    """A named host span, recorded only while a profiler runs."""
    return (torch.profiler.record_function(name) if enabled
            else contextlib.nullcontext())


class Timers:
    """CUDA-event timings of named calls (the host clock on the CPU),
    resolved once the work is done."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending: Dict[str, List] = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.pending[name].append((start, end))
        else:
            import time
            t0 = time.perf_counter()
            yield
            self.pending[name].append(time.perf_counter() - t0)

    def seconds(self) -> Dict[str, List[float]]:
        out = {}
        for name, items in self.pending.items():
            out[name] = [e[0].elapsed_time(e[1]) / 1e3 if self.cuda else e
                         for e in items]
        return out


class TraceSummary:
    """What a traced segment showed.  Times in seconds."""

    def __init__(self, events: List[dict]):
        seg = [e for e in events if e.get("name") == SEGMENT
               and e.get("cat") == "user_annotation"]
        if not seg:
            raise RuntimeError("the trace holds no segment span")
        t0 = float(seg[0]["ts"])
        t1 = t0 + float(seg[0]["dur"])
        self.window_s = (t1 - t0) / 1e6
        self.kernels: Dict[str, List[float]] = {}
        busy: List[Tuple[float, float]] = []
        self.launches = 0
        spans = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat"), float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
            if ts + dur < t0 or ts > t1:
                continue
            if cat in DEVICE_CATS:
                busy.append((max(ts, t0), min(ts + dur, t1)))
                if cat == "kernel":
                    k = self.kernels.setdefault(e["name"], [0, 0.0])
                    k[0] += 1
                    k[1] += dur / 1e6
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "LaunchKernel" in e["name"] or e["name"] == "cuLaunchKernelEx":
                    self.launches += 1
            elif cat == "user_annotation" and e["name"] != SEGMENT:
                spans.append((ts, ts + dur, e["name"]))
        busy.sort()
        merged: List[List[float]] = []
        for a, b in busy:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        gaps, prev = [], t0
        for a, b in merged:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if t1 > prev:
            gaps.append((prev, t1))
        spans.sort(key=lambda s: s[1] - s[0])  # innermost first
        labelled = []
        for a, b in gaps:
            label = next((name for s0, s1, name in spans if s0 <= a < s1),
                         "loop")
            labelled.append((label, (b - a) / 1e6))
        labelled.sort(key=lambda g: -g[1])
        self.idle_gaps = [[n, s] for n, s in labelled[:10]]

    def kernel_time(self, pattern) -> Tuple[int, float]:
        """(calls, seconds) of the kernels whose name matches the compiled
        regular expression ``pattern``."""
        calls, secs = 0, 0.0
        for name, (n, s) in self.kernels.items():
            if pattern.search(name):
                calls += n
                secs += s
        return calls, secs

    def device_ops(self) -> List[list]:
        groups: Dict[str, float] = defaultdict(float)
        for name, (_, s) in self.kernels.items():
            groups[group_of(name)] += s
        top = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
        return [[g, s] for g, s in top]


class Segment:
    """Profile the block (CPU and CUDA activity) inside a ``segment`` span;
    ``summary`` holds the :class:`TraceSummary` after it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.summary: Optional[TraceSummary] = None

    @contextlib.contextmanager
    def run(self) -> Iterator[None]:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(SEGMENT):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = TraceSummary(events)
