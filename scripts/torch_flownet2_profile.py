#!/usr/bin/env python3
"""Where FlowNet 2.0's time goes on the card, and its correlation kernel.

1. The correlation kernel (``ops/correlation.py``) at FlowNet 2.0's shape
   for 256x256 frames, (16, 256, 32, 32) and the ragged (15, 256, 32, 32):
   ``--reps`` launches between CUDA events, beside the card's bound
   (``benchmark/counts/flownet2.py``) and one call of the plain version.
2. One 16-pair bf16 forward of ``models/flownet2.py:FlowNet2`` (seeded
   weights): the host's enqueue time, and the device time of each span
   (``flownet2.c``, ``.s1``, ``.s2``, ``.sd``, ``.fusion``, ``.warp``,
   ``.correlation``) with the card held behind a sleep kernel while the
   host enqueues the forward, so that no span waits on the host; the
   forward's own device time likewise, over ``--reps`` forwards.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/torch_flownet2_profile.py [--reps 20] [--pairs 16]

Prints the card's name and power limit, then one JSON line a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from ammcnet_aaai2021_torch.models import FlowNet2, init_flownet_weights  # noqa: E402
from ammcnet_aaai2021_torch.ops import correlation as corr  # noqa: E402
from ammcnet_aaai2021_torch.utils import profiling  # noqa: E402
from benchmark.counts import flownet2 as counts  # noqa: E402

SPANS = ("flownet2.c", "flownet2.correlation", "flownet2.s1", "flownet2.s2",
         "flownet2.sd", "flownet2.fusion", "flownet2.warp")
# cycles of the sleep kernel that holds the card while the host enqueues
HOLD_CYCLES = 2_000_000_000


def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES // 10)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def correlation_rows(reps: int):
    dev = torch.device("cuda")
    for b in (16, 15):
        g = torch.Generator(device=dev).manual_seed(b)
        f1, f2 = (torch.randn(b, 256, 32, 32, generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        ms = _events_ms(lambda: corr.correlation(f1, f2, True), reps)
        corr.correlation_ref(f1, f2, True)  # the allocator's first growth
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        corr.correlation_ref(f1, f2, True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bound_ms = counts.correlation_bound_s(b) * 1e3
        yield {"what": "correlation_kernel", "shape": [b, 256, 32, 32],
               "card_ms": ms, "bound_ms": bound_ms,
               "roofline_pct": 100 * bound_ms / ms, "plain_ms": plain_ms}


def flownet2_rows(reps: int, pairs: int):
    dev = torch.device("cuda")
    net = init_flownet_weights(FlowNet2(), torch.Generator().manual_seed(0))
    net = net.to(dev).eval().requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(1)
    frames = torch.rand(pairs, 3, 2, 256, 256, generator=g, device=dev) * 255
    with torch.inference_mode():
        ms = _events_ms(lambda: net(frames), reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            net(frames)
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        yield {"what": "flownet2_forward", "pairs": pairs, "card_ms": ms,
               "host_enqueue_ms": enqueue_ms,
               "gflop": pairs * counts.pair_flops(256) / 1e9,
               "tflops": pairs * counts.pair_flops(256) / ms / 1e9}
        with profiling.device_trace(os.path.join(REPO, "build",
                                                 "flownet2_trace")):
            for _ in range(3):
                torch.cuda._sleep(HOLD_CYCLES)
                net(frames)
        s = profiling.summary()
        yield {"what": "flownet2_spans_ms_per_forward",
               **{k: s[k]["device_s"] * 1e3 / 3 for k in SPANS if k in s}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--pairs", type=int, default=16)
    args = p.parse_args(argv)
    print(profiling.card_name("cuda"), flush=True)
    for row in correlation_rows(args.reps):
        print(json.dumps(row), flush=True)
    for row in flownet2_rows(args.reps, args.pairs):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
