#!/usr/bin/env python3
"""Where the time of one stage-2 training step of the PyTorch port goes on
the card.

Builds what ``run_train`` trains with its defaults (the released
``unet_vq_twostream`` generator, the PatchGAN discriminator and a seeded
random FlowNet2-SD teacher, bf16, batch 4, 256x256, Adam), puts one random
batch on the card (u8 frames, f32 flows, frame-packed as the data layer
emits them) and runs ``make_twostream_train_step`` on it.  The batch stays
on the card, so the data layer is out of these numbers.  Prints JSON lines:

* ``step``: the first step's seconds in the process (host clock), then
  milliseconds per step by CUDA events over warm repeats, the host's
  milliseconds to enqueue one step (the step returns before the card
  finishes), and the steps per second that gives;
* ``profile``: a ``torch.profiler`` trace of a few steps: device time by
  kernel group and the largest kernels, and the device's busy share of the
  traced wall time.

    python3 scripts/torch_train_profile.py [--reps 20]

Needs one NVIDIA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SIZE = 4, 256

def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_train_profile: needs a CUDA device")
    sys.path.insert(0, REPO)
    from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
    from ammcnet_aaai2021_torch.models import build_model, init_flownet_weights
    from ammcnet_aaai2021_torch.ops import cuda_build
    from ammcnet_aaai2021_torch.train.state import create_train_state
    from ammcnet_aaai2021_torch.train.steps import make_twostream_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    model = build_model(NetConfig(), mode="training")
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 20200525, device="cuda")
    flownet = init_flownet_weights(model.flow_network,
                                   torch.Generator().manual_seed(7))
    flownet.to("cuda").eval().requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"rgb": torch.randint(0, 256, (BATCH, 5, SIZE, SIZE, 3),
                                  device="cuda", dtype=torch.uint8, generator=g),
             "op": torch.randn(BATCH, 4, SIZE, SIZE, 2, device="cuda",
                               generator=g) * 0.01}
    step = make_twostream_train_step(LossConfig())

    # the nvcc builds stay out of the timings
    cuda_build.build(["quantize_topk", "quantize_topk_mma"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch, flownet)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for _ in range(3):
        step(state, batch, flownet)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    enqueue = 0.0
    start.record()
    for _ in range(args.reps):
        t0 = time.perf_counter()
        step(state, batch, flownet)
        enqueue += time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.reps
    print(json.dumps({
        "phase": "step", "card": card, "batch": BATCH, "image_size": SIZE,
        "dtype": "bfloat16", "reps": args.reps, "first_step_s": first_s,
        "ms_per_step": ms, "host_enqueue_ms_per_step": enqueue / args.reps * 1e3,
        "steps_per_s": 1e3 / ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
        flush=True)

    from torch.profiler import ProfilerActivity, profile

    from kernel_trace import device_summary

    traced = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            step(state, batch, flownet)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    print(json.dumps({"phase": "profile", "card": card, "steps": traced,
                      **device_summary(prof, wall_us, traced, "step")}),
          flush=True)

if __name__ == "__main__":
    main()
