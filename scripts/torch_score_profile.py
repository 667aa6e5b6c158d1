#!/usr/bin/env python3
"""Where the time of one scoring batch of the PyTorch port goes on the card.

Builds the released generator (``unet_vq_twostream``, bf16, seeded random
weights) on the GPU, puts one video on the card (196 u8 frames of 256x256
and 195 flow fields: 192 five-frame windows), and runs the scorer's default
batch of 192 windows (gather, normalize, generator, per-frame metrics) as
run_test does.  Prints JSON lines:

* ``batch``: the first batch's seconds in the process (host clock, first
  use of every kernel), then milliseconds per batch by CUDA events over
  warm repeats, and the windows per second that gives;
* ``profile``: a ``torch.profiler`` trace of a few batches: device time by
  kernel (the largest first), grouped coarsely by kernel name, and the
  device's busy share of the traced wall time;
* ``host``: the host's steps for one video as ``score_dataset`` takes them
  (read the files, decode frames and flows on 8 threads, pad to the bucket,
  cast flows to bf16, pin, copy to the card), on one 180-frame video that
  ``chip_smoke.py``'s writer puts in a temporary directory; twice, the
  second pass reading from the page cache;
* ``runs``: ``run_test`` on the whole ped2-shaped split (12 videos, 2,010
  frames) three times in one process: the first run pays each new batch
  shape's first use on the card, the later ones show the steady state.

    python3 scripts/torch_score_profile.py [--reps 10]

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
WINDOWS = 192
FRAMES = WINDOWS + 4  # a 5-frame window starts at each of 192 frames
SIZE = 256

def host_phase(torch, dtype, card: str) -> None:
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ammcnet_aaai2021_torch.data.datasets import (VideoIndex, _decode_rgb,
                                                      load_flow)
    from ammcnet_aaai2021_torch.eval.infer import pad_video_to_bucket
    from chip_smoke import write_ped2_tree

    size = (SIZE, SIZE)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_ped2_tree(tmp, (180,))
        write_s = time.perf_counter() - t0
        split = os.path.join(tmp, "ped2", "testing")
        rgb_paths = VideoIndex(os.path.join(split, "frames")).videos["01"]
        op_paths = VideoIndex(os.path.join(split, "flows")).videos["01"]
        for attempt in range(2):
            s = {}
            t0 = time.perf_counter()
            nbytes = 0
            for path in rgb_paths + op_paths:
                with open(path, "rb") as fh:
                    nbytes += len(fh.read())
            s["read_bytes_s"] = time.perf_counter() - t0
            with ThreadPoolExecutor(max_workers=8) as pool:
                t0 = time.perf_counter()
                frames = np.stack(list(pool.map(
                    lambda p: _decode_rgb(p, size), rgb_paths)))
                s["decode_frames_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                flows = np.stack(list(pool.map(
                    lambda p: load_flow(p, size, True), op_paths)))
                s["decode_flows_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            frames, flows, _ = pad_video_to_bucket(frames, flows)
            s["pad_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rgb_h = torch.from_numpy(frames)
            op_h = torch.from_numpy(flows).to(dtype)
            s["cast_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rgb_h, op_h = rgb_h.pin_memory(), op_h.pin_memory()
            s["pin_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rgb_d = rgb_h.to("cuda", non_blocking=True)
            op_d = op_h.to("cuda", non_blocking=True)
            torch.cuda.synchronize()
            s["copy_to_card_s"] = time.perf_counter() - t0
            del rgb_d, op_d
            print(json.dumps({
                "phase": "host", "card": card, "pass": attempt + 1,
                "frames": len(rgb_paths), "flows": len(op_paths),
                "file_mb": nbytes / 1e6, "write_tree_s": write_s,
                "cpu_count": os.cpu_count(), **s,
                "total_s": sum(s.values())}), flush=True)


def runs_phase(torch, card: str, runs: int = 3) -> None:
    import contextlib
    import io
    import tempfile

    from ammcnet_aaai2021_torch.runners import run_test
    from chip_smoke import PED2_TEST_LENGTHS, write_ped2_tree

    with tempfile.TemporaryDirectory() as tmp:
        write_ped2_tree(tmp, PED2_TEST_LENGTHS)
        argv = ["--dataset_name", "ped2", "--data_dir", tmp,
                "--save_dir", os.path.join(tmp, "eval_out")]
        for i in range(runs):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = run_test.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(json.dumps({
                "phase": "runs", "card": card, "run": i + 1,
                "frames": sum(PED2_TEST_LENGTHS), "wall_s": wall,
                "run_test_fps": res["fps"]}), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_score_profile: needs a CUDA device")
    sys.path.insert(0, REPO)
    from ammcnet_aaai2021_torch.configs import NetConfig
    from ammcnet_aaai2021_torch.eval.infer import _make_score_batch
    from ammcnet_aaai2021_torch.models import build_generator, init_weights
    from ammcnet_aaai2021_torch.ops import cuda_build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    net = init_weights(build_generator(NetConfig(), per_sample_diff=True),
                       torch.Generator().manual_seed(20200525)).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(0)
    video = torch.randint(0, 256, (FRAMES, SIZE, SIZE, 3), device="cuda",
                          dtype=torch.uint8, generator=g)
    flows = (torch.randn(FRAMES - 1, SIZE, SIZE, 2, device="cuda", generator=g)
             * 0.01).to(net.dtype)
    idx = torch.arange(WINDOWS, device="cuda")
    score = _make_score_batch(net, 5, 4, 3, 2, "psnr", None, False)

    def batch():
        return score(video, flows, idx)

    # the nvcc builds stay out of the timings
    cuda_build.build(["quantize_topk", "quantize_topk_mma"])
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        for _ in range(2):
            batch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            batch()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        print(json.dumps({
            "phase": "batch", "card": card, "windows": WINDOWS,
            "image_size": SIZE, "dtype": str(net.dtype), "reps": args.reps,
            "first_batch_s": first_s, "ms_per_batch": ms,
            "windows_per_s": WINDOWS / ms * 1e3}),
            flush=True)

        from torch.profiler import ProfilerActivity, profile

        from kernel_trace import device_summary

        traced = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(traced):
                batch()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    print(json.dumps({"phase": "profile", "card": card, "batches": traced,
                      **device_summary(prof, wall_us, traced, "batch")}),
          flush=True)
    host_phase(torch, net.dtype, card)
    runs_phase(torch, card)


if __name__ == "__main__":
    main()
