#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``ammcnet_aaai2021_torch``).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py            # the whole check, 12 ped2-shaped videos
    python3 chip_smoke.py --videos 2 # a shorter main path

Phases, one JSON line each; any failure exits non-zero:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles every CUDA kernel of the path from ``csrc/`` (nvcc);
3. kernel check: each kernel against its plain PyTorch version on the card
   at the main path's shapes, plus edge cases, with CUDA-event timings and
   the card's bound for the same work;
4. model check: the released generator on a small 256x256 batch, its
   memory lookups in the kernel and in plain PyTorch, in float32 and bf16;
5. main path: ``runners.run_test.main`` scores a ped2-shaped test split
   (12 videos, 2,010 frames of 256x256) with the released configuration,
   bf16 and seeded random weights; checks the records, the AUC line and that
   every kernel of the path was launched (two memory lookups per forward);
6. the ``kernels`` summary line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bandwidth, and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# UCSD Ped2 test split: frames per video (eval/gt.py labels these lengths)
PED2_TEST_LENGTHS = (180, 180, 150, 180, 150, 180, 180, 180, 120, 150, 180,
                     180)
# its 1-indexed inclusive abnormal ranges (eval/gt.py PED2_EVENTS)
PED2_EVENTS = ((61, 180), (95, 180), (1, 146), (31, 180), (1, 129), (1, 159),
               (46, 180), (1, 180), (1, 120), (1, 150), (1, 180), (88, 180))
IMAGE_SIZE = 256
# near-tie rule: a top-k index may differ between two fp32 implementations
# only where the two candidates' float64 distances differ by less than this
NEAR_TIE_REL = 1e-5
# the generator with the kernel against the generator with the plain lookup:
# the same codewords feed the same convolutions, so only run-to-run
# differences of the convolutions remain
MODEL_TOL = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` warm calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_lookup(torch, mk, flat, embed, k: int) -> dict:
    """Kernel vs plain version on the same inputs, under the near-tie rule.

    Rows whose top-1 index and all k codewords agree must match bitwise; a
    row that differs is a flip, allowed only where each differing round's
    two codewords lie at float64 distances within ``NEAR_TIE_REL``."""
    q, q1, idx = mk.quantize_topk_fused(flat, embed, k)
    torch.cuda.synchronize()
    rq, rq1, ridx = mk.quantize_topk_fused_ref(flat, embed, k)
    n, dim = flat.shape
    if not (q.shape == rq.shape and q1.shape == rq1.shape
            and idx.shape == ridx.shape and idx.dtype == torch.int32):
        fail(f"kernel output shapes {q.shape} {q1.shape} {idx.shape} "
             f"vs plain {rq.shape} {rq1.shape} {ridx.shape}")
    if not torch.equal(q1, q[:, :dim]):
        fail("kernel q1 differs from the first codeword block of q_topk")
    agree = (idx == ridx) & (q == rq).all(dim=1)
    z64 = flat.double()
    worst_gap = 0.0
    for j in range(k):
        ck = q[:, j * dim:(j + 1) * dim].double()
        cp = rq[:, j * dim:(j + 1) * dim].double()
        differ = (ck != cp).any(dim=1) & ~agree
        if not differ.any():
            continue
        dk = (z64[differ] - ck[differ]).square().sum(1)
        dp = (z64[differ] - cp[differ]).square().sum(1)
        rel = (dk - dp).abs() / torch.maximum(dk.abs(), dp.abs()).clamp_min(1e-300)
        worst_gap = max(worst_gap, float(rel.max()))
        if worst_gap >= NEAR_TIE_REL:
            fail(f"top-k round {j}: kernel and plain pick codewords whose "
                 f"float64 distances differ by {worst_gap:.3g} relative "
                 f"(>= {NEAR_TIE_REL}): not a near-tie")
    max_err = 0.0
    if agree.any():
        max_err = max(float((q[agree] - rq[agree]).abs().max()),
                      float((q1[agree] - rq1[agree]).abs().max()))
    if max_err != 0.0:
        fail(f"rows whose indices agree differ by {max_err} (must be bitwise equal)")
    return {"rows": n, "flips": int((~agree).sum()),
            "flip_max_rel_gap": worst_gap, "max_abs_err": max_err,
            "q": q, "idx": idx}


def lookup_bound(n: int, dim: int, n_embed: int, k: int, in_bytes: int
                 ) -> dict:
    """The least time the card could take: compulsory bytes over HBM
    bandwidth vs the distance FLOPs over the fp32 (non-tensor) peak."""
    bytes_moved = (n * dim * in_bytes + dim * n_embed * 4
                   + n * k * dim * 4 + n * dim * 4 + n * 4)
    flops = 2 * n * dim * n_embed
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS * 1e3
    return {
        "bytes": bytes_moved, "flops": flops,
        "arithmetic": (
            f"bytes = N*dim*{in_bytes} + dim*n_embed*4 + N*k*dim*4 + N*dim*4"
            f" + N*4 = {bytes_moved:,}; / 3.35e12 B/s = {bytes_ms:.5f} ms. "
            f"flops = 2*N*dim*n_embed = {flops:,}; / 67e12 FLOP/s = "
            f"{flops_ms:.5f} ms"),
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms > flops_ms else "operations",
    }


def kernel_phase(torch, mk) -> dict:
    """B1 at the main path's shape (N = 192 windows * 32 * 32 rows, dim 64,
    n_embed 256, k 2) in bf16 and f32, plus a ragged N, a codebook with
    duplicated codewords and the 512-codeword size."""
    g = torch.Generator(device="cuda").manual_seed(0)
    n, dim, n_embed, k = 192 * 32 * 32, 64, 256, 2
    embed = torch.randn(dim, n_embed, device="cuda", generator=g)
    z32 = torch.randn(n, dim, device="cuda", generator=g) * 0.5
    out = {}
    for name, flat in (("bfloat16", z32.to(torch.bfloat16)),
                       ("float32", z32)):
        res = compare_lookup(torch, mk, flat, embed, k)
        timings = []
        for fn in (mk.quantize_topk_fused_ref, mk.quantize_topk_fused,
                   mk.quantize_topk_fused, mk.quantize_topk_fused_ref):
            timings.append(time_ms(torch, lambda: fn(flat, embed, k)))
        bound = lookup_bound(n, dim, n_embed, k, flat.element_size())
        out[name] = {
            "shape": [n, dim, n_embed, k], "rows": res["rows"],
            "flips": res["flips"], "flip_max_rel_gap": res["flip_max_rel_gap"],
            "max_abs_err": res["max_abs_err"],
            "kernel_ms": (timings[1] + timings[2]) / 2,
            "plain_ms": (timings[0] + timings[3]) / 2,
            "timings_plain_kernel_kernel_plain_ms": timings, **bound}
        emit("kernel_check", kernel="quantize_topk_fused", input=name,
             **out[name])

    ragged = compare_lookup(torch, mk, z32[:1037].to(torch.bfloat16), embed, k)
    emit("kernel_check", kernel="quantize_topk_fused", input="ragged N=1037 bf16",
         flips=ragged["flips"], max_abs_err=ragged["max_abs_err"])

    # duplicated codewords: columns 2m and 2m+1 equal, so every distance
    # ties; the lowest index must win round 1 and its twin round 2
    dup = embed.clone()
    dup[:, 1::2] = dup[:, 0::2]
    res = compare_lookup(torch, mk, z32[:65536], dup, k)
    if bool((res["idx"] % 2 != 0).any()):
        fail("tie-break: the kernel picked the higher index of equal codewords")
    if not torch.equal(res["q"][:, :dim], res["q"][:, dim:]):
        fail("tie-break: round 2 did not pick the equal twin of round 1")
    emit("kernel_check", kernel="quantize_topk_fused",
         input="duplicated codewords f32", lowest_index_wins=True,
         flips=res["flips"], max_abs_err=res["max_abs_err"])

    big = torch.randn(dim, 512, device="cuda", generator=g)
    res = compare_lookup(torch, mk, z32[:4096], big, k)
    emit("kernel_check", kernel="quantize_topk_fused", input="n_embed=512 f32",
         flips=res["flips"], max_abs_err=res["max_abs_err"])
    return out


def model_phase(torch, mk) -> None:
    """The released generator on a small input at 256x256, its memory
    lookups in the kernel and in plain PyTorch (``use_memory_kernel=False``):
    the same codewords, so the same outputs, in float32 (TF32 off) and in
    the main path's bfloat16."""
    import dataclasses

    from ammcnet_aaai2021_torch.configs import NetConfig
    from ammcnet_aaai2021_torch.models import build_generator, init_weights

    g = torch.Generator(device="cuda").manual_seed(1)
    rgb = torch.rand(4, 12, IMAGE_SIZE, IMAGE_SIZE, device="cuda",
                     generator=g) * 2 - 1
    op = torch.randn(4, 6, IMAGE_SIZE, IMAGE_SIZE, device="cuda",
                     generator=g) * 0.01
    for dtype in ("float32", "bfloat16"):
        outs = []
        for use_kernel in (True, False):
            cfg = dataclasses.replace(NetConfig(), dtype=dtype,
                                      use_memory_kernel=use_kernel)
            net = init_weights(build_generator(cfg, per_sample_diff=True),
                               torch.Generator().manual_seed(20200525))
            net = net.to("cuda").eval()
            before = mk.quantize_topk_fused.launches
            with torch.inference_mode():
                rgb_pred, op_pred, diffs, codes = net(rgb, op)
            torch.cuda.synchronize()
            launched = mk.quantize_topk_fused.launches - before
            if launched != (2 if use_kernel else 0):
                fail(f"{dtype} generator (use_memory_kernel={use_kernel}) "
                     f"launched the kernel {launched} times")
            outs.append([rgb_pred, op_pred, *diffs, *codes])
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(*outs))
        if err > MODEL_TOL:
            fail(f"{dtype} generator: kernel route and plain route differ by "
                 f"{err} (> {MODEL_TOL})")
        emit("model_check", dtype=dtype, batch=4, image_size=IMAGE_SIZE,
             max_abs_err=err, tol=MODEL_TOL)


def write_ped2_tree(root: str, lengths) -> None:
    """A ped2-shaped test split of numpy files: <root>/ped2/testing/
    {frames,flows}/NN/, grayscale frames as 3 equal u8 channels (.npy) and
    T-1 float32 flow fields per video (.npy), from a fixed seed."""
    import numpy as np

    rng = np.random.default_rng(20200525)
    s = IMAGE_SIZE
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    for vi, length in enumerate(lengths, start=1):
        fdir = os.path.join(root, "ped2", "testing", "frames", f"{vi:02d}")
        odir = os.path.join(root, "ped2", "testing", "flows", f"{vi:02d}")
        os.makedirs(fdir)
        os.makedirs(odir)
        base = 96 + 48 * np.sin((xx + 7 * vi) / 23.0) * np.cos(yy / 31.0)
        for t in range(length):
            blob = 80 * np.exp(-((xx - (2 * t) % s) ** 2
                                 + (yy - s / 2) ** 2) / 300.0)
            noise = rng.normal(0, 4, (s, s))
            gray = np.clip(base + blob + noise, 0, 255).astype(np.uint8)
            np.save(os.path.join(fdir, f"{t:03d}.npy"),
                    np.repeat(gray[..., None], 3, axis=2))
            if t + 1 < length:
                np.save(os.path.join(odir, f"{t:03d}.npy"),
                        rng.normal(0, 1.5, (s, s, 2)).astype(np.float32))


def main_path_phase(torch, mk, n_videos: int) -> dict:
    import numpy as np

    from ammcnet_aaai2021_torch.runners import run_test

    lengths = PED2_TEST_LENGTHS[:n_videos]
    if n_videos < len(PED2_TEST_LENGTHS):
        emit("main_path_cut", videos=n_videos, of=len(PED2_TEST_LENGTHS),
             note="fewer videos; frame size and model widths unchanged")
    window_batch = 192  # run_test's default for the video scorer
    forwards = sum(math.ceil((t - 4) / min(window_batch, t - 4))
                   for t in lengths)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_ped2_tree(tmp, lengths)
        data_s = time.perf_counter() - t0
        dataset = "ped2"
        if n_videos < len(PED2_TEST_LENGTHS):
            # the builtin ped2 labels need all 12 videos: a cut run carries
            # its videos' ped2 events in the toydata label format instead
            dataset = "toydata"
            os.rename(os.path.join(tmp, "ped2"), os.path.join(tmp, dataset))
            with open(os.path.join(tmp, dataset, "toydata.json"), "w") as fh:
                json.dump({f"{vi:02d}": {"length": t, "gt": [[s - 1, e - 1]]}
                           for vi, (t, (s, e)) in enumerate(
                               zip(lengths, PED2_EVENTS), start=1)}, fh)
        argv = ["--dataset_name", dataset, "--data_dir", tmp,
                "--save_dir", os.path.join(tmp, "eval_out")]
        stdout = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.quantize_topk_fused.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            res = run_test.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = mk.quantize_topk_fused.launches
        printed = stdout.getvalue()
        print(printed, end="", flush=True)
        with open(res["pickle"], "rb") as fh:
            records = pickle.load(fh)
    if "the optimal auc = " not in printed:
        fail("run_test printed no 'the optimal auc =' line")
    for key in ("rgb_img_pred_records", "rgb_fea_comm_records",
                "op_img_pred_records", "op_fea_comm_records"):
        got = [len(r) for r in records[key]]
        if got != list(lengths):
            fail(f"{key}: lengths {got}, want {list(lengths)}")
        if not all(np.isfinite(r).all() for r in records[key]):
            fail(f"{key}: non-finite scores")
    if launches != 2 * forwards:
        fail(f"quantize_topk kernel launched {launches} times in the main "
             f"path, want 2 per forward = {2 * forwards}")
    frames = sum(lengths)
    out = {"videos": len(lengths), "frames": frames, "forwards": forwards,
           "window_batch": window_batch, "wall_s": wall,
           "frames_per_s": frames / wall, "run_test_fps": res["fps"],
           "auc": res["auc"], "quantize_topk_launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "data_write_s": data_s}
    emit("main_path", **out)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--videos", type=int, default=len(PED2_TEST_LENGTHS),
                        help="ped2-shaped videos in the main path (cut only "
                             "to fit a time limit)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs the card")
    sys.path.insert(0, REPO)
    from ammcnet_aaai2021_torch.ops import cuda_build
    from ammcnet_aaai2021_torch.ops import memory_kernels as mk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("environment", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    seconds = cuda_build.build(["quantize_topk"])
    ptxas = [line.strip() for log in cuda_build.build_log.values()
             for line in log.splitlines()
             if "entry function" in line or "registers" in line
             or "spill" in line]
    emit("build", seconds=time.perf_counter() - t0, per_source=seconds,
         ptxas=ptxas)

    # the float32 comparisons run with TF32 off (cuDNN's convolutions take
    # it by default); the main path runs with the library's defaults
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = kernel_phase(torch, mk)
    model_phase(torch, mk)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    main_run = main_path_phase(torch, mk, args.videos)

    bf16 = checks["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "quantize_topk_fused",
        "route": "cuda",
        "source": "ammcnet_aaai2021_torch/csrc/quantize_topk.cu",
        "replaces": "ammcnet_aaai2021_tpu/ops/memory_pallas.py:48",
        "launches": main_run["quantize_topk_launches"],
        "max_abs_err": max(bf16["max_abs_err"],
                           checks["float32"]["max_abs_err"]),
        "flips": bf16["flips"] + checks["float32"]["flips"],
        "ms": bf16["kernel_ms"],
        "kernel_ms": bf16["kernel_ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
