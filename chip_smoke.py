#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``ammcnet_aaai2021_torch``).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py            # the whole check, 12 ped2-shaped videos
    python3 chip_smoke.py --videos 2 # a shorter scoring path

Phases, one JSON line each; any failure exits non-zero:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles every CUDA source of the paths from ``csrc/`` (nvcc):
   the memory kernels, the GPU JPEG route (the host Huffman decode and the
   IDCT, colour and resize kernels) and the int8 convolutions;
3. kernel check: each kernel (B1, the inference memory lookup, and B2, the
   training lookup with the EMA statistics, each on its tensor-core route
   for bf16 latents of width 64 and its general route, key ``cuda_core``,
   for float32: any width, codebook and k, its distances on the tensor
   cores at float32 accuracy too) against its plain PyTorch version on the
   card at the paths' shapes, plus edge cases, with the device time of
   each (CUDA graphs timed by CUDA events), the kernel's back-to-back eager
   time (host work included), the card's bound for the same work, and for
   the bf16 cases the general-route kernel's device time on the same input;
   for B2 also B1's lookup alone (``lookup_ms``), the statistics' rest
   (``stats_ms``) and the most picked codeword's share of the rows
   (``top1_max_share``); B2's lookup must be bitwise B1's; then the general
   route at the shapes the first CUDA-core kernel raised for
   (``c1_check``: n_embed 100, 256, 512 and 1024, width 128, k 1, 2, 8, 16
   and k = n_embed, float32 and bf16, ragged N; B2's lookup bitwise B1's),
   timed at n_embed 1024 (k 2) and at k 16 (n_embed 256);
4. model check: the released generator on a small 256x256 batch, its
   memory lookups in the kernel and in plain PyTorch, in float32 and bf16:
   the lookups' indices first, then the outputs of the samples whose
   indices all agree;
5. scoring path: ``runners.run_test.main`` scores a ped2-shaped test split
   (12 videos, 2,010 frames of 256x256) with the released configuration,
   bf16 and seeded random weights; checks the records, the AUC line and that
   every kernel of the path was launched (two memory lookups per forward,
   all on B1's tensor-core route); then ``int8_path``: ``run_test --int8
   --calib_clips 32`` on the same split with a training split, its records
   checked and correlated with the bf16 run's, every 3x3 and transposed
   conv launched through the int8 kernels and B1 twice a forward; then the
   same command again with every int8 kernel call of the first forward at
   each of its batch sizes (the calibration's 8 windows, each video
   length's) held against its plain version, accumulators and output
   bitwise, and each distinct launch of the largest forward timed on its
   real inputs beside its bound, cuDNN's bf16 convolution of the shape
   and ``torch._int_mm`` of its product (the 3x3 conv's im2col'd, the
   im2col outside the timed window);
6. train check: one float32 training step of the released generator at
   256x256, batch 4, through the kernels and through plain PyTorch;
7. training path: ``runners.run_train.main`` trains the released
   configuration (bf16, batch 4, 256x256) for 30 steps on a numpy training
   tree, then resumes from its step-30 checkpoint to step 40; checks the
   scalars, the codebook, the checkpoint and the kernels' launches (B2 twice
   per step, B1 twice per train-PSNR forward, all on the tensor-core
   route);
8. the stage-1 path: ``runners.run_train.main`` runs the released recipe
   from stage 1 at full width (bf16, batch 4, 256x256): stage 1 rgb and op
   on the device-resident backend, 20 steps each, then stage 2
   ``--pretrain`` from both step dirs on the framepack backend (a pack the
   script writes with ``pack_video_tree``) for 10 steps, then 5 stage-1
   steps at ``--n_embed 1024`` and 5 at ``--k 16``; each run logs finite
   scalars and moves its codebook, every B2 launch of the
   released-configuration runs takes the tensor-core route and those of
   the n_embed 1024 and k 16 runs the CUDA-core route;
9. the raw-video path (``raw_path``): ``c2_check`` first (the IDCT kernel
   against its plain version on the fixture's coefficients, bitwise and
   timed, and on the card tests' seeded sweep of 24 geometries, bitwise;
   the fixture's GPU decode, gray and colour, bitwise the committed
   host-libjpeg reference (RGB, three channels a grayscale frame) at
   source size and 256x256, and likewise its progressive (SOF2) and
   arithmetic-coded progressive (SOF10) JPEGs, ``gray_c5.jpg`` (C5: channel
   0 with the host's own rounding), the progressive files libjpeg
   block-smooths (C6) and the truncated files (C7)), then the GPU JPEG
   route's kernels against their plain versions (the resize at the paths'
   shapes, gray to RGB timed against ``F.interpolate`` on three and on one
   channel, and on a sweep of 30 seeded random sizes; the colour kernel on
   a 32-frame 4:2:0 360x640 chunk in one launch and on one frame, timed,
   and on the card tests' sweep of 4:4:4, 4:2:2 and 4:2:0 chunks at odd
   sizes, bitwise), its decode of the committed fixture against cv2's,
   the extractor in float32 on the card against the CPU; then a ped2-shaped
   raw split (12 videos of Ped2's lengths, 240x360 grayscale JPEGs from the
   fixture, 240x360 ``.flo`` flows) scored by ``run_test.main`` three times
   with the released configuration: ``--native_loader`` (JPEG + ``.flo``),
   ``--native_loader --on_the_fly_flow --gray_upload`` (no flow files) and
   ``--native_loader --on_the_fly_flow``; the last two give bitwise equal
   records (cuDNN deterministic); then an Avenue-shaped colour split (its
   last 4 test videos, 891 frames, 360x640 colour JPEGs from the fixture)
   scored by ``--native_loader --on_the_fly_flow``, one colour conversion a
   32-frame chunk; then the host's seconds a video: the GPU decode, its
   host entropy decode (the decoder's own clock) and that share, and the
   same 180-frame videos through ``decode_coefs`` on the decoder's threads;
10. the whole run's seconds, the ``kernels`` summary line, then the last
   line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import io
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bandwidth, dense bf16 and int8 on the tensor cores, float32 outside
# them.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
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
# B2's embed_sum against the plain version's: the same float32 values summed
# in another order, so within this much of the magnitude summed into each
# entry
ESUM_REL = 1e-5
# one float32 train step through the kernels against one through plain
# PyTorch (cuDNN deterministic, TF32 off): the same codewords, so the losses
# agree to float32 rounding; the codebooks differ by embed_sum's order
TRAIN_LOSS_REL = 1e-6
TRAIN_CODEBOOK_TOL = 1e-5
# the training path: 4 ped2-shaped videos of 60 frames, 30 steps + 10 resumed
TRAIN_VIDEOS, TRAIN_FRAMES = 4, 60
TRAIN_STEPS, RESUME_STEPS = 30, 40


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` warm calls issued back to
    back (CUDA events).  Where the host takes longer to issue a call than
    the card to run it, this is the host's time per call."""
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


def graph_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call: ``calls`` calls captured in one CUDA
    graph, the graph replayed ``replays`` times between CUDA events.  The
    replay issues no host work per call (argument checks, ctypes, tensor
    allocation), so this is the card's time for the call's kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (calls * replays)


def time_pair(torch, kernel, plain, *args) -> dict:
    """Device time (CUDA graphs) of kernel and plain version, in the order
    plain, kernel, kernel, plain, plus the kernel's back-to-back eager time
    (host work per call included)."""
    timings = [graph_ms(torch, lambda: fn(*args))
               for fn in (plain, kernel, kernel, plain)]
    return {"kernel_ms": (timings[1] + timings[2]) / 2,
            "plain_ms": (timings[0] + timings[3]) / 2,
            "timings_plain_kernel_kernel_plain_ms": timings,
            "kernel_eager_ms": time_ms(torch, lambda: kernel(*args))}


def compare_lookup(torch, kernel, plain, flat, embed, k: int) -> dict:
    """Kernel vs plain version on the same inputs, under the near-tie rule
    of :func:`compare_outputs`; ``kernel`` and ``plain`` return
    ``(q_topk, q1, idx, ...)`` (B1 or B2)."""
    out = kernel(flat, embed, k)
    torch.cuda.synchronize()
    ref = plain(flat, embed, k)
    return {**compare_outputs(torch, flat, out, ref, k), "out": out,
            "ref": ref}


def compare_outputs(torch, flat, out, ref, k: int) -> dict:
    """Two lookups' ``(q_topk, q1, idx, ...)`` on the same latents.  Rows
    whose top-1 index and all k codewords agree must match bitwise; a row
    that differs is a flip, allowed only where each differing round's two
    codewords lie at float64 distances within ``NEAR_TIE_REL``."""
    (q, q1, idx), (rq, rq1, ridx) = out[:3], ref[:3]
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
            fail(f"top-k round {j}: the two lookups pick codewords whose "
                 f"float64 distances differ by {worst_gap:.3g} relative "
                 f"(>= {NEAR_TIE_REL}): not a near-tie")
    max_err = 0.0
    if agree.any():
        max_err = max(float((q[agree] - rq[agree]).abs().max()),
                      float((q1[agree] - rq1[agree]).abs().max()))
    if max_err != 0.0:
        fail(f"rows whose indices agree differ by {max_err} (must be bitwise equal)")
    return {"rows": n, "flips": int((~agree).sum()),
            "flip_max_rel_gap": worst_gap, "max_abs_err": max_err}


def public(res: dict) -> dict:
    """A comparison's numbers, without its tensors, for a JSON line."""
    return {k: v for k, v in res.items()
            if k not in ("out", "ref", "idx", "counts")}


def tensor_products(in_bytes: int) -> int:
    """bf16 tensor-core products per latent-codeword product at float32
    accuracy: the codebook split into three bf16 parts (hi, mid, lo) against
    bf16 latents; float32 latents split likewise keep six of the nine
    cross products (hi*hi, hi*mid, mid*hi, hi*lo, lo*hi, mid*mid)."""
    return 3 if in_bytes == 2 else 6


def bound(bytes_moved: int, flops: int, bytes_formula: str,
          flops_formula: str, peak: float = BF16_TENSOR_FLOPS,
          peak_name: str = "bf16 tensor cores") -> dict:
    """The least time the card could take: compulsory bytes over HBM
    bandwidth vs the operations over ``peak`` (by default the bf16
    tensor-core peak)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / peak * 1e3
    return {
        "bytes": bytes_moved, "flops": flops,
        "arithmetic": (
            f"bytes = {bytes_formula} = {bytes_moved:,}; / 3.35e12 B/s = "
            f"{bytes_ms:.5f} ms. operations = {flops_formula} = {flops:,}; "
            f"/ {peak:.3g} per s ({peak_name}) = {flops_ms:.5f} ms"),
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms > flops_ms else "operations",
    }


def lookup_bound(n: int, dim: int, n_embed: int, k: int, in_bytes: int
                 ) -> dict:
    """B1's bound: its compulsory bytes, and its distance products at
    float32 accuracy on the tensor cores."""
    p = tensor_products(in_bytes)
    return bound(n * dim * in_bytes + dim * n_embed * 4 + n * k * dim * 4
                 + n * dim * 4 + n * 4, p * 2 * n * dim * n_embed,
                 f"N*dim*{in_bytes} + dim*n_embed*4 + N*k*dim*4 + N*dim*4 "
                 f"+ N*4", f"{p}*2*N*dim*n_embed")


def train_lookup_bound(n: int, dim: int, n_embed: int, k: int,
                       in_bytes: int) -> dict:
    """B2's bound: B1's compulsory bytes plus the statistics written, B1's
    products plus one add per row element into embed_sum."""
    p = tensor_products(in_bytes)
    return bound(n * dim * in_bytes + dim * n_embed * 4 + n * k * dim * 4
                 + n * dim * 4 + n * 4 + n_embed * 4 + dim * n_embed * 4,
                 p * 2 * n * dim * n_embed + n * dim,
                 f"N*dim*{in_bytes} + dim*n_embed*4 + N*k*dim*4 + N*dim*4 "
                 f"+ N*4 + n_embed*4 + dim*n_embed*4",
                 f"{p}*2*N*dim*n_embed + N*dim")


def train_on(mk, route: str):
    """B2's wrapper on ``route``: the rule's choice where the rule gives
    that route (so the rule is exercised), else forced."""
    def kernel(flat, embed, k):
        rule = mk.lookup_route(flat.dtype, flat.shape[1], embed.shape[1], k)
        return mk.quantize_topk_train_fused(
            flat, embed, k, route=None if route == rule else route)
    return kernel


def compare_train_lookup(torch, mk, flat, embed, k: int, route: str) -> dict:
    """B2 on ``route`` against its plain version: its own q_topk, q1 and
    idx under the near-tie rule; counts equal to the histogram of the
    kernel's own top-1 indices (and to the plain version's counts where no
    top-1 index flipped); embed_sum within ``ESUM_REL`` of the plain sum
    over the kernel's own indices; a second call bitwise equal; the lookup
    bitwise equal to B1's on the same input on the tensor-core route (which
    runs B1's kernel), and under the near-tie rule on the CUDA-core route
    (B1 takes its own route: the tensor-core kernel for bf16 latents).
    Fails unless each call took ``route``."""
    kernel = train_on(mk, route)
    before = dict(mk.quantize_topk_train_fused.launches_by_route)
    res = compare_lookup(torch, kernel, mk.quantize_topk_train_fused_ref,
                         flat, embed, k)
    q, q1, idx, counts, esum = res["out"]
    _, _, idx2, counts2, esum2 = kernel(flat, embed, k)
    b1 = mk.quantize_topk_fused(flat, embed, k)
    torch.cuda.synchronize()
    took = {r: c - before[r] for r, c in
            mk.quantize_topk_train_fused.launches_by_route.items()}
    if took != {r: 2 * (r == route) for r in took}:
        fail(f"B2 on {flat.dtype} N={flat.shape[0]} n_embed={embed.shape[1]}"
             f" k={k} launched {took}, want both calls on {route!r}")
    if not (torch.equal(counts, counts2) and torch.equal(esum, esum2)
            and torch.equal(idx, idx2)):
        fail("B2: two calls on the same input gave different statistics")
    vs_b1 = compare_outputs(torch, flat, (q, q1, idx), b1, k)
    if route == mk.TENSOR_CORE and not all(
            torch.equal(a, b) for a, b in zip((q, q1, idx), b1)):
        fail(f"B2's tensor-core lookup differs from B1's on the same input "
             f"({vs_b1['flips']} flips): it must be B1's kernel, bitwise")
    n_embed = embed.shape[1]
    hist = torch.bincount(idx.long(), minlength=n_embed).float()
    if not torch.equal(counts, hist):
        fail("B2 counts differ from the histogram of its top-1 indices")
    _, _, ridx, rcounts, _ = res["ref"]
    top1_flips = int((ridx != idx).sum())
    if top1_flips == 0 and not torch.equal(counts, rcounts):
        fail("B2 counts differ from the plain version's on a flip-free input")
    one_hot = torch.nn.functional.one_hot(idx.long(), n_embed).double()
    want = flat.double().t() @ one_hot
    mag = flat.double().abs().t() @ one_hot
    err = (esum.double() - want).abs()
    worst = float((err / mag.clamp_min(1e-300)).max())
    if bool((err > ESUM_REL * mag).any()):
        fail(f"B2 embed_sum off by {worst:.3g} of the summed magnitude "
             f"(> {ESUM_REL})")
    return {"route": route, "rows": res["rows"],
            # the share of rows whose top-1 is the most picked codeword
            "top1_max_share": float(hist.max()) / max(flat.shape[0], 1),
            "flips": res["flips"],
            "flip_max_rel_gap": res["flip_max_rel_gap"],
            "top1_flips": top1_flips, "max_abs_err": res["max_abs_err"],
            "flips_vs_b1": vs_b1["flips"],
            "esum_max_rel_err": worst, "deterministic": True, "idx": idx,
            "counts": counts}


def train_kernel_phase(torch, mk) -> dict:
    """B2 at the training path's shape (N = 4 clips * 32 * 32 = 4,096 rows)
    and at B1's (N = 196,608): bf16 on the tensor-core route (timed beside
    the CUDA-core B2 and B1's kernel alone on the same input) and on the
    CUDA-core route, float32 on the CUDA-core route; plus a ragged N,
    codebooks of duplicated codewords in bf16 and f32, and n_embed 512 (runs
    in bf16, raises in f32)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    dim, n_embed, k = 64, 256, 2
    tc, cc = mk.TENSOR_CORE, mk.CUDA_CORE
    ref = mk.quantize_topk_train_fused_ref
    embed = torch.randn(dim, n_embed, device="cuda", generator=g)
    z32 = torch.randn(192 * 32 * 32, dim, device="cuda", generator=g) * 0.5
    out = {}
    for n in (4 * 32 * 32, 192 * 32 * 32):
        zb = z32[:n].to(torch.bfloat16)
        for name, flat, route in (("bfloat16", zb, tc), ("bfloat16", zb, cc),
                                  ("float32", z32[:n].contiguous(), cc)):
            row = {"shape": [n, dim, n_embed, k], **public(
                compare_train_lookup(torch, mk, flat, embed, k, route))}
            if (name, route) == ("bfloat16", cc):  # timed in the tc row
                emit("kernel_check", kernel="quantize_topk_train_fused",
                     input=f"N={n} {name} {route}", **row)
                continue
            row.update(time_pair(torch, train_on(mk, route), ref, flat,
                                 embed, k))
            if route == tc:
                row["previous_kernel_ms"] = graph_ms(
                    torch, lambda: mk.quantize_topk_train_fused(
                        flat, embed, k, route=cc))
            # B1's kernel alone on the route: the statistics take the rest
            row["lookup_ms"] = graph_ms(
                torch, lambda: mk.quantize_topk_fused(flat, embed, k,
                                                      route=route))
            row["stats_ms"] = row["kernel_ms"] - row["lookup_ms"]
            row.update(train_lookup_bound(n, dim, n_embed, k,
                                          flat.element_size()))
            out[(n, name)] = row
            emit("kernel_check", kernel="quantize_topk_train_fused",
                 input=f"N={n} {name} {route}", **row)

    ragged = compare_train_lookup(torch, mk, z32[:1037].to(torch.bfloat16),
                                  embed, k, tc)
    emit("kernel_check", kernel="quantize_topk_train_fused",
         input="ragged N=1037 bf16", **public(ragged))
    dup = embed.clone()
    dup[:, 1::2] = dup[:, 0::2]
    for name, flat, route in (("bf16", z32[:65536].to(torch.bfloat16), tc),
                              ("f32", z32[:65536], cc)):
        res = compare_train_lookup(torch, mk, flat, dup, k, route)
        if (bool((res["idx"] % 2 != 0).any())
                or bool(res["counts"][1::2].any())):
            fail(f"B2 tie-break ({route}): a higher index of equal "
                 f"codewords was picked")
        emit("kernel_check", kernel="quantize_topk_train_fused",
             input=f"duplicated codewords {name}", lowest_index_wins=True,
             **public(res))
    big = torch.randn(dim, 512, device="cuda", generator=g)
    res = compare_train_lookup(torch, mk, z32[:4096].to(torch.bfloat16), big,
                               k, tc)
    emit("kernel_check", kernel="quantize_topk_train_fused",
         input="n_embed=512 bf16", **public(res))
    return out


# c1_check's shapes (dim, n_embed, k, N): codebook sizes no tensor-core
# kernel is built for (1024 and the non-power-of-two 100), the width 128,
# k 1, 2 and 8 (per-lane top-k lists), k 16 and k = n_embed (distances
# staged in shared memory), ragged N, and float32 B2 at n_embed 512
C1_CASES = ((64, 1024, 2, 4096), (64, 100, 2, 4096), (128, 1024, 8, 4099),
            (128, 100, 1, 1037), (64, 1024, 8, 1037), (64, 512, 2, 4096),
            (64, 256, 16, 4099), (64, 1024, 16, 1037), (128, 100, 100, 1037),
            (64, 256, 256, 515))
# c1_check's timed shapes (N, n_embed, k), float32, dim 64: the old
# kernel's shapes (n_embed 256, k 2 at N = 196,608 for B1 and 4,096 for B2
# are kernel_check's float32 rows), n_embed 1024, and k 16
C1_TIMED = ((196_608, 1024, 2), (4_096, 1024, 2), (4_096, 256, 16),
            (196_608, 256, 16))


def c1_phase(torch, mk) -> dict:
    """The CUDA-core route of B1 and B2 at the shapes the old kernel raised
    for, against their plain versions under the near-tie rule (B2: counts
    the histogram, embed_sum within ``ESUM_REL``, two calls bitwise equal,
    its lookup bitwise B1's CUDA-core lookup), in float32 and bf16; then
    device and eager times with the bound at n_embed 1024 and at k 16."""
    g = torch.Generator(device="cuda").manual_seed(4)
    cc = mk.CUDA_CORE
    out = {}
    for dim, n_embed, k, n in C1_CASES:
        embed = torch.randn(dim, n_embed, device="cuda", generator=g)
        z32 = torch.randn(n, dim, device="cuda", generator=g) * 0.5
        for name, flat in (("float32", z32), ("bfloat16", z32.to(torch.bfloat16))):
            if n_embed == 512 and name == "bfloat16":
                continue  # the tensor-core route's size (kernel_check)
            b1 = b1_check(torch, mk, flat, embed, k, cc)
            b2 = compare_train_lookup(torch, mk, flat, embed, k, cc)
            lookup = mk.quantize_topk_train_fused(flat, embed, k, route=cc)[:3]
            if not all(torch.equal(a, b) for a, b in zip(lookup, b1["out"])):
                fail(f"B2's CUDA-core lookup differs from B1's at {name} "
                     f"dim={dim} n_embed={n_embed} k={k}")
            emit("c1_check", input=f"{name} N={n} dim={dim} n_embed={n_embed} "
                 f"k={k}", b1=public(b1), b2=public(b2))
    for n, n_embed, k in C1_TIMED:
        embed = torch.randn(64, n_embed, device="cuda", generator=g)
        flat = torch.randn(n, 64, device="cuda", generator=g) * 0.5
        for kernel, plain, bound_fn in (
                (mk.quantize_topk_fused, mk.quantize_topk_fused_ref,
                 lookup_bound),
                (mk.quantize_topk_train_fused, mk.quantize_topk_train_fused_ref,
                 train_lookup_bound)):
            row = {"shape": [n, 64, n_embed, k], "route": cc,
                   **time_pair(torch, kernel, plain, flat, embed, k),
                   **bound_fn(n, 64, n_embed, k, 4)}
            if kernel is mk.quantize_topk_train_fused:
                # B1's lookup timed just before: the statistics take the rest
                row["lookup_ms"] = out[("quantize_topk_fused", n, n_embed,
                                        k)]["kernel_ms"]
                row["stats_ms"] = row["kernel_ms"] - row["lookup_ms"]
                idx = kernel(flat, embed, k)[2]
                row["top1_max_share"] = float(torch.bincount(
                    idx.long(), minlength=n_embed).max()) / n
            out[(kernel.__name__, n, n_embed, k)] = row
            emit("c1_check", kernel=kernel.__name__,
                 input=f"float32 N={n} n_embed={n_embed} k={k} timed", **row)
        torch.cuda.empty_cache()
    return out


def b1_check(torch, mk, flat, embed, k: int, route: str) -> dict:
    """B1 against its plain version (:func:`compare_lookup`), failing unless
    the kernel call took ``route``."""
    before = dict(mk.quantize_topk_fused.launches_by_route)
    res = compare_lookup(torch, mk.quantize_topk_fused,
                         mk.quantize_topk_fused_ref, flat, embed, k)
    took = [r for r, c in mk.quantize_topk_fused.launches_by_route.items()
            if c != before[r]]
    if took != [route]:
        fail(f"B1 on {flat.dtype} N={flat.shape[0]} n_embed={embed.shape[1]} "
             f"k={k} launched on {took}, want [{route!r}]")
    return {"route": route, **res}


def kernel_phase(torch, mk) -> dict:
    """B1 at the scoring path's shapes: N = 192 windows * 32 * 32 rows (the
    full batch) and 176 * 32 * 32 (one 180-frame ped2 video), dim 64,
    n_embed 256, k 1 and 2, and at the training path's train-PSNR forward
    (N = 4 * 32 * 32, k 2), on its tensor-core route (bf16) with the
    CUDA-core kernel timed on the same input; float32 on the CUDA-core
    route; a ragged N, codebooks of duplicated codewords and the 64- and
    512-codeword sizes."""
    g = torch.Generator(device="cuda").manual_seed(0)
    n, dim, n_embed = 192 * 32 * 32, 64, 256
    embed = torch.randn(dim, n_embed, device="cuda", generator=g)
    z32 = torch.randn(n, dim, device="cuda", generator=g) * 0.5
    zb = z32.to(torch.bfloat16)
    tc, cc = mk.TENSOR_CORE, mk.CUDA_CORE
    b1 = (mk.quantize_topk_fused, mk.quantize_topk_fused_ref)
    out = {}
    for rows, k in ((192 * 32 * 32, 1), (192 * 32 * 32, 2),
                    (176 * 32 * 32, 1), (176 * 32 * 32, 2), (4 * 32 * 32, 2)):
        flat = zb[:rows]
        row = {"shape": [rows, dim, n_embed, k],
               **public(b1_check(torch, mk, flat, embed, k, tc)),
               **time_pair(torch, *b1, flat, embed, k),
               "previous_kernel_ms": graph_ms(
                   torch, lambda: mk.quantize_topk_fused(
                       flat, embed, k, route=cc)),
               **lookup_bound(rows, dim, n_embed, k, 2)}
        out[("bfloat16", rows, k)] = row
        emit("kernel_check", kernel="quantize_topk_fused",
             input=f"bfloat16 N={rows} k={k}", **row)
    k = 2
    row = {"shape": [n, dim, n_embed, k],
           **public(b1_check(torch, mk, z32, embed, k, cc)),
           **time_pair(torch, *b1, z32, embed, k),
           **lookup_bound(n, dim, n_embed, k, 4)}
    out["float32"] = row
    emit("kernel_check", kernel="quantize_topk_fused", input="float32", **row)

    ragged = b1_check(torch, mk, zb[:1037], embed, k, tc)
    emit("kernel_check", kernel="quantize_topk_fused",
         input="ragged N=1037 bf16", **public(ragged))
    for size, name, flat, route in ((64, "bf16", zb[:4096], tc),
                                    (512, "bf16", zb[:4096], tc),
                                    (512, "f32", z32[:4096], cc)):
        other = torch.randn(dim, size, device="cuda", generator=g)
        res = b1_check(torch, mk, flat, other, k, route)
        emit("kernel_check", kernel="quantize_topk_fused",
             input=f"n_embed={size} {name}", **public(res))

    # duplicated codewords: columns 2m and 2m+1 equal, so every distance
    # ties; the lowest index must win round 1 and its twin round 2
    dup = embed.clone()
    dup[:, 1::2] = dup[:, 0::2]
    for name, flat, route, ks in (("bf16", zb[:65536], tc, (1, 2)),
                                  ("f32", z32[:65536], cc, (2,))):
        for kk in ks:
            res = b1_check(torch, mk, flat, dup, kk, route)
            q, _, idx = res["out"]
            if bool((idx % 2 != 0).any()):
                fail(f"tie-break ({route}): the kernel picked the higher "
                     f"index of equal codewords")
            if kk == 2 and not torch.equal(q[:, :dim], q[:, dim:]):
                fail(f"tie-break ({route}): round 2 did not pick the equal "
                     f"twin of round 1")
            emit("kernel_check", kernel="quantize_topk_fused",
                 input=f"duplicated codewords {name} k={kk}",
                 lowest_index_wins=True, **public(res))
    return out


def generator_lookups(torch, net, rgb, op):
    """One inference forward of the generator, and for each memory (in
    forward order) its latents (N, dim), its output codewords' indices
    (N, k) and its codebook.  A memory outputs its chosen codewords cast to
    the latents' type, so each index is the codeword that output equals
    exactly."""
    from ammcnet_aaai2021_torch.models import TopKMemory

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((mod, inp[0], out[0])))
        for m in net.modules() if isinstance(m, TopKMemory)]
    try:
        with torch.inference_mode():
            outs = net(rgb, op)
    finally:
        for h in hooks:
            h.remove()
    lookups = []
    for mod, z, q in seen:
        dim, k = mod.embed_dim, mod.k
        zf = z.permute(0, 2, 3, 1).reshape(-1, dim)
        qf = q.permute(0, 2, 3, 1).reshape(-1, k * dim).double()
        words = mod.embed.t().to(z.dtype).double()
        idx = []
        for j in range(k):
            # differences, not the expanded quadratic form: exactly 0 at a
            # match
            dist = torch.cdist(qf[:, j * dim:(j + 1) * dim], words,
                               compute_mode="donot_use_mm_for_euclid_dist")
            gap, i = dist.min(dim=1)
            if bool((gap != 0).any()):
                fail("a memory output that is not one of its codewords")
            idx.append(i)
        lookups.append({"z": zf, "idx": torch.stack(idx, 1),
                        "embed": mod.embed.clone(), "rows_per_sample":
                        z.shape[2] * z.shape[3]})
    return outs, lookups


def model_phase(torch, mk) -> None:
    """The released generator on a small input at 256x256, its memory
    lookups in the kernel and in plain PyTorch (``use_memory_kernel=False``),
    in float32 (TF32 off) and in the main path's bfloat16.  The lookups'
    indices are compared first: a flip fails unless it is a near-tie.  The
    samples whose indices all agree feed the same codewords to the same
    convolutions, so their outputs agree to ``MODEL_TOL``."""
    import dataclasses

    from ammcnet_aaai2021_torch.configs import NetConfig
    from ammcnet_aaai2021_torch.models import build_generator, init_weights

    g = torch.Generator(device="cuda").manual_seed(1)
    batch = 4
    rgb = torch.rand(batch, 12, IMAGE_SIZE, IMAGE_SIZE, device="cuda",
                     generator=g) * 2 - 1
    op = torch.randn(batch, 6, IMAGE_SIZE, IMAGE_SIZE, device="cuda",
                     generator=g) * 0.01
    for dtype, route in (("float32", mk.CUDA_CORE),
                         ("bfloat16", mk.TENSOR_CORE)):
        runs = []
        for use_kernel in (True, False):
            cfg = dataclasses.replace(NetConfig(), dtype=dtype,
                                      use_memory_kernel=use_kernel)
            net = init_weights(build_generator(cfg, per_sample_diff=True),
                               torch.Generator().manual_seed(20200525))
            net = net.to("cuda").eval()
            before = mk.quantize_topk_fused.launches_by_route[route]
            (rgb_pred, op_pred, diffs, codes), lookups = generator_lookups(
                torch, net, rgb, op)
            torch.cuda.synchronize()
            launched = mk.quantize_topk_fused.launches_by_route[route] - before
            if launched != (2 if use_kernel else 0):
                fail(f"{dtype} generator (use_memory_kernel={use_kernel}) "
                     f"launched B1's {route} route {launched} times")
            runs.append(([rgb_pred, op_pred, *diffs, *codes], lookups))
        (outs_k, look_k), (outs_p, look_p) = runs
        flipped, flips, worst_gap, z_diff = set(), [], 0.0, 0.0
        for lk, lp in zip(look_k, look_p):
            z_diff = max(z_diff, float((lk["z"].float()
                                        - lp["z"].float()).abs().max()))
            rows = (lk["idx"] != lp["idx"]).any(1)
            flips.append(int(rows.sum()))
            if not rows.any():
                continue
            z64 = lk["z"][rows].double()
            e64 = lk["embed"].double().t()
            dk = (z64[:, None] - e64[lk["idx"][rows]]).square().sum(-1)
            dp = (z64[:, None] - e64[lp["idx"][rows]]).square().sum(-1)
            rel = (dk - dp).abs() / torch.maximum(dk, dp).clamp_min(1e-300)
            worst_gap = max(worst_gap, float(rel.max()))
            if worst_gap >= NEAR_TIE_REL:
                fail(f"{dtype} generator: the kernel and plain lookups pick "
                     f"codewords whose float64 distances differ by "
                     f"{worst_gap:.3g} relative (>= {NEAR_TIE_REL})")
            flipped |= set((rows.nonzero()[:, 0] // lk["rows_per_sample"])
                           .tolist())
        same = [b for b in range(batch) if b not in flipped]
        err = max((float((a[same].float() - b[same].float()).abs().max())
                   for a, b in zip(outs_k, outs_p)), default=0.0)
        if err > MODEL_TOL:
            fail(f"{dtype} generator: kernel route and plain route differ by "
                 f"{err} (> {MODEL_TOL}) on samples without a flipped index")
        emit("model_check", dtype=dtype, route=route, batch=batch,
             image_size=IMAGE_SIZE, flips_per_memory=flips,
             flip_max_rel_gap=worst_gap, samples_compared=len(same),
             latents_max_abs_diff=z_diff, max_abs_err=err, tol=MODEL_TOL)


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


def reset_launches(mk) -> None:
    """Every kernel's launch count to 0, by route too."""
    from ammcnet_aaai2021_torch.data import native
    from ammcnet_aaai2021_torch.ops import int8_kernels

    for wrapper in (mk.quantize_topk_fused, mk.quantize_topk_train_fused):
        wrapper.launches = 0
        wrapper.launches_by_route = dict.fromkeys(mk.ROUTES, 0)
    for wrapper in (int8_kernels.qconv3x3_int8,
                    int8_kernels.qconv_transpose2x2_int8,
                    native.idct_islow_u8, native.resize_bilinear_u8,
                    native.ycc_to_rgb_u8):
        wrapper.launches = 0


def main_path_phase(torch, mk, n_videos: int, tmp: str) -> dict:
    """The bf16 scoring run on a ped2-shaped split written under ``tmp``,
    which stays there for ``int8_path``."""
    import numpy as np

    from ammcnet_aaai2021_torch.runners import run_test

    lengths = PED2_TEST_LENGTHS[:n_videos]
    if n_videos < len(PED2_TEST_LENGTHS):
        emit("main_path_cut", videos=n_videos, of=len(PED2_TEST_LENGTHS),
             note="fewer videos; frame size and model widths unchanged")
    window_batch = 192  # run_test's default for the video scorer
    forwards = sum(math.ceil((t - 4) / min(window_batch, t - 4))
                   for t in lengths)
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
    reset_launches(mk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        res = run_test.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mk.quantize_topk_fused.launches
    by_route = dict(mk.quantize_topk_fused.launches_by_route)
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
    if by_route[mk.TENSOR_CORE] != launches:
        fail(f"B1 launches by route in the main path {by_route}: want all "
             f"{launches} on {mk.TENSOR_CORE!r}")
    frames = sum(lengths)
    out = {"videos": len(lengths), "frames": frames, "forwards": forwards,
           "window_batch": window_batch, "wall_s": wall,
           "frames_per_s": frames / wall, "run_test_fps": res["fps"],
           "auc": res["auc"], "quantize_topk_launches": launches,
           "quantize_topk_launches_by_route": by_route,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "data_write_s": data_s}
    emit("main_path", **out)
    return {**out, "dataset": dataset, "lengths": list(lengths),
            "records": records}


INT8_CALIB_CLIPS = 32
# the int8 run's rgb records against the bf16 run's (the same weights and
# split): frame PSNRs and commit distances correlate at least this much
INT8_MIN_CORR = 0.99
# windows of a plain int8 convolution at a time: its float64 copies of a
# 176-window 256x256x128 input would take 12 GB at once
PLAIN_SLICE = 16


class Int8Recorder:
    """Every int8 kernel call of one ``run_test --int8`` run, seen through
    the names ``models/quantized.py`` calls: its two conv helpers (each
    call's site, unpadded input width and record pass) and the two kernel
    wrappers.  A forward begins where a site repeats.  Every call of the
    first forward at each batch size is held against its plain version,
    bitwise: the output the forward went on with, and the int32
    accumulators of an uncounted relaunch.  The largest scoring forward
    keeps one call's arguments for each distinct launch, for timing."""

    HELPERS = ("_qconv", "_qconv_transpose")
    KERNELS = ("qconv3x3_int8", "qconv_transpose2x2_int8")

    def __init__(self):
        from ammcnet_aaai2021_torch.models import quantized
        from ammcnet_aaai2021_torch.ops import int8_kernels as ik

        self.quantized, self.ik = quantized, ik
        self.saved = {}
        self.site, self.true_cin = None, None
        self.sites = set()  # the current forward's
        self.checking, self.timing_forward = False, False
        self.batches = []  # one dict a checked forward
        self.timing_windows, self.timing = 0, {}
        self.helper_calls = self.kernel_calls = 0

    def __enter__(self):
        for name in self.HELPERS + self.KERNELS:
            fn = self.saved[name] = getattr(self.quantized, name)
            setattr(self.quantized, name, (
                self._helper if name in self.HELPERS else self._kernel)(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.quantized, name, fn)

    def _helper(self, fn):
        signature = inspect.signature(fn)

        def helper(*args, **kwargs):
            a = signature.bind(*args, **kwargs)
            a.apply_defaults()
            self._begin(a.arguments["site"], a.arguments["x"],
                        a.arguments["record"] is not None)
            return fn(*args, **kwargs)
        return helper

    def _begin(self, site: str, x, record: bool) -> None:
        if site in self.sites:
            self.sites = set()
        if not self.sites:  # a forward's first call
            n = x.shape[0]
            self.checking = n not in [b["windows"] for b in self.batches]
            if self.checking:
                self.batches.append({"windows": n, "record_pass": record,
                                     "calls": {k: 0 for k in self.KERNELS}})
            self.timing_forward = not record and n > self.timing_windows
            if self.timing_forward:
                self.timing_windows, self.timing = n, {}
        self.sites.add(site)
        self.site, self.true_cin = site, x.shape[-1]
        self.helper_calls += 1

    def _kernel(self, fn):
        plain = getattr(self.ik, fn.__name__ + "_ref")

        def kernel(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.kernel_calls += 1
            if self.checking:
                self._check(fn, plain, args, kwargs, out)
            if self.timing_forward:
                self._keep(fn, plain, args, kwargs, out)
            return out
        return kernel

    def _check(self, fn, plain, args, kwargs, out) -> None:
        import torch

        launches = fn.launches
        acc = fn(*args, **kwargs, acc=True)
        fn.launches = launches  # a comparison's launch does not count
        a = inspect.signature(plain).bind(*args, **kwargs)
        a.apply_defaults()
        a = a.arguments
        x = a.pop("x")
        for i in range(0, x.shape[0], PLAIN_SLICE):
            part = slice(i, i + PLAIN_SLICE)
            want = plain(x[part], **dict(a, acc=True))
            # the plain version's output is its epilogue of these
            # accumulators
            want_out = self.ik._epilogue_ref(
                want, a["sx"], a["scale"], a["bias"], a.get("relu", False),
                a.get("out_scale"))
            for name, got, ref in (("accumulators", acc[part], want),
                                   ("output", out[part], want_out)):
                if got.dtype != ref.dtype or not torch.equal(got, ref):
                    bad = int((got.float() != ref.float()).sum())
                    fail(f"int8_path: {fn.__name__} at {self.site} (input "
                         f"{tuple(x.shape)}, windows {i}+): {bad} {name} "
                         "differ from the plain version")
        self.batches[-1]["calls"][fn.__name__] += 1

    def _keep(self, fn, plain, args, kwargs, out) -> None:
        relu = bool(args[6]) if len(args) > 6 else kwargs.get("relu", False)
        key = (fn.__name__, tuple(args[0].shape), self.true_cin,
               tuple(out.shape), str(out.dtype), relu)
        if key in self.timing:
            self.timing[key]["sites"].append(self.site)
            return
        self.timing[key] = {
            "fn": fn, "plain": plain, "args": args, "kwargs": kwargs,
            "sites": [self.site], "true_cin": self.true_cin, "relu": relu,
            "out_bytes": out.numel() * out.element_size(),
            "epilogue": ("int8" if out.element_size() == 1
                         else "bf16_relu" if relu else "bf16")}


def int8_timing_rows(torch, rec: Int8Recorder) -> dict:
    """One row per distinct int8 launch of the largest scoring forward, on
    its real inputs: the kernel's device time (CUDA graphs) and eager time,
    its plain version's over the whole call (in ``PLAIN_SLICE`` windows),
    cuDNN's bf16 convolution of the unpadded shape and, for the transposed
    conv, ``torch._int_mm`` of its product, beside the bound at the
    unpadded input width."""
    import torch.nn.functional as F

    rows = {}
    for t in rec.timing.values():
        fn, plain, args, kwargs = t["fn"], t["plain"], t["args"], t["kwargs"]
        x, wk, cout = args[0], args[1], args[5]
        n, h, w, cin_pad = x.shape
        cin = t["true_cin"]
        transposed = fn.__name__ == "qconv_transpose2x2_int8"
        taps, cols = (1, 4 * cout) if transposed else (9, cout)
        pixels = n * h * w
        row = {"name": t["sites"][0], "sites": t["sites"],
               "kind": "2x2" if transposed else "3x3", "windows": n,
               "size": h, "cin": cin, "cin_padded": cin_pad, "cout": cout,
               "per_forward": len(t["sites"]), "epilogue": t["epilogue"],
               "max_abs_err": 0,
               "kernel_ms": graph_ms(torch, lambda: fn(*args, **kwargs),
                                     calls=5, replays=2),
               "kernel_eager_ms": time_ms(torch, lambda: fn(*args, **kwargs),
                                          reps=3, warmup=1),
               "plain_ms": time_ms(torch, lambda: [
                   plain(x[i:i + PLAIN_SLICE], *args[1:], **kwargs)
                   for i in range(0, n, PLAIN_SLICE)], reps=1, warmup=0),
               **bound(pixels * cin + cols * taps * cin + t["out_bytes"]
                       + 8 * cout, 2 * pixels * taps * cin * cols,
                       "N*H*W*Cin + cols*taps*Cin + output + 8*Cout (Cin "
                       "unpadded)", "2*N*H*W*taps*Cin*cols",
                       INT8_TENSOR_OPS, "int8 tensor cores")}
        xb = x[..., :cin].permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        if transposed:
            wb = torch.randn((cin, cout, 2, 2), device="cuda",
                             dtype=torch.bfloat16)
            row["cudnn_bf16_ms"] = graph_ms(
                torch, lambda: F.conv_transpose2d(xb, wb, stride=2),
                calls=5, replays=2)
            a, b = x.reshape(-1, cin_pad), wk[:cols, 0].t()
            row["library_call"] = ("torch._int_mm of the (N*H*W, Cin) x "
                                   "(Cin, 4*Cout) int8 product")
            row["library_ms"] = graph_ms(torch, lambda: torch._int_mm(a, b),
                                         calls=5, replays=2)
            del xb
        else:
            wb = torch.randn((cout, cin, 3, 3), device="cuda",
                             dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            row["cudnn_bf16_ms"] = graph_ms(
                torch, lambda: F.conv2d(xb, wb, padding=1), calls=5,
                replays=2)
            del xb
            # the product alone: the im2col'd (N*H*W, 9*Cin_pad) x (9*Cin_pad,
            # Cout_pad) int8 GEMM, the im2col built before the timed window;
            # as many windows as leave the card a quarter free
            per_window = h * w * (9 * cin_pad + 4 * wk.shape[0])
            free = torch.cuda.mem_get_info()[0]
            part = max(1, min(n, int(0.75 * free) // per_window))
            xp = F.pad(x[:part], (0, 0, 1, 1, 1, 1))
            a = torch.stack([xp[:, ky:ky + h, kx:kx + w]
                             for ky in range(3) for kx in range(3)],
                            dim=3).reshape(part * h * w, 9 * cin_pad)
            del xp
            b = wk.reshape(wk.shape[0], 9 * cin_pad).t()
            row["library_call"] = ("torch._int_mm of the im2col'd (N*H*W, "
                                   "9*Cin_pad) x (9*Cin_pad, Cout_pad) int8 "
                                   "product (im2col not timed)")
            row["library_windows"] = part
            row["library_ms"] = graph_ms(torch, lambda: torch._int_mm(a, b),
                                         calls=5, replays=2)
            del a
        rows[row["name"]] = row
        emit("int8_kernel_timing", **row)
        del wb
    rec.timing.clear()
    torch.cuda.empty_cache()
    return rows


def int8_forward_totals(rows: dict) -> dict:
    """The timed forward's int8 convolutions, kernel by kernel: the device
    ms, bound and cuDNN bf16 ms of every launch the forward makes, summed."""
    out = {}
    for kind in ("3x3", "2x2"):
        picked = [r for r in rows.values() if r["kind"] == kind]
        out[kind] = {key: sum(r[key] * r["per_forward"] for r in picked)
                     for key in ("kernel_ms", "plain_ms", "bound_ms",
                                 "cudnn_bf16_ms", "library_ms")}
        out[kind]["library_windows"] = min(
            r.get("library_windows", r["windows"]) for r in picked)
        out[kind]["launches"] = sum(r["per_forward"] for r in picked)
        out[kind]["windows"] = picked[0]["windows"]
        out[kind]["bound_by"] = "operations" if all(
            r["bound_by"] == "operations" for r in picked) else "mixed"
    return out


def int8_path_phase(torch, mk, tmp: str, main_run: dict) -> dict:
    """``run_test --int8 --calib_clips 32`` on ``main_path``'s split (its
    bf16 run's data and seeded weights) with a training split added: records
    finite, one per frame, the AUC line, the rgb records' correlation with
    the bf16 run's, every 3x3 and transposed conv launched through the int8
    kernels and B1 twice a forward.  Then the same command again under
    :class:`Int8Recorder`: every kernel call of the first forward at each of
    the run's batch sizes (the calibration's, and each video length's
    windows) against its plain version, bitwise; then each distinct launch
    of the largest forward timed on its real inputs."""
    import numpy as np

    from ammcnet_aaai2021_torch.models.quantized import N_SITES
    from ammcnet_aaai2021_torch.ops import int8_kernels as ik
    from ammcnet_aaai2021_torch.runners import run_test

    dataset, lengths = main_run["dataset"], main_run["lengths"]
    t0 = time.perf_counter()
    write_train_tree(tmp, dataset)
    data_s = time.perf_counter() - t0
    argv = ["--dataset_name", dataset, "--data_dir", tmp, "--int8",
            "--calib_clips", str(INT8_CALIB_CLIPS)]
    forwards = main_run["forwards"] + INT8_CALIB_CLIPS // 8
    stdout = io.StringIO()
    torch.cuda.synchronize()
    reset_launches(mk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        res = run_test.main(argv + ["--save_dir",
                                    os.path.join(tmp, "eval_int8")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"qconv3x3_int8": ik.qconv3x3_int8.launches,
                "qconv_transpose2x2_int8": ik.qconv_transpose2x2_int8.launches,
                "b1": dict(mk.quantize_topk_fused.launches_by_route)}
    printed = stdout.getvalue()
    print(printed, end="", flush=True)
    with open(res["pickle"], "rb") as fh:
        records = pickle.load(fh)
    if "the optimal auc = " not in printed:
        fail("int8_path: run_test --int8 printed no 'the optimal auc =' line")
    for key in ("rgb_img_pred_records", "rgb_fea_comm_records",
                "op_img_pred_records", "op_fea_comm_records"):
        if [len(r) for r in records[key]] != list(lengths):
            fail(f"int8_path: {key} lengths differ from {lengths}")
        if not all(np.isfinite(r).all() for r in records[key]):
            fail(f"int8_path: {key} not finite")
    corr = {key: float(np.corrcoef(
        np.concatenate(records[key]),
        np.concatenate(main_run["records"][key]))[0, 1])
        for key in ("rgb_img_pred_records", "rgb_fea_comm_records")}
    if min(corr.values()) < INT8_MIN_CORR:
        fail(f"int8_path: records correlate with the bf16 run's by {corr}, "
             f"want >= {INT8_MIN_CORR}")

    t0 = time.perf_counter()
    with Int8Recorder() as rec, contextlib.redirect_stdout(io.StringIO()):
        run_test.main(argv + ["--save_dir", os.path.join(tmp, "eval_check")])
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    want_windows = sorted({min(8, INT8_CALIB_CLIPS)} | {min(WINDOW_BATCH, t - CLIP_LEN_RGB + 1)
                                 for t in lengths})
    per_forward = rec.batches[0]["calls"] if rec.batches else {}
    if (sorted(b["windows"] for b in rec.batches) != want_windows
            or any(b["calls"] != per_forward for b in rec.batches)
            or sum(per_forward.values()) != N_SITES
            or rec.helper_calls != rec.kernel_calls):
        fail(f"int8_path: checked forwards {rec.batches} (want one at each "
             f"of {want_windows} windows, {N_SITES} kernel calls each), "
             f"{rec.helper_calls} convs and {rec.kernel_calls} kernel calls")
    emit("int8_check", batches=rec.batches, seconds=check_s,
         plain_slice=PLAIN_SLICE)
    want = {**{name: c * forwards for name, c in per_forward.items()},
            "b1": {r: 2 * forwards * (r == mk.TENSOR_CORE)
                   for r in mk.ROUTES}}
    if launches != want:
        fail(f"int8_path: launches {launches}, want {want} (the scoring "
             f"run's {main_run['forwards']} forwards and "
             f"{INT8_CALIB_CLIPS // 8} calibration passes)")
    rows = int8_timing_rows(torch, rec)
    totals = int8_forward_totals(rows)
    emit("int8_forward_totals", **totals)
    frames = sum(lengths)
    out = {"videos": len(lengths), "frames": frames,
           "calib_clips": INT8_CALIB_CLIPS, "wall_s": wall,
           "frames_per_s": frames / wall, "run_test_fps": res["fps"],
           "bf16_frames_per_s": main_run["frames_per_s"],
           "bf16_run_test_fps": main_run["run_test_fps"],
           "auc": res["auc"], "bf16_auc": main_run["auc"],
           "corr_with_bf16": corr, "launches": launches,
           "train_data_write_s": data_s}
    emit("int8_path", **out)
    return {"run": out, "checks": rows, "totals": totals}


def train_check_phase(torch, mk) -> dict:
    """One float32 step (TF32 off, cuDNN deterministic) of the released
    generator at 256x256, batch 4, from one state and batch: through the
    kernels (B2 in the forward, on its CUDA-core route: float32 latents)
    and with ``use_memory_kernel=False``."""
    import copy
    import dataclasses

    from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
    from ammcnet_aaai2021_torch.models import build_model, init_flownet_weights
    from ammcnet_aaai2021_torch.train.state import create_train_state
    from ammcnet_aaai2021_torch.train.steps import (
        codebook_buffers, make_twostream_train_step)

    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {"rgb": torch.randint(0, 256, (4, 5, IMAGE_SIZE, IMAGE_SIZE, 3),
                                  device="cuda", generator=g,
                                  dtype=torch.uint8),
             "op": torch.randn(4, 4, IMAGE_SIZE, IMAGE_SIZE, 2, device="cuda",
                               generator=g) * 0.5}
    runs, init = [], None
    for use_kernel in (True, False):
        cfg = dataclasses.replace(NetConfig(), dtype="float32",
                                  use_memory_kernel=use_kernel)
        model = build_model(cfg, mode="training")
        state = create_train_state(model.generator, model.discriminator,
                                   OptimConfig(), 20200525, device="cuda")
        flownet = init_flownet_weights(model.flow_network,
                                       torch.Generator().manual_seed(7))
        flownet.to("cuda").eval()
        if init is None:
            init = (copy.deepcopy(state.generator.state_dict()),
                    copy.deepcopy(state.discriminator.state_dict()))
        state.generator.load_state_dict(init[0])
        state.discriminator.load_state_dict(init[1])
        before = mk.quantize_topk_train_fused.launches
        before_cc = mk.quantize_topk_train_fused.launches_by_route[
            mk.CUDA_CORE]
        metrics = make_twostream_train_step(LossConfig())(state, batch, flownet)
        torch.cuda.synchronize()
        launched = mk.quantize_topk_train_fused.launches - before
        on_cc = (mk.quantize_topk_train_fused.launches_by_route[mk.CUDA_CORE]
                 - before_cc)
        if launched != (2 if use_kernel else 0) or on_cc != launched:
            fail(f"train step (use_memory_kernel={use_kernel}) launched B2 "
                 f"{launched} times, {on_cc} on {mk.CUDA_CORE!r}")
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {k: v.clone() for k, v in
                      codebook_buffers(state.generator).items()}))
    (m_k, cb_k), (m_p, cb_p) = runs
    loss_err = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-30) for k in m_p)
    cb_err = max(float((cb_k[k] - cb_p[k]).abs().max()) for k in cb_p)
    cs_equal = all(torch.equal(cb_k[k], cb_p[k]) for k in cb_p
                   if k.endswith("cluster_size"))
    moved = all(bool(cb_k[k].any()) for k in cb_k if k.endswith("cluster_size"))
    if loss_err > TRAIN_LOSS_REL:
        fail(f"train step: kernel and plain losses differ by {loss_err:.3g} "
             f"relative (> {TRAIN_LOSS_REL})")
    if cb_err > TRAIN_CODEBOOK_TOL or not moved:
        fail(f"train step: codebooks differ by {cb_err:.3g} "
             f"(> {TRAIN_CODEBOOK_TOL}) or cluster_size did not move")
    out = {"batch": 4, "image_size": IMAGE_SIZE, "dtype": "float32",
           "b2_route": mk.CUDA_CORE, "loss_max_rel_err": loss_err, "loss_tol": TRAIN_LOSS_REL,
           "codebook_max_abs_err": cb_err, "codebook_tol": TRAIN_CODEBOOK_TOL,
           "cluster_size_equal": cs_equal, "g_loss": m_k["g_loss"]}
    emit("train_check", **out)
    return out


def write_train_tree(root: str, dataset: str = "ped2") -> None:
    """A ped2-shaped training split of numpy files: <root>/<dataset>/
    training/{frames,flows}/NN/, ``TRAIN_VIDEOS`` videos of
    ``TRAIN_FRAMES`` u8 256x256 frames (.npy) and float32 flow fields, from
    a fixed seed."""
    import numpy as np

    rng = np.random.default_rng(20200526)
    s = IMAGE_SIZE
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    for vi in range(1, TRAIN_VIDEOS + 1):
        fdir = os.path.join(root, dataset, "training", "frames", f"{vi:02d}")
        odir = os.path.join(root, dataset, "training", "flows", f"{vi:02d}")
        os.makedirs(fdir)
        os.makedirs(odir)
        base = 96 + 48 * np.sin((xx + 5 * vi) / 19.0) * np.cos(yy / 29.0)
        for t in range(TRAIN_FRAMES):
            blob = 80 * np.exp(-((xx - (3 * t) % s) ** 2
                                 + (yy - s / 2) ** 2) / 300.0)
            gray = np.clip(base + blob + rng.normal(0, 4, (s, s)), 0, 255)
            np.save(os.path.join(fdir, f"{t:03d}.npy"),
                    np.repeat(gray.astype(np.uint8)[..., None], 3, axis=2))
            if t + 1 < TRAIN_FRAMES:
                np.save(os.path.join(odir, f"{t:03d}.npy"),
                        rng.normal(0, 1.5, (s, s, 2)).astype(np.float32))


def read_scalars(run_dir: str) -> dict:
    """{tag: {step: value}} from a run's summary CSV."""
    import csv

    out: dict = {}
    with open(os.path.join(run_dir, "summary", "scalars.csv")) as fh:
        for row in csv.DictReader(fh):
            out.setdefault(row["tag"], {})[int(row["step"])] = float(row["value"])
    return out


def train_path_phase(torch, mk) -> dict:
    """``run_train.main`` with the released defaults (bf16, batch 4,
    256x256) for ``TRAIN_STEPS`` steps, then ``--resume`` to
    ``RESUME_STEPS``.  The kernels' counts are set to 0 just before and read
    just after."""
    from ammcnet_aaai2021_torch.runners import run_train
    from ammcnet_aaai2021_torch.train.checkpoint import (
        latest_step, restore_checkpoint)
    from ammcnet_aaai2021_torch.train.state import create_train_state
    from ammcnet_aaai2021_torch.models import build_model
    from ammcnet_aaai2021_torch.configs import NetConfig, OptimConfig

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_train_tree(tmp)
        data_s = time.perf_counter() - t0
        argv = ["--dataset_name", "ped2", "--data_dir", tmp,
                "--save_dir", os.path.join(tmp, "runs"),
                "--registry", os.path.join(tmp, "runs", "registry.json"),
                "--step_log", "10", "--step_summary", "10",
                "--step_save", str(TRAIN_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mk)
        t0 = time.perf_counter()
        run1, state1 = run_train.main(argv + ["--iterations", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        time.sleep(1.0)  # run dirs are named by the second
        run2, state2 = run_train.main(argv + ["--iterations", str(RESUME_STEPS),
                                              "--resume", run1])
        torch.cuda.synchronize()
        b1 = mk.quantize_topk_fused.launches
        b1_by_route = dict(mk.quantize_topk_fused.launches_by_route)
        b2 = mk.quantize_topk_train_fused.launches
        b2_by_route = dict(mk.quantize_topk_train_fused.launches_by_route)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        scalars = [read_scalars(run1), read_scalars(run2)]
        for sc in scalars:
            for tag, vals in sc.items():
                if not all(math.isfinite(v) for v in vals.values()):
                    fail(f"training path: scalar {tag} not finite: {vals}")
        if b2 != 2 * RESUME_STEPS:
            fail(f"B2 launched {b2} times in the training path, want 2 per "
                 f"step = {2 * RESUME_STEPS}")
        if b2_by_route[mk.TENSOR_CORE] != b2:
            fail(f"B2 launches by route in the training path {b2_by_route}:"
                 f" want all {b2} on {mk.TENSOR_CORE!r}")
        log_steps = RESUME_STEPS // 10
        if b1 != 2 * log_steps:
            fail(f"B1 launched {b1} times in the training path, want 2 per "
                 f"train-PSNR forward = {2 * log_steps}")
        if b1_by_route[mk.TENSOR_CORE] != b1:
            fail(f"B1 launches by route in the training path {b1_by_route}:"
                 f" want all {b1} on {mk.TENSOR_CORE!r}")
        cs = state2.generator.rgb.vq_down3.quan.quantize.cluster_size
        if not bool(cs.any()):
            fail("training path: cluster_size did not move from its zeros")
        if state2.step != RESUME_STEPS:
            fail(f"resumed run ended at step {state2.step}")
        log_dir = os.path.join(run2, "log_dir")
        with open(os.path.join(log_dir, "info.log")) as fh:
            log = fh.read()
        if f"training steps {TRAIN_STEPS + 1} to {RESUME_STEPS}" not in log:
            fail(f"the resumed run did not start at step {TRAIN_STEPS + 1}")

        # the step-30 checkpoint restores the first run's final state exactly
        ckpt_dir = os.path.join(run1, "training", "checkpoints")
        if latest_step(ckpt_dir) != TRAIN_STEPS:
            fail(f"no step-{TRAIN_STEPS} checkpoint under {ckpt_dir}")
        model = build_model(NetConfig(), mode="training")
        fresh = create_train_state(model.generator, model.discriminator,
                                   OptimConfig(), 1, device="cuda")
        restore_checkpoint(ckpt_dir, fresh, step=TRAIN_STEPS)
        pairs = [(state1.generator.state_dict(), fresh.generator.state_dict()),
                 (state1.discriminator.state_dict(),
                  fresh.discriminator.state_dict())]
        for opt_a, opt_b in ((state1.g_opt, fresh.g_opt),
                             (state1.d_opt, fresh.d_opt)):
            sa, sb = opt_a.state_dict()["state"], opt_b.state_dict()["state"]
            pairs.append(({f"{i}.{n}": t for i, s in sa.items()
                           for n, t in s.items()},
                          {f"{i}.{n}": t for i, s in sb.items()
                           for n, t in s.items()}))
        for want, got in pairs:
            if set(want) != set(got) or not all(
                    torch.equal(want[k], got[k]) for k in want):
                fail("the step-30 checkpoint does not restore bit-exactly")
        if fresh.step != TRAIN_STEPS or fresh.g_sched.last_epoch != TRAIN_STEPS:
            fail("the checkpoint's step or schedule did not restore")

    rates = scalars[0]["steps_per_sec"]
    steady = [rates[s] for s in sorted(rates) if s > 10]
    out = {"steps": RESUME_STEPS, "resumed_from": TRAIN_STEPS,
           "batch": 4, "image_size": IMAGE_SIZE, "dtype": "bfloat16",
           "videos": TRAIN_VIDEOS, "frames_per_video": TRAIN_FRAMES,
           "first_step_s": scalars[0]["first_step_s"][1],
           "steps_per_s_by_period": rates,
           "steady_steps_per_s": sum(steady) / len(steady),
           "data_stall_frac_by_period": scalars[0]["data_stall_frac"],
           "resumed_steps_per_s": scalars[1]["steps_per_sec"],
           "first_run_wall_s": wall1, "peak_mem_gib": peak,
           "data_write_s": data_s, "quantize_topk_train_launches": b2,
           "quantize_topk_train_launches_by_route": b2_by_route,
           "quantize_topk_launches": b1,
           "quantize_topk_launches_by_route": b1_by_route,
           "g_loss_by_step": scalars[0]["g_loss"],
           "train_psnr_by_step": scalars[0]["train_psnr"],
           "restored_bit_exact": True}
    emit("train_path", **out)
    return out


# the stage-1 path: steps of each stage-1 run, of the stage-2 run grafted
# from them, and of the n_embed 1024 run; log period (one train-PSNR
# forward each)
STAGE1_STEPS, STAGE2_STEPS, C1_RUN_STEPS, STAGE1_LOG = 20, 10, 5, 5
STAGE1_RECIPES = (("rgb", "rgb_int_gdl_flow_adv_vq"), ("op", "op_int_adv_vq"))


def launch_counts(mk) -> dict:
    """Each wrapper's launches by route, read after a run."""
    return {"b1": dict(mk.quantize_topk_fused.launches_by_route),
            "b2": dict(mk.quantize_topk_train_fused.launches_by_route)}


def timed_run(torch, mk, run_train, argv, steps: int, memories: int,
              route: str) -> dict:
    """``run_train.main(argv)`` with every count set to 0 just before and
    read just after; fails unless it reached ``steps``, logged finite
    scalars and launched B2 ``memories`` times a step and B1 ``memories``
    times a train-PSNR forward, all on ``route``."""
    import re

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mk)
    t0 = time.perf_counter()
    run_dir, state = run_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(mk)
    want = {"b2": memories * steps, "b1": memories * (steps // STAGE1_LOG)}
    for kernel, n in want.items():
        if counts[kernel] != {r: n * (r == route) for r in mk.ROUTES}:
            fail(f"{argv[-1]}: {kernel} launched {counts[kernel]}, want {n} "
                 f"all on {route!r}")
    if state.step != steps:
        fail(f"{argv[-1]}: ended at step {state.step}, want {steps}")
    scalars = read_scalars(run_dir)
    for tag, vals in scalars.items():
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"{argv[-1]}: scalar {tag} not finite: {vals}")
    with open(os.path.join(run_dir, "log_dir", "info.log")) as fh:
        resident = re.search(r"resident_bytes=(\d+)", fh.read())
    rates = scalars["steps_per_sec"]
    steady = [rates[s] for s in rates if s > STAGE1_LOG]  # after period 1
    return {"run_dir": run_dir, "state": state, "steps": steps,
            "wall_s": wall, "first_step_s": scalars["first_step_s"][1],
            "steps_per_s_by_period": rates,
            "steady_steps_per_s": sum(steady) / len(steady) if steady else None,
            "data_stall_frac_by_period": scalars["data_stall_frac"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "resident_bytes": int(resident.group(1)) if resident else None,
            "launches_by_route": counts,
            "g_loss_by_step": scalars["g_loss"],
            "train_psnr_by_step": scalars["train_psnr"]}


def stage1_path_phase(torch, mk) -> dict:
    """The released recipe from stage 1, at full width (the released
    configuration, bf16, batch 4, 256x256) on a numpy-written training tree:
    ``run_train`` stage 1 rgb and op on the device-resident backend, then
    stage 2 ``--pretrain`` from both step dirs on the framepack backend (a
    pack ``pack_video_tree`` writes), then stage 1 rgb at ``--n_embed 1024``
    and at ``--k 16`` (the CUDA-core route).  Each run logs finite scalars
    and moves its codebook; every B2 launch of the released-configuration
    runs takes the tensor-core route, those of the n_embed 1024 and k 16
    runs the CUDA-core route."""
    from ammcnet_aaai2021_torch.data.framepack import pack_video_tree
    from ammcnet_aaai2021_torch.runners import run_train

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_train_tree(tmp)
        base = os.path.join(tmp, "ped2", "training")
        for name, data_type in (("frames", "rgb"), ("flows", "op")):
            pack_video_tree(os.path.join(base, name),
                            os.path.join(base, name + ".fpk"),
                            image_size=IMAGE_SIZE, data_type=data_type)
        data_s = time.perf_counter() - t0

        def argv(steps, *extra):
            return ["--dataset_name", "ped2", "--data_dir", tmp,
                    "--save_dir", os.path.join(tmp, "runs"),
                    "--registry", os.path.join(tmp, "runs", "registry.json"),
                    "--step_log", str(STAGE1_LOG), "--step_summary",
                    str(STAGE1_LOG), "--step_save", str(steps),
                    "--iterations", str(steps), *extra]

        step_dirs = {}
        for data_type, loss_tag in STAGE1_RECIPES:
            run = timed_run(torch, mk, run_train, argv(
                STAGE1_STEPS, "--net_tag", "unet_vq_topk_res", "--data_type",
                data_type, "--loss_tag", loss_tag, "--backend", "device",
                "--exp_tag", f"stage1-{data_type}"), STAGE1_STEPS, 1,
                mk.TENSOR_CORE)
            cb = run["state"].generator.vq_down3.quan.quantize
            if not bool(cb.cluster_size.any()):
                fail(f"stage 1 {data_type}: cluster_size did not move")
            if not run["resident_bytes"]:
                fail(f"stage 1 {data_type}: no resident_bytes logged")
            step_dirs[data_type] = (os.path.join(
                run["run_dir"], "training", "checkpoints",
                f"{STAGE1_STEPS:06d}"), cb.embed.clone())
            out[f"stage1_{data_type}"] = run

        run = timed_run(torch, mk, run_train, argv(
            STAGE2_STEPS, "--pretrain", "--rgb_model_path",
            step_dirs["rgb"][0], "--op_model_path", step_dirs["op"][0],
            "--backend", "framepack", "--exp_tag", "stage2-pretrained"),
            STAGE2_STEPS, 2, mk.TENSOR_CORE)
        gen = run["state"].generator
        for stream in ("rgb", "op"):
            if torch.equal(getattr(gen, stream).vq_down3.quan.quantize.embed,
                           step_dirs[stream][1]):
                fail(f"stage 2: the grafted {stream} codebook did not move")
        out["stage2_framepack"] = run

        for name, flag, value in (("n_embed_1024", "--n_embed", "1024"),
                                  ("k_16", "--k", "16")):
            run = timed_run(torch, mk, run_train, argv(
                C1_RUN_STEPS, "--net_tag", "unet_vq_topk_res", "--data_type",
                "rgb", "--loss_tag", "rgb_int_gdl_flow_adv_vq", flag, value,
                "--backend", "device", "--exp_tag", f"stage1-{name}"),
                C1_RUN_STEPS, 1, mk.CUDA_CORE)
            if not bool(run["state"].generator.vq_down3.quan.quantize
                        .cluster_size.any()):
                fail(f"stage 1 at {flag} {value}: cluster_size did not move")
            out[f"stage1_{name}"] = run
    for name, run in out.items():
        emit("stage1_path", run=name, batch=4, image_size=IMAGE_SIZE,
             data_write_s=data_s, **{k: v for k, v in run.items()
                                     if k not in ("run_dir", "state")})
    return out


# the raw-video path: Ped2's native frame size; the committed JPEG fixture
# (16 grayscale frames at that size, 2 colour frames at Avenue's, cv2's
# decodes)
RAW_SHAPE = (240, 360)
# Avenue's colour frames, and the lengths of its last four test videos (18
# to 21 of 21): the colour run's split, cut from Avenue's 15,324 frames
AVENUE_SHAPE, AVENUE_TAIL_LENGTHS = (360, 640), (294, 248, 273, 76)
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_jpeg")
GRAY_FIXTURE_FRAMES, COLOR_FIXTURE_FRAMES = 16, 2
# libjpeg_reference.npz: the host libjpeg route's RGB decode of each
# fixture kind at each size ("source", 256, and gray_c5.jpg's 160 and
# 248x103, where its channel 0 is off: at 256x256 no JPEG's can be, since a
# power-of-two width makes every product of the resize exact); the GPU route
# must give each bitwise
FIXTURE_REFERENCES = (
    "gray_source", "gray_256", "color_source", "color_256",
    "progressive_256", "arithmetic_source", "arithmetic_256", "gray_c5_160",
    "gray_c5_248x103", "gray_c5_256", "smooth_partial_source", "smooth_partial_256",
    "smooth_dconly_source", "smooth_dconly_256", "smooth_al1_source",
    "smooth_al1_256", "smooth_arith_source", "smooth_arith_256",
    "trunc_rst_source", "trunc_rst_256", "trunc_progressive_source",
    "trunc_progressive_256", "trunc_arith_source", "trunc_arith_256")
# the resize kernel against its plain version on this many seeded random
# (sh, sw, dh, dw), 16 to 720 pixels
RESIZE_SWEEP = 30
# score_dataset's bucket padding, make_otf_flow_extractor's pairs a
# forward, the GPU decode's frames a resize launch (csrc kChunkFrames)
BUCKET, OTF_CHUNK, DECODE_CHUNK = 64, 16, 32
# the GPU decode of the fixture against cv2's (reference.npz): libjpeg's
# decode, bitwise the host route's, then the float resize, 1 LSB against
# cv2's fixed-point one, as the host route is
GRAY_MAX_LSB, GRAY_WITHIN_1_LSB = 1, 1.0
COLOR_MAX_LSB, COLOR_WITHIN_1_LSB = 1, 1.0
# scoring: 5-frame windows, 192 a forward
CLIP_LEN_RGB, WINDOW_BATCH = 5, 192
# the extractor in float32 (TF32 off) on the card against the same weights
# on the CPU, before the bf16 cast: within this share of the largest |flow|
OTF_REL = 1e-4
FLO_MAGIC = 202021.25
# (run, dataset, flags), each with --native_loader
RAW_RUNS = (("jpeg_flo", "ped2", []),
            ("otf_gray", "ped2", ["--on_the_fly_flow", "--gray_upload"]),
            ("otf_rgb", "ped2", ["--on_the_fly_flow"]),
            ("avenue_color", "avenue", ["--on_the_fly_flow"]))


def write_raw_tree(root: str, dataset: str, lengths, flows: bool) -> None:
    """A raw test split: <root>/<dataset>/testing/frames/NN/TTT.jpg, the
    fixture's JPEGs cycled through in order (their bytes copied): for ped2
    the 240x360 grayscale ones, for avenue the 360x640 colour ones, with
    <root>/avenue/avenue.mat marking the middle third of each video (Avenue's
    annotation is not in the repository).  With ``flows`` (ped2),
    <root>/ped2/testing/flows/NN/TTT.flo, T-1 240x360 fields a video (magic,
    int32 w and h, float32 data), 8 seeded fields cycled."""
    import numpy as np

    kind, count = (("gray", GRAY_FIXTURE_FRAMES) if dataset == "ped2"
                   else ("color", COLOR_FIXTURE_FRAMES))
    jpegs = [os.path.join(FIXTURE, f"{kind}_{i:02d}.jpg")
             for i in range(count)]
    h, w = RAW_SHAPE
    rng = np.random.default_rng(20200527)
    header = (np.array([FLO_MAGIC], np.float32).tobytes()
              + np.array([w, h], np.int32).tobytes())
    fields = [header + rng.normal(0, 1.5, (h, w, 2)).astype(np.float32)
              .tobytes() for _ in range(8)] if flows else []
    frame = 0
    for vi, length in enumerate(lengths, start=1):
        fdir = os.path.join(root, dataset, "testing", "frames", f"{vi:02d}")
        os.makedirs(fdir)
        odir = os.path.join(root, dataset, "testing", "flows", f"{vi:02d}")
        if flows:
            os.makedirs(odir)
        for t in range(length):
            shutil.copyfile(jpegs[frame % len(jpegs)],
                            os.path.join(fdir, f"{t:03d}.jpg"))
            frame += 1
            if flows and t + 1 < length:
                with open(os.path.join(odir, f"{t:03d}.flo"), "wb") as fh:
                    fh.write(fields[(vi + t) % len(fields)])
    if dataset == "avenue":
        import scipy.io

        gt = np.empty(len(lengths), dtype=object)  # a 1 x videos cell
        for i, t in enumerate(lengths):
            gt[i] = np.array([[t // 3 + 1], [2 * t // 3]])  # 1-indexed
        scipy.io.savemat(os.path.join(root, dataset, f"{dataset}.mat"),
                         {"gt": gt})


def reset_native_launches(native) -> None:
    native.idct_islow_u8.launches = 0
    native.resize_bilinear_u8.launches = 0
    native.ycc_to_rgb_u8.launches = 0


def c2_phase(torch, native) -> dict:
    """The GPU JPEG route is libjpeg's: the IDCT kernel against its plain
    version on the fixture's coefficients (the Huffman decode's, a 32-frame
    chunk of the 240x360 grayscale frames and one of the 360x640 colour
    frames' three components, the colour run's chunk), bitwise, timed
    beside its bound and plain version;
    the fixture's GPU decode, gray and colour, bitwise the committed host
    libjpeg route (libjpeg_reference.npz, RGB) at source size and at
    256x256; likewise its progressive JPEG (SOF2, colour, at 256x256), its
    arithmetic-coded progressive one (SOF10, grayscale), ``gray_c5.jpg`` at
    160x160, 248x103 and 256x256 (C5), the four smoothing files (C6) and
    the three truncated files (C7); and the IDCT kernel on the card tests'
    seeded sweep of geometries (``kernel_sweeps.idct_sweep``), bitwise."""
    import numpy as np

    from ammcnet_aaai2021_torch.data.kernel_sweeps import (IDCT_SWEEP,
                                                           idct_sweep)

    out = {}
    gray = [os.path.join(FIXTURE, f"gray_{i:02d}.jpg")
            for i in range(GRAY_FIXTURE_FRAMES)]
    colour = [os.path.join(FIXTURE, f"color_{i:02d}.jpg")
              for i in range(COLOR_FIXTURE_FRAMES)]
    # the raw runs' chunks: the fixture's frames cycled, as write_raw_tree
    # cycles them
    chunk = (gray * DECODE_CHUNK)[:DECODE_CHUNK] + (
        colour * DECODE_CHUNK)[:DECODE_CHUNK]
    t0 = time.perf_counter()
    frames = native.decode_coefs(chunk)
    huffman_s = time.perf_counter() - t0
    chunks = {"gray": [f[0] for f in frames[:DECODE_CHUNK]]}
    for c, name in enumerate(("y", "cb", "cr")):
        chunks[f"color_{name}"] = [f[c] for f in frames[DECODE_CHUNK:]]
    for name, comps in chunks.items():
        coefs = torch.from_numpy(np.stack([c.coefs for c in comps]))
        q = torch.from_numpy(np.stack([c.qtable for c in comps]))
        size = comps[0].size
        cc, qc = coefs.cuda(), q.cuda()
        got = native.idct_islow_u8(cc, qc, size)
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), native.idct_islow_u8_ref(coefs, q,
                                                               size)):
            fail(f"c2_check: the IDCT kernel differs from its plain version "
                 f"on the fixture's {name} coefficients")
        f, bh, bw, _ = coefs.shape
        blocks = f * bh * bw
        out[name] = {"frames": f, "blocks": blocks, "size": list(size),
                     "max_abs_err": 0,
                     **time_pair(torch, native.idct_islow_u8,
                                 native.idct_islow_u8_ref, cc, qc, size),
                     "library_ms": None,
                     # 2 bytes a coefficient, the tables, a byte a pixel;
                     # about 1,312 32-bit integer operations a block (the
                     # two passes' butterflies, dequantize, descale and
                     # saturation)
                     **bound(blocks * 128 + f * 128 + f * size[0] * size[1],
                             blocks * 1312, "blocks*128 + F*128 + F*h*w",
                             "blocks*1312", FP32_FLOPS,
                             "32-bit operations, CUDA cores")}
        emit("c2_check", kernel="idct_islow_u8", input=name, **out[name])
    sweep = []
    for coefs, q, size in idct_sweep(IDCT_SWEEP, "cuda"):
        got = native.idct_islow_u8(coefs, q, size)
        torch.cuda.synchronize()
        if not torch.equal(got, native.idct_islow_u8_ref(coefs, q, size)):
            fail(f"c2_check: the IDCT kernel differs from its plain version "
                 f"on the sweep's {tuple(coefs.shape)} cropped to {size}")
        sweep.append([*coefs.shape[:3], *size])
    out["idct_sweep"] = {"geometries": len(sweep), "bitwise": True,
                         "f_bh_bw_h_w": sweep}
    emit("c2_check", kernel="idct_islow_u8", input="sweep",
         **out["idct_sweep"])
    ref = np.load(os.path.join(FIXTURE, "libjpeg_reference.npz"))
    for key in ref.files:
        kind, size_name = key.rsplit("_", 1)
        paths = {"gray": gray, "color": colour}.get(
            kind, [os.path.join(FIXTURE, f"{kind}.jpg")])
        want = ref[key]
        got = native.decode_video(paths, want.shape[1:3], device="cuda")
        torch.cuda.synchronize()
        if got.device.type != "cuda" or tuple(got.shape) != want.shape:
            fail(f"c2_check: GPU decode of the {kind} fixture gave "
                 f"{tuple(got.shape)} on {got.device}, want {want.shape}")
        differ = int((got.cpu().numpy() != want).sum())
        if differ:
            fail(f"c2_check: GPU decode of the {kind} fixture at "
                 f"{size_name} size: {differ} values differ from the "
                 "host libjpeg route (must be bitwise)")
        out[f"decode_{kind}_{size_name}"] = {
            "frames": len(paths), "shape": list(want.shape),
            "values_differing": 0,
            # channel-0 values the host build rounds off channels 1 and 2
            # (C5: gray_c5 at 160x160 and 248x103)
            "channel_0_off": int((want[..., 0] != want[..., 1]).sum())}
    for size_name in ("160", "248x103"):
        if not out[f"decode_gray_c5_{size_name}"]["channel_0_off"]:
            fail(f"c2_check: gray_c5.jpg's reference at {size_name} shows "
                 "no channel-0 value off channels 1 and 2: the fixture "
                 "does not exercise C5")
    decoded = sorted(k for k in out if k.startswith("decode"))
    if len(decoded) != len(FIXTURE_REFERENCES) or not all(
            f"decode_{k}" in decoded for k in FIXTURE_REFERENCES):
        fail(f"c2_check: decoded {decoded}, want {FIXTURE_REFERENCES}")
    out["huffman_s"], out["huffman_frames"] = huffman_s, len(chunk)
    emit("c2_check", **{k: v for k, v in out.items()
                        if k.startswith("decode")})
    return out


def raw_kernel_checks(torch, native) -> dict:
    """The GPU JPEG route's kernels against their plain versions at the
    paths' shapes (the resize: a 32-frame chunk of 240x360 grayscale frames
    to 256x256 RGB, as the decode resizes a grayscale video, and a 360x640
    colour one to 256x256 RGB; the colour conversion: a 32-frame 4:2:0
    360x640 chunk), bitwise, with device times (CUDA graphs), the bound and, for
    the resize, ``F.interpolate`` on the same frames as float32 NCHW (the
    gray chunk on three channels, as the kernel writes them, and on its one
    channel); then the resize on ``RESIZE_SWEEP`` seeded random sizes, 16 to
    720 pixels a side, up- and downscales, 1 -> 3 and 3 -> 3 channels,
    bitwise; the colour conversion on a 32-frame 4:2:0 360x640 chunk in one
    launch (the decode's) and on one frame, bitwise and timed, then on the
    card tests' sweep (``kernel_sweeps.ycc_sweep``: 4:4:4, 4:2:2 and 4:2:0
    chunks at odd sizes), bitwise."""
    import numpy as np
    import torch.nn.functional as F

    from ammcnet_aaai2021_torch.data.kernel_sweeps import ycc_sweep

    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name, shape in (("gray", (DECODE_CHUNK, *RAW_SHAPE, 1)),
                        ("color", (DECODE_CHUNK, *AVENUE_SHAPE, 3))):
        src = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                            generator=g)
        size = (IMAGE_SIZE, IMAGE_SIZE)
        got = native.resize_bilinear_u8(src, size)
        torch.cuda.synchronize()
        if not torch.equal(got, native.resize_bilinear_u8_ref(src, size)):
            fail(f"resize kernel ({name} {shape} to RGB) differs from its "
                 "plain version")
        n, sh, sw, c = shape
        src_f = src.permute(0, 3, 1, 2).float().contiguous()
        src_f3 = src_f.expand(-1, 3, -1, -1).contiguous()

        def interpolate(x):
            return F.interpolate(x, size=size, mode="bilinear",
                                 align_corners=False)
        row = {"shape": list(shape), "out": [n, *size, 3], "max_abs_err": 0,
               **time_pair(torch, native.resize_bilinear_u8,
                           native.resize_bilinear_u8_ref, src, size),
               "library_call": "F.interpolate(bilinear, align_corners=False)"
                               " on the frames as float32 NCHW, 3 channels",
               "library_ms": graph_ms(torch, lambda: interpolate(src_f3)),
               # 3 lerps (4 operations) and a rounding add per value, the
               # two axis maps (6 each) per pixel
               **bound(n * sh * sw * c + n * size[0] * size[1] * 3,
                       n * size[0] * size[1] * (3 * 13 + 12),
                       "N*sh*sw*c + N*h*w*3", "N*h*w*(3*13 + 12)",
                       FP32_FLOPS, "float32, CUDA cores")}
        if c == 1:
            row["library_ms_one_channel"] = graph_ms(
                torch, lambda: interpolate(src_f))
        out[("resize", name)] = row
        emit("raw_kernel_check", kernel="resize_bilinear_u8", input=name,
             **row)
    rng = np.random.default_rng(20261017)
    sweep = []
    for i in range(RESIZE_SWEEP):
        sh, sw, dh, dw = (int(v) for v in rng.integers(16, 721, 4))
        sc = 1 if i % 2 == 0 else 3
        n = int(rng.integers(1, 5))
        src = torch.randint(0, 256, (n, sh, sw, sc), dtype=torch.uint8,
                            device="cuda", generator=g)
        got = native.resize_bilinear_u8(src, (dh, dw))
        torch.cuda.synchronize()
        if not torch.equal(got, native.resize_bilinear_u8_ref(src, (dh, dw))):
            fail(f"resize kernel differs from its plain version at "
                 f"{n}x{sh}x{sw}x{sc} -> {dh}x{dw}x3")
        sweep.append([n, sh, sw, sc, dh, dw])
    kinds = {"upscales": sum(dh > sh and dw > sw for _, sh, sw, _, dh, dw
                             in sweep),
             "downscales": sum(dh < sh and dw < sw for _, sh, sw, _, dh, dw
                               in sweep),
             "gray_to_rgb": sum(c == 1 for _, _, _, c, _, _ in sweep)}
    out["resize_sweep"] = {"sizes": len(sweep), "bitwise": True, **kinds,
                           "n_sh_sw_sc_dh_dw": sweep}
    emit("raw_kernel_check", kernel="resize_bilinear_u8",
         input="sweep", **out["resize_sweep"])
    h, w = AVENUE_SHAPE
    ch, cw = h // 2, w // 2
    y = torch.randint(0, 256, (DECODE_CHUNK, h, w), dtype=torch.uint8,
                      device="cuda", generator=g)
    cb, cr = (torch.randint(0, 256, (DECODE_CHUNK, ch, cw), dtype=torch.uint8,
                            device="cuda", generator=g) for _ in range(2))
    for key, frames in (("ycc", DECODE_CHUNK), ("ycc_frame", None)):
        planes = ((y, cb, cr) if frames else
                  tuple(p[0].contiguous() for p in (y, cb, cr)))
        n = frames or 1
        got = native.ycc_to_rgb_u8(*planes)
        torch.cuda.synchronize()
        if not torch.equal(got, native.ycc_to_rgb_u8_ref(*planes)):
            fail(f"colour kernel differs from its plain version ({key})")
        row = {"shape": [n, h, w, "4:2:0"], "launches_a_call": 1,
               "max_abs_err": 0,
               **time_pair(torch, native.ycc_to_rgb_u8,
                           native.ycc_to_rgb_u8_ref, *planes),
               "library_ms": None,
               # two upsampled chroma samples (10 integer operations each)
               # and the conversion (15) per pixel
               **bound(n * (h * w + 2 * ch * cw + h * w * 3), n * h * w * 35,
                       "F*(h*w + 2*ch*cw + h*w*3)", "F*h*w*35", FP32_FLOPS,
                       "32-bit operations, CUDA cores")}
        out[key] = row
        emit("raw_kernel_check", kernel="ycc_to_rgb_u8",
             input=f"4:2:0 {h}x{w}, {n} frame{'s' * (n > 1)}", **row)
    sweep = []
    for factors, *planes in ycc_sweep("cuda"):
        got = native.ycc_to_rgb_u8(*planes)
        torch.cuda.synchronize()
        if not torch.equal(got, native.ycc_to_rgb_u8_ref(*planes)):
            fail(f"colour kernel differs from its plain version at "
                 f"{tuple(planes[0].shape)}, chroma factors {factors}")
        sweep.append([*factors, *planes[0].shape])
    out["ycc_sweep"] = {"inputs": len(sweep), "bitwise": True,
                        "hs_vs_shape": sweep}
    emit("raw_kernel_check", kernel="ycc_to_rgb_u8", input="sweep",
         **out["ycc_sweep"])
    return out


def fixture_decode_check(native) -> dict:
    """The committed fixture through ``decode_video`` on the card (the
    Huffman decode, the IDCT, colour and resize kernels) against cv2's
    decode + resize, RGB (cv2 gives a grayscale JPEG's value on all three
    channels)."""
    import numpy as np

    ref = np.load(os.path.join(FIXTURE, "reference.npz"))
    out = {}
    for kind, want in (("gray", np.repeat(ref["gray"][..., None], 3, -1)),
                       ("color", ref["color"])):
        paths = [os.path.join(FIXTURE, f"{kind}_{i:02d}.jpg")
                 for i in range(len(want))]
        got = native.decode_video(paths, want.shape[1:3], device="cuda")
        if got.device.type != "cuda" or tuple(got.shape) != want.shape:
            fail(f"GPU decode of the {kind} fixture: {tuple(got.shape)} on "
                 f"{got.device}, want {want.shape} on the card")
        diff = np.abs(got.cpu().numpy().astype(int) - want)
        out[kind] = {"frames": len(paths), "max_abs_diff": int(diff.max()),
                     "mean_abs_diff": float(diff.mean()),
                     "within_1_lsb": float((diff <= 1).mean())}
        max_lsb, share = ((GRAY_MAX_LSB, GRAY_WITHIN_1_LSB) if kind == "gray"
                          else (COLOR_MAX_LSB, COLOR_WITHIN_1_LSB))
        if diff.max() > max_lsb or (diff <= 1).mean() < share:
            fail(f"GPU decode of the {kind} fixture: {out[kind]}, want max "
                 f"<= {max_lsb} and >= {share} within 1 LSB")
    emit("raw_fixture_decode", **out)
    return out


def extractor_check(torch) -> dict:
    """The extractor's flows in float32 (TF32 off) on the card against the
    same seeded FlowNet2-SD weights on the CPU at 64x64, 9 frames, before
    the bf16 cast."""
    import numpy as np

    from ammcnet_aaai2021_torch.eval.infer import otf_flows
    from ammcnet_aaai2021_torch.models import init_flownet_weights
    from ammcnet_aaai2021_torch.models.flownet_sd import FlowNet2SD

    net = init_flownet_weights(FlowNet2SD(dtype=torch.float32),
                               torch.Generator().manual_seed(1)).eval()
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    video = np.stack([np.clip(
        100 + 40 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
        + 80 * np.exp(-((xx - 10 - 2 * t) ** 2 + (yy - 30) ** 2) / 40.0)
        + rng.normal(0, 3, (64, 64)), 0, 255).astype(np.uint8)
        for t in range(9)])
    video = torch.from_numpy(np.repeat(video[..., None], 3, axis=-1))
    want, _ = otf_flows(net, video)
    got, _ = otf_flows(net.to("cuda"), video.to("cuda"))
    scale = float(want.abs().max())
    err = float((got.cpu() - want).abs().max())
    if not scale > 0 or err > OTF_REL * scale:
        fail(f"extractor on the card vs the CPU: max |diff| {err} of max "
             f"|flow| {scale} (> {OTF_REL} of it)")
    out = {"frames": 9, "size": 64, "dtype": "float32", "max_abs_err": err,
           "max_abs_flow": scale, "tol_rel": OTF_REL}
    emit("raw_extractor_check", **out)
    return out


def raw_run(torch, mk, native, run_test, root: str, name: str,
            dataset: str, flags, lengths) -> dict:
    """``run_test.main`` with ``--native_loader`` and ``flags`` on the raw
    ``dataset`` split at ``root``, every count set to 0 just before and
    read just after; fails unless the records are finite, one per frame,
    the AUC line printed, every B1 launch on the tensor-core route (two a
    forward), the resize kernel launched once a 32-frame chunk, the IDCT
    once a chunk and component, the colour kernel once a colour chunk and
    FlowNet2-SD (with ``--on_the_fly_flow``) once a 16 pairs of each
    bucket-padded video."""
    import numpy as np

    argv = ["--dataset_name", dataset, "--data_dir", root, "--save_dir",
            os.path.join(root, f"eval_{name}"), "--native_loader", *flags]
    forwards = sum(math.ceil((t - CLIP_LEN_RGB + 1) / WINDOW_BATCH)
                   for t in lengths)
    flownet = sum(math.ceil((-(-t // BUCKET) * BUCKET - 1) / OTF_CHUNK)
                  for t in lengths) if "--on_the_fly_flow" in flags else 0
    resizes = sum(math.ceil(t / DECODE_CHUNK) for t in lengths)
    conversions = resizes if dataset != "ped2" else 0  # colour chunks
    idcts = resizes * (1 if dataset == "ped2" else 3)
    stdout = io.StringIO()
    torch.cuda.synchronize()
    reset_launches(mk)
    reset_native_launches(native)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        res = run_test.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"b1": dict(mk.quantize_topk_fused.launches_by_route),
                "idct_islow_u8": native.idct_islow_u8.launches,
                "resize_bilinear_u8": native.resize_bilinear_u8.launches,
                "ycc_to_rgb_u8": native.ycc_to_rgb_u8.launches,
                "flownet_forwards": res["flownet_forwards"]}
    printed = stdout.getvalue()
    print(printed, end="", flush=True)
    with open(res["pickle"], "rb") as fh:
        records = pickle.load(fh)
    if "the optimal auc = " not in printed:
        fail(f"raw_path {name}: run_test printed no 'the optimal auc =' line")
    for key in ("rgb_img_pred_records", "rgb_fea_comm_records",
                "op_img_pred_records", "op_fea_comm_records"):
        if [len(r) for r in records[key]] != list(lengths):
            fail(f"raw_path {name}: {key} lengths differ from {lengths}")
        if not all(np.isfinite(r).all() for r in records[key]):
            fail(f"raw_path {name}: {key} not finite")
    want = {"b1": {r: 2 * forwards * (r == mk.TENSOR_CORE) for r in mk.ROUTES},
            "idct_islow_u8": idcts,
            "resize_bilinear_u8": resizes, "ycc_to_rgb_u8": conversions,
            "flownet_forwards": flownet}
    if launches != want:
        fail(f"raw_path {name}: launches {launches}, want {want}")
    frames = sum(lengths)
    return {"run": name, "dataset": dataset,
            "source_shape": list(RAW_SHAPE if dataset == "ped2"
                                 else AVENUE_SHAPE),
            "flags": ["--native_loader", *flags], "videos": len(lengths),
            "frames": frames, "wall_s": wall, "frames_per_s": frames / wall,
            "run_test_fps": res["fps"], "auc": res["auc"],
            "launches": launches, "records": records}


def raw_path_phase(torch, mk) -> dict:
    """The raw-video path at full width: the GPU JPEG route's kernels and
    the fixture decode, the extractor check, then a ped2-shaped raw split
    (Ped2's 12 test lengths, 2,010 frames) scored three times by
    ``run_test.main`` with the released configuration (bf16, 256x256,
    seeded random generator and FlowNet2-SD): JPEG + ``.flo``, on-the-fly
    flow with the gray upload, and with a 3-channel upload; the last two
    bitwise equal (cuDNN deterministic in this phase); then an
    Avenue-shaped colour split scored with on-the-fly flow.  Then the
    decode seconds, the ``.flo`` load seconds and FlowNet's device ms per
    video."""
    import numpy as np

    from ammcnet_aaai2021_torch.data import native
    from ammcnet_aaai2021_torch.data.datasets import VideoIndex
    from ammcnet_aaai2021_torch.eval.infer import make_otf_flow_extractor
    from ammcnet_aaai2021_torch.models import init_flownet_weights
    from ammcnet_aaai2021_torch.models.flownet_sd import FlowNet2SD
    from ammcnet_aaai2021_torch.runners import run_test

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c2 = c2_phase(torch, native)
    kernels = raw_kernel_checks(torch, native)
    extractor = extractor_check(torch)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    lengths = {"ped2": PED2_TEST_LENGTHS, "avenue": AVENUE_TAIL_LENGTHS}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        roots = {("ped2", True): os.path.join(tmp, "with_flows"),
                 ("ped2", False): os.path.join(tmp, "frames_only"),
                 ("avenue", False): os.path.join(tmp, "colour")}
        t0 = time.perf_counter()
        for (dataset, flows), root in roots.items():
            write_raw_tree(root, dataset, lengths[dataset], flows)
        data_s = time.perf_counter() - t0
        fixture = fixture_decode_check(native)
        for name, dataset, flags in RAW_RUNS:
            root = roots[(dataset, "--on_the_fly_flow" not in flags)]
            runs[name] = raw_run(torch, mk, native, run_test, root, name,
                                 dataset, flags, lengths[dataset])
        for key in runs["otf_gray"]["records"]:
            if key != "dataset" and not all(
                    np.array_equal(a, b) for a, b in zip(
                        runs["otf_gray"]["records"][key],
                        runs["otf_rgb"]["records"][key])):
                fail(f"raw_path: the gray upload's {key} differ from the "
                     "3-channel upload's (the broadcast is exact)")

        # decode and .flo seconds a video, and FlowNet2-SD's device time a
        # video
        size = (IMAGE_SIZE, IMAGE_SIZE)

        def index(root, dataset, kind):
            return VideoIndex(os.path.join(root, dataset, "testing", kind))

        def decode_seconds(frames):
            """Each video's decode seconds, and its host entropy decode's
            seconds inside it (the decoder's own clock)."""
            out, entropy = [], []
            for name in frames.names:
                before = native.decode_video.host_s["entropy"]
                t0 = time.perf_counter()
                video = native.decode_video(frames.videos[name], size,
                                            device="cuda")
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
                entropy.append(native.decode_video.host_s["entropy"] - before)
            return out, entropy, video

        root = roots[("ped2", True)]
        colour_s, colour_entropy_s, _ = decode_seconds(
            index(roots[("avenue", False)], "avenue", "frames"))
        ped2 = index(root, "ped2", "frames")
        decode_s, entropy_s, video = decode_seconds(ped2)
        # the entropy decode alone through the "coef" host library
        # (decode_coefs: the same decode, plus a header pass a file and
        # numpy arrays a component) on the same 180-frame videos and the
        # decoder's threads
        threads = inspect.signature(native.decode_video).parameters[
            "n_threads"].default
        coefs_s = []
        for name in ped2.names:
            if len(ped2.videos[name]) == 180:
                t0 = time.perf_counter()
                native.decode_coefs(ped2.videos[name], n_threads=threads)
                coefs_s.append(time.perf_counter() - t0)
        flows = index(root, "ped2", "flows")
        flo_s = []
        for name in flows.names:
            t0 = time.perf_counter()
            native.load_flow_video(flows.videos[name], size)
            flo_s.append(time.perf_counter() - t0)
        flownet = init_flownet_weights(FlowNet2SD(), torch.Generator()
                                       .manual_seed(1))
        flownet.to("cuda").eval()
        # the last ped2 video's channel 0 on the card, as --gray_upload
        # hands it to the extractor
        video = video[..., :1].contiguous()
        extract = make_otf_flow_extractor(flownet, pad_to=192, gray=True)
        flownet_ms = time_ms(torch, lambda: extract(video), reps=5, warmup=1)
    torch.backends.cudnn.deterministic = deterministic
    for run in runs.values():
        emit("raw_path", cudnn_deterministic=True, image_size=IMAGE_SIZE,
             data_write_s=data_s,
             **{k: v for k, v in run.items() if k != "records"})
    decode_180 = float(np.mean(
        [s for s, t in zip(decode_s, PED2_TEST_LENGTHS) if t == 180]))
    entropy_180 = float(np.mean(
        [s for s, t in zip(entropy_s, PED2_TEST_LENGTHS) if t == 180]))
    host = {"decode_s_per_video": decode_s,
            "decode_s_per_180_frames": decode_180,
            "entropy_decode_threads": threads,
            "entropy_decode_s_per_video": entropy_s,
            "entropy_decode_s_per_180_frames": entropy_180,
            "entropy_share_of_decode": entropy_180 / decode_180,
            "decode_coefs_s_per_180_frames": float(np.mean(coefs_s)),
            "decode_coefs_s_each_180_frame_video": coefs_s,
            "colour_entropy_share_of_decode": sum(colour_entropy_s)
            / sum(colour_s),
            "colour_decode_s_per_video": colour_s,
            "colour_decode_ms_per_frame": 1e3 * sum(colour_s)
            / sum(AVENUE_TAIL_LENGTHS),
            "flo_load_s_per_video": flo_s,
            "flownet_ms_per_192_frame_video": flownet_ms,
            "flownet_ms_per_pair": flownet_ms / 191}
    emit("raw_path_host", **host)
    return {"runs": runs, "kernels": kernels, "fixture": fixture,
            "extractor": extractor, "host": host, "c2": c2}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--videos", type=int, default=len(PED2_TEST_LENGTHS),
                        help="ped2-shaped videos in the main path (cut only "
                             "to fit a time limit)")
    args = parser.parse_args(argv)

    started = time.perf_counter()
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
    # the CUDA-core route of B1 and B2; their tensor-core route; the GPU
    # JPEG route (the host Huffman decode, the IDCT, colour and resize
    # kernels); the int8 convolutions
    seconds = cuda_build.build(["quantize_topk", "quantize_topk_mma",
                                "jpeg_decode", "int8_conv"])
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
    train_checks = train_kernel_phase(torch, mk)
    c1_times = c1_phase(torch, mk)
    model_phase(torch, mk)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    with tempfile.TemporaryDirectory() as tmp:
        main_run = main_path_phase(torch, mk, args.videos, tmp)
        int8 = int8_path_phase(torch, mk, tmp, main_run)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    train_check_phase(torch, mk)
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    train_run = train_path_phase(torch, mk)
    stage1_runs = stage1_path_phase(torch, mk)
    raw = raw_path_phase(torch, mk)

    bf16 = checks[("bfloat16", 192 * 32 * 32, 2)]
    video = checks[("bfloat16", 176 * 32 * 32, 2)]
    psnr = checks[("bfloat16", 4 * 32 * 32, 2)]
    b2 = train_checks[(4 * 32 * 32, "bfloat16")]
    b2_f32 = train_checks[(4 * 32 * 32, "float32")]
    b2_big = train_checks[(192 * 32 * 32, "bfloat16")]
    b2_f32_big = train_checks[(192 * 32 * 32, "float32")]
    b2_keys = ("kernel_ms", "kernel_eager_ms", "previous_kernel_ms",
               "lookup_ms", "stats_ms", "plain_ms", "bound_ms", "bound_by")
    cc_keys = ("kernel_ms", "kernel_eager_ms", "plain_ms", "bound_ms",
               "bound_by")
    cc_b2_keys = cc_keys + ("lookup_ms", "stats_ms", "top1_max_share")

    def cc_times(name, k):
        """The general route's timed rows of one wrapper at this k."""
        keys = cc_b2_keys if name == "quantize_topk_train_fused" else cc_keys
        return {f"at_n_{n}_n_embed_{n_embed}": {
            key: c1_times[(name, n, n_embed, kk)][key] for key in keys}
            for n, n_embed, kk in C1_TIMED if kk == k}

    def int8_row(kind):
        """The int8 kernel's launch of the timed forward with the most
        operations."""
        return max((r for r in int8["checks"].values() if r["kind"] == kind),
                   key=lambda r: r["flops"])

    def int8_at(row):
        return (f"{row['name']}: {row['size']}x{row['size']} in, "
                f"{row['cin']} -> {row['cout']}, {row['windows']} windows")

    def int8_by_shape(kind):
        return {name: {key: row[key] for key in (
            "sites", "windows", "cin", "cout", "per_forward", "kernel_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "cudnn_bf16_ms")} for name, row in int8["checks"].items()
            if row["kind"] == kind}
    conv3, conv2 = int8_row("3x3"), int8_row("2x2")

    def stage1_launches(kernel):
        return {name: run["launches_by_route"][kernel]
                for name, run in stage1_runs.items()}
    emit("total", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": [{
        "name": "quantize_topk_fused",
        "route": "cuda",
        "kernel_route": mk.TENSOR_CORE,
        "source": "ammcnet_aaai2021_torch/csrc/quantize_topk_mma.cu",
        "replaces": "ammcnet_aaai2021_tpu/ops/memory_pallas.py:48",
        "launches": main_run["quantize_topk_launches"],
        "launches_by_route": main_run["quantize_topk_launches_by_route"],
        "launches_by_path": {"score": main_run["quantize_topk_launches"],
                             "train": train_run["quantize_topk_launches"],
                             **stage1_launches("b1")},
        "max_abs_err": max(v["max_abs_err"] for v in checks.values()),
        "flips": bf16["flips"],
        "ms": bf16["kernel_ms"],
        "kernel_ms": bf16["kernel_ms"],
        "kernel_eager_ms": bf16["kernel_eager_ms"],
        "previous_kernel_ms": bf16["previous_kernel_ms"],
        "previous_source": "ammcnet_aaai2021_torch/csrc/quantize_topk.cu",
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": None,
        "at_n_180224": {key: video[key] for key in (
            "kernel_ms", "kernel_eager_ms", "previous_kernel_ms", "plain_ms",
            "bound_ms", "bound_by")},
        "at_n_4096": {key: psnr[key] for key in (
            "kernel_ms", "kernel_eager_ms", "previous_kernel_ms", "plain_ms",
            "bound_ms", "bound_by")},
        "float32_route": {"kernel_route": mk.CUDA_CORE,
                          "source": "ammcnet_aaai2021_torch/csrc/"
                                    "quantize_topk.cu",
                          **{key: checks["float32"][key] for key in (
                              "kernel_ms", "kernel_eager_ms", "plain_ms",
                              "bound_ms", "bound_by", "flips")},
                          "at_k_2": cc_times("quantize_topk_fused", 2),
                          "at_k_16": cc_times("quantize_topk_fused", 16)},
    }, {
        "name": "quantize_topk_train_fused",
        "route": "cuda",
        "kernel_route": mk.TENSOR_CORE,
        "source": "ammcnet_aaai2021_torch/csrc/quantize_topk_mma.cu",
        "replaces": "ammcnet_aaai2021_tpu/ops/memory_pallas.py:84",
        "launches": train_run["quantize_topk_train_launches"],
        "launches_by_route": train_run[
            "quantize_topk_train_launches_by_route"],
        "launches_by_path": {"train": train_run["quantize_topk_train_launches"],
                             **stage1_launches("b2")},
        "max_abs_err": max(b2["max_abs_err"], b2_f32["max_abs_err"]),
        "esum_max_rel_err": max(b2["esum_max_rel_err"],
                                b2_f32["esum_max_rel_err"]),
        "flips": b2["flips"],
        "flips_vs_b1": b2["flips_vs_b1"],
        "ms": b2["kernel_ms"],
        **{key: b2[key] for key in b2_keys},
        "previous_source": "ammcnet_aaai2021_torch/csrc/quantize_topk.cu",
        "library_ms": None,
        "at_n_196608": {key: b2_big[key] for key in b2_keys},
        "float32_route": {"kernel_route": mk.CUDA_CORE,
                          "source": "ammcnet_aaai2021_torch/csrc/"
                                    "quantize_topk.cu",
                          **{key: b2_f32[key] for key in (
                              "kernel_ms", "kernel_eager_ms", "plain_ms",
                              "bound_ms", "bound_by", "flips",
                              "esum_max_rel_err", "lookup_ms", "stats_ms",
                              "top1_max_share")},
                          "at_n_196608": {key: b2_f32_big[key]
                                          for key in cc_b2_keys},
                          "at_k_2": cc_times("quantize_topk_train_fused", 2),
                          "at_k_16": cc_times("quantize_topk_train_fused",
                                              16)},
    }, {
        "name": "resize_bilinear_u8",
        "route": "cuda",
        "source": "ammcnet_aaai2021_torch/csrc/jpeg_decode.cu",
        "replaces": "ammcnet_aaai2021_tpu/native/ammc_loader.cpp:54",
        "launches": sum(run["launches"]["resize_bilinear_u8"]
                        for run in raw["runs"].values()),
        "launches_by_path": {
            name: run["launches"]["resize_bilinear_u8"]
            for name, run in raw["runs"].items()},
        "max_abs_err": 0,
        "ms": raw["kernels"][("resize", "gray")]["kernel_ms"],
        "at": "32 gray 240x360 frames to 256x256 RGB",
        **{key: raw["kernels"][("resize", "gray")][key] for key in (
            "kernel_ms", "kernel_eager_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_call",
            "library_ms_one_channel")},
        "at_colour_360x640": {key: raw["kernels"][("resize", "color")][key]
                              for key in ("kernel_ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
        "sweep_sizes_bitwise": raw["kernels"]["resize_sweep"]["sizes"],
    }, {
        "name": "idct_islow_u8",
        "route": "cuda",
        "source": "ammcnet_aaai2021_torch/csrc/jpeg_decode.cu",
        "replaces": "ammcnet_aaai2021_tpu/native/ammc_loader.cpp:121",
        "launches": sum(run["launches"]["idct_islow_u8"]
                        for run in raw["runs"].values()),
        "launches_by_path": {
            name: run["launches"]["idct_islow_u8"]
            for name, run in raw["runs"].items()},
        "max_abs_err": 0,
        "ms": raw["c2"]["gray"]["kernel_ms"],
        **{key: raw["c2"]["gray"][key] for key in (
            "kernel_ms", "kernel_eager_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "at": "a 32-frame gray 240x360 chunk",
        "at_colour_360x640": {
            name: {key: raw["c2"][name][key] for key in (
                "kernel_ms", "plain_ms", "bound_ms", "bound_by")}
            for name in ("color_y", "color_cb", "color_cr")},
        "sweep_geometries_bitwise": raw["c2"]["idct_sweep"]["geometries"],
    }, {
        "name": "qconv3x3_int8",
        "route": "cuda",
        "source": "ammcnet_aaai2021_torch/csrc/int8_conv.cu",
        "replaces": "ammcnet_aaai2021_tpu/models/quantized.py:153",
        "launches": int8["run"]["launches"]["qconv3x3_int8"],
        "max_abs_err": 0,
        "ms": conv3["kernel_ms"],
        **{key: conv3[key] for key in (
            "kernel_eager_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_call", "library_windows",
            "cudnn_bf16_ms")},
        "at": int8_at(conv3),
        "per_forward": int8["totals"]["3x3"],
        "by_shape": int8_by_shape("3x3"),
    }, {
        "name": "qconv_transpose2x2_int8",
        "route": "cuda",
        "source": "ammcnet_aaai2021_torch/csrc/int8_conv.cu",
        "replaces": "ammcnet_aaai2021_tpu/models/quantized.py:177",
        "launches": int8["run"]["launches"]["qconv_transpose2x2_int8"],
        "max_abs_err": 0,
        "ms": conv2["kernel_ms"],
        **{key: conv2[key] for key in (
            "kernel_eager_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_call", "cudnn_bf16_ms")},
        "at": int8_at(conv2),
        "per_forward": int8["totals"]["2x2"],
        "by_shape": int8_by_shape("2x2"),
    }, {
        "name": "ycc_to_rgb_u8",
        "route": "cuda",
        "source": "ammcnet_aaai2021_torch/csrc/jpeg_decode.cu",
        "replaces": "ammcnet_aaai2021_tpu/native/ammc_loader.cpp:130",
        "launches": raw["runs"]["avenue_color"]["launches"]["ycc_to_rgb_u8"],
        # one launch a 32-frame chunk: before, one a frame
        "frames_converted": raw["runs"]["avenue_color"]["frames"],
        "launches_by_path": {
            name: run["launches"]["ycc_to_rgb_u8"]
            for name, run in raw["runs"].items()},
        "max_abs_err": 0,
        "ms": raw["kernels"]["ycc"]["kernel_ms"],
        "at": "a 32-frame 4:2:0 360x640 chunk, one launch",
        **{key: raw["kernels"]["ycc"][key] for key in (
            "kernel_ms", "kernel_eager_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "at_one_frame": {key: raw["kernels"]["ycc_frame"][key] for key in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by")},
        "sweep_inputs_bitwise": raw["kernels"]["ycc_sweep"]["inputs"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
