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
   conv launched through the int8 kernels, each of a scoring forward's 24
   statically quantized conv inputs through the int8 quantize kernel and
   B1 twice a forward; then the same command again with every int8 kernel
   call of the first forward at each of its batch sizes (the
   calibration's 8 windows, each video length's) held against its plain
   version, accumulators and output bitwise, and each distinct launch of
   the largest forward timed on its real inputs beside its bound, cuDNN's
   bf16 convolution of the shape and ``torch._int_mm`` of its product (the
   3x3 conv's im2col'd, the im2col outside the timed window), and each
   distinct quantize launch on its real inputs widened to 192 windows
   beside its bytes' bound and its plain version (the PyTorch ops the
   forward ran before the kernel);
   then ``ckpt_path``: the released generator, seeded, written as the
   JAX package's flax ``.msgpack`` (a writer here, byte for byte flax's)
   and as a ``.pth``, each scored by ``run_test --ckptfile`` on a 3-video
   ped2-shaped split, records bitwise equal and B1 twice a forward on its
   tensor-core route; an orbax step dir of the same variables raises
   ``ImportError`` naming tensorstore and the converter (or, where
   tensorstore is installed, scores the same records); then
   ``export_path``: ``runners.export_model --check`` exports the chunk
   scorer of the released configuration (bf16, then ``--int8`` calibrated
   on 32 training clips) for 2 Ped2-length videos bucket-padded to 192
   frames; each artifact, loaded through ``eval.export`` alone, scores the
   split's first 2 videos within 1e-3/1e-2 of the live scorer, launches
   B1 twice a forward on its tensor-core route (and the int8 one every
   3x3 and transposed conv and 24 quantized inputs a forward on the int8
   kernels), and refuses to load for
   the CPU; the int8 records correlate >= 0.99 with the bf16 ones; sizes,
   export and load seconds, and ms a chunk live and loaded; then
   ``flownet2_path``: FlowNet 2.0 (seeded weights, bf16) through the
   extractor ``run_test --on_the_fly_flow --flownet FlowNet2
   --gray_upload`` builds, over Ped2's first 4 lengths of 256x256 gray
   frames padded to 192 (6 forwards a video at the network's 32 pairs,
   the last 31): the correlation kernel launched once a forward and never
   its plain version, every call's output held against the plain version
   in float32 within the summation bound (``CORR_ROUNDING``), and the
   kernel timed on a forward's real inputs at 32 and 31 pairs beside its
   bound and the plain version, alone (on NCHW copies) and as the op the
   path calls (``op_ms``: the maps arrive channels-last, and the wrapper
   copies them to NCHW first);
6. train check: one float32 training step of the released generator at
   256x256, batch 4, through the kernels and through plain PyTorch; then
   ``remat_check``: one bf16 step at full width with ``remat=False`` and
   ``remat=True`` from one state and batch (g_loss, parameters, buffers
   bitwise; B2 and B1 launches a step), then 10 steps of each timed, with
   the peak memory allocated; then ``family_path``: the model family at
   full width (NetConfig's widths, batch 8, 256x256, seeded weights): the
   tags ``unet``, ``vqvae``, ``vqvae_topk``, ``vqvae_topk_res`` and
   ``vqvae_twostream``, ``UNetMemV4`` and the two-stream generator with
   the concat and add bridges, each in a bf16 eval forward through the
   kernels and through plain PyTorch (indices under the near-tie rule,
   then the outputs of the samples without a flip), a float32 train-mode
   forward and backward through B2's CUDA-core route and through plain
   PyTorch (loss, every gradient, every buffer within ``MODEL_TOL``) and
   a bf16 one counted (B2 once a memory, tensor-core route); then
   ``tools.summarize`` for every tag (totals pinned by the CPU tests),
   and B1 and B2 at the VQ-VAE nets' lookup sizes (N = 8,192 and 32,768,
   bf16, k 1 and 2) against their plain versions, timed; then the
   multi-process phases: ``dp_check`` (a process group of one rank, NCCL:
   one bf16 and one float32 stage-2 step of the released configuration,
   batch 4, with and without the group from one state, within the stated
   bounds; B2 twice a step on each dtype's route; the all-reduces a step;
   ms a step each way), ``dp_path`` (two ranks of this script on the one
   card, gloo with CUDA tensors, two samples each of a global batch of 4:
   three float32 steps, each against one process's step on the global
   batch from the same state, then three bf16 steps; B2's launches, the
   all-reduces and ms a step per rank) and ``mh_score`` (two ranks run
   ``run_test`` on the main path's split cut to Ped2's first 4 lengths:
   rank 0's merged records bitwise one process's, the same AUC line, B1
   twice a forward on each rank, the shard directory removed);
7. training path: ``runners.run_train.main`` trains the released
   configuration (bf16, batch 4, 256x256) for 30 steps on a numpy training
   tree, then resumes from its step-30 checkpoint to step 40; checks the
   scalars, the codebook, the checkpoint and the kernels' launches (B2 twice
   per step, B1 twice per train-PSNR forward, all on the tensor-core
   route); then 30 steps with ``--fetch_every_periods 2
   --async_checkpoints --step_save 20`` (steps 10 and 20 fetched in one
   copy, the step-20 checkpoint written on the writer thread), resumed
   from it to step 40 with the same flags: every log row in the scalars,
   the writer thread's step-40 checkpoint restoring bit-exactly; then
   ``watch_path``: ``runners.watch_eval --once --sweep`` on that run's
   step-30 and step-40 checkpoints against the main path's split cut to 3
   videos (two CSV rows, each AUC ``run_test``'s on the same checkpoint,
   B1 twice a forward; a second pass scores nothing, the other
   ``--sweep`` setting raises); then ``tools_path``: ``device_bench
   --passes 3`` (bf16, ``--int8 --calibrated``, ``--folded``: frames/s
   with the card's name), the folded forward against the unfolded one at
   full width (float32, 16 windows, near-tie rule, ``MODEL_TOL``),
   ``dtype_bench`` over the four levels, ``train_flops --measure`` (B2
   twice a step) and ``run_recipe`` on a 64x64 ``.npy`` toydata, 10
   iterations a stage (B2 once a stage-1 and twice a stage-2 step), its
   AUC line printed;
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
import struct
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


def generator_lookups(torch, net, *inputs):
    """One inference forward of the generator, and for each memory (in
    forward order) its latents (N, dim), its output codewords' indices
    (N, k) and its codebook.  A ``"top1"`` memory outputs its chosen
    codewords cast to the latents' type, so each index is the codeword
    that output equals exactly; a ``"topk"`` memory (the VQ-VAE nets')
    outputs ``z + (q - z)`` in float32 cast to that type, so each output
    block lies within two of the type's epsilons (relative) of its
    codeword."""
    from ammcnet_aaai2021_torch.models import TopKMemory

    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((mod, inp[0], out[0])))
        for m in net.modules() if isinstance(m, TopKMemory)]
    try:
        with torch.inference_mode():
            outs = net(*inputs)
    finally:
        for h in hooks:
            h.remove()
    lookups = []
    for mod, z, q in seen:
        dim, k = mod.embed_dim, mod.k
        zf = z.permute(0, 2, 3, 1).reshape(-1, dim)
        qf = q.permute(0, 2, 3, 1).reshape(-1, k * dim).double()
        words = mod.embed.t().to(z.dtype).double()
        slack = 0.0 if mod.st_mode == "top1" else 2 * torch.finfo(z.dtype).eps
        idx = []
        for j in range(k):
            block = qf[:, j * dim:(j + 1) * dim]
            # differences, not the expanded quadratic form: exactly 0 at a
            # match
            dist = torch.cdist(block, words,
                               compute_mode="donot_use_mm_for_euclid_dist")
            i = dist.argmin(dim=1)
            if bool(((block - words[i]).abs()
                     > slack * words[i].abs()).any()):
                fail("a memory output that is not one of its codewords")
            idx.append(i)
        lookups.append({"z": zf, "idx": torch.stack(idx, 1),
                        "embed": mod.embed.clone(), "rows_per_sample":
                        z.shape[2] * z.shape[3]})
    return outs, lookups


def output_tensors(out) -> list:
    """A generator's outputs (a tensor or nested tuples), flattened."""
    if not isinstance(out, (tuple, list)):
        return [out]
    return [t for item in out for t in output_tensors(item)]


def compare_lookup_runs(torch, what: str, runs, batch: int) -> dict:
    """Two runs ``(outputs, lookups)`` of one generator on one input, the
    first through the kernels and the second through plain PyTorch.  The
    lookups' indices first: a flip fails unless it is a near-tie.  The
    samples whose indices all agree feed the same codewords to the same
    convolutions, so their outputs agree to ``MODEL_TOL`` (a batch-mean
    output only when no sample flipped)."""
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
            fail(f"{what}: the kernel and plain lookups pick codewords "
                 f"whose float64 distances differ by {worst_gap:.3g} "
                 f"relative (>= {NEAR_TIE_REL})")
        flipped |= set((rows.nonzero()[:, 0] // lk["rows_per_sample"])
                       .tolist())
    same = [b for b in range(batch) if b not in flipped]
    pairs = [(a, b) for a, b in zip(output_tensors(outs_k),
                                    output_tensors(outs_p))
             if a.ndim > 0 or not flipped]
    err = max((float((a[same].float() - b[same].float()).abs().max())
               if a.ndim > 0 else float((a.float() - b.float()).abs())
               for a, b in pairs), default=0.0)
    if err > MODEL_TOL:
        fail(f"{what}: kernel route and plain route differ by {err} "
             f"(> {MODEL_TOL}) on samples without a flipped index")
    return {"flips_per_memory": flips, "flip_max_rel_gap": worst_gap,
            "samples_compared": len(same), "latents_max_abs_diff": z_diff,
            "codewords_used_per_memory": [
                int(lk["idx"][:, 0].unique().numel()) for lk in look_k],
            "max_abs_err": err, "tol": MODEL_TOL}


def model_phase(torch, mk) -> None:
    """The released generator on a small input at 256x256, its memory
    lookups in the kernel and in plain PyTorch (``use_memory_kernel=False``),
    in float32 (TF32 off) and in the main path's bfloat16, held by
    :func:`compare_lookup_runs`."""
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
            outs, lookups = generator_lookups(torch, net, rgb, op)
            torch.cuda.synchronize()
            launched = mk.quantize_topk_fused.launches_by_route[route] - before
            if launched != (2 if use_kernel else 0):
                fail(f"{dtype} generator (use_memory_kernel={use_kernel}) "
                     f"launched B1's {route} route {launched} times")
            runs.append((outs, lookups))
        res = compare_lookup_runs(torch, f"{dtype} generator", runs, batch)
        emit("model_check", dtype=dtype, route=route, batch=batch,
             image_size=IMAGE_SIZE, **res)


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
                    int8_kernels.quantize_pack_int8,
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
    dataset = write_scoring_tree(tmp, lengths)
    data_s = time.perf_counter() - t0
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
    call's site, unpadded input width and record pass), the two conv
    kernel entries and the quantize's (``ops/library.py``, each the
    registered op over its kernel wrapper).  A forward begins where a site
    repeats.  Every call of the first forward at each batch size is held
    against its plain version, bitwise: a conv's output the forward went
    on with and the int32 accumulators of an uncounted relaunch, the
    quantize's int8 input.  The largest scoring forward keeps one call's
    arguments for each distinct launch, for timing."""

    HELPERS = ("_qconv", "_qconv_transpose")
    KERNELS = ("qconv3x3_int8", "qconv_transpose2x2_int8")
    PACK = "quantize_pack_int8"

    def __init__(self):
        from ammcnet_aaai2021_torch.models import quantized
        from ammcnet_aaai2021_torch.ops import int8_kernels as ik

        self.quantized, self.ik = quantized, ik
        self.saved = {}
        self.site, self.true_cin = None, None
        self.sites = set()  # the current forward's
        self.checking, self.timing_forward = False, False
        self.batches = []  # one dict a checked forward
        self.timing_windows, self.timing, self.pack_timing = 0, {}, {}
        self.helper_calls = self.kernel_calls = self.pack_calls = 0

    def __enter__(self):
        for name in self.HELPERS + self.KERNELS + (self.PACK,):
            fn = self.saved[name] = getattr(self.quantized, name)
            setattr(self.quantized, name, (
                self._helper if name in self.HELPERS else
                self._kernel if name in self.KERNELS else self._pack)(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.quantized, name, fn)

    def _helper(self, fn):
        signature = inspect.signature(fn)

        def helper(*args, **kwargs):
            a = signature.bind(*args, **kwargs)
            a.apply_defaults()
            skip = a.arguments.get("skip")
            self._begin(a.arguments["site"], a.arguments["x"],
                        a.arguments["record"] is not None,
                        0 if skip is None else skip.shape[-1])
            return fn(*args, **kwargs)
        return helper

    def _begin(self, site: str, x, record: bool, skip_cin: int) -> None:
        if site in self.sites:
            self.sites = set()
        if not self.sites:  # a forward's first call
            n = x.shape[0]
            self.checking = n not in [b["windows"] for b in self.batches]
            if self.checking:
                self.batches.append({"windows": n, "record_pass": record,
                                     "calls": {k: 0 for k in (
                                         *self.KERNELS, self.PACK)}})
            self.timing_forward = not record and n > self.timing_windows
            if self.timing_forward:
                self.timing_windows = n
                self.timing, self.pack_timing = {}, {}
        self.sites.add(site)
        self.site, self.true_cin = site, skip_cin + x.shape[-1]
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

        # the kernel wrapper under the registered op counts the launches
        wrapper = getattr(self.ik, fn.__name__)
        launches = wrapper.launches
        acc = fn(*args, **kwargs, acc=True)
        wrapper.launches = launches  # a comparison's launch does not count
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
        # timed as the kernel wrapper itself, without the op's dispatch
        self.timing[key] = {
            "fn": getattr(self.ik, fn.__name__), "plain": plain,
            "args": args, "kwargs": kwargs,
            "sites": [self.site], "true_cin": self.true_cin, "relu": relu,
            "out_bytes": out.numel() * out.element_size(),
            "epilogue": ("int8" if out.element_size() == 1
                         else "bf16_relu" if relu else "bf16")}

    def _pack(self, fn):
        plain = self.ik.quantize_pack_int8_ref
        signature = inspect.signature(plain)

        def pack(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.pack_calls += 1
            a = signature.bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            if self.checking:
                self._check_pack(plain, a, out)
            if self.timing_forward:
                x, skip = a["x"], a["skip"]
                key = (tuple(x.shape), x.stride(), str(x.dtype),
                       None if skip is None else tuple(skip.shape),
                       a["pool"])
                if key in self.pack_timing:
                    self.pack_timing[key]["sites"].append(self.site)
                else:
                    self.pack_timing[key] = {"args": a,
                                             "sites": [self.site]}
            return out
        return pack

    def _check_pack(self, plain, a, out) -> None:
        import torch

        x, skip = a["x"], a["skip"]
        for i in range(0, x.shape[0], PLAIN_SLICE):
            part = slice(i, i + PLAIN_SLICE)
            want = plain(x[part], a["sx"],
                         None if skip is None else skip[part], a["pool"])
            if out.dtype != want.dtype or not torch.equal(out[part], want):
                bad = int((out[part] != want).sum())
                fail(f"int8_path: {self.PACK} at {self.site} (input "
                     f"{tuple(x.shape)}, windows {i}+): {bad} of its int8 "
                     "values differ from the plain version")
        self.batches[-1]["calls"][self.PACK] += 1


def widen(torch, t, n: int):
    """``t`` with its leading (window) axis repeated to ``n``, in ``t``'s
    own layout: a permuted or sliced view keeps the order of its strides
    (an NCHW slice seen as NHWC stays channel-strided).  ``None`` stays."""
    if t is None or t.shape[0] >= n:
        return t
    order = sorted(range(t.ndim), key=lambda d: -t.stride(d))
    axis = order.index(0)
    phys = t.permute(order)
    reps = -(-n // t.shape[0])
    wide = torch.cat([phys] * reps, dim=axis).narrow(axis, 0, n)
    return wide.permute([order.index(d) for d in range(t.ndim)])


def int8_pack_timing_rows(torch, rec: Int8Recorder) -> dict:
    """One row per distinct quantize launch of the largest scoring
    forward, its real inputs widened to ``WINDOW_BATCH`` windows: the
    kernel's device time (CUDA graphs of 20 calls) and eager time, its
    plain version's (the PyTorch ops the forward ran before the kernel:
    the cat or the pool, the float32 quantize, the padding), beside the
    bound of its compulsory bytes."""
    from ammcnet_aaai2021_torch.ops import int8_kernels as ik

    rows = {}
    for t in rec.pack_timing.values():
        a = t["args"]
        x, skip = (widen(torch, a[k], WINDOW_BATCH) for k in ("x", "skip"))
        sx, pool = a["sx"], a["pool"]
        out = ik.quantize_pack_int8(x, sx, skip, pool)
        if not torch.equal(out, ik.quantize_pack_int8_ref(x, sx, skip,
                                                          pool)):
            fail(f"int8_path: {rec.PACK} at {t['sites'][0]} differs from "
                 f"its plain version at {WINDOW_BATCH} windows")
        in_bytes = sum(s.numel() * s.element_size()
                       for s in (x, skip) if s is not None)
        form = "cat" if skip is not None else "pool" if pool else "plain"
        row = {"name": t["sites"][0], "sites": t["sites"], "form": form,
               "dtype": str(x.dtype).replace("torch.", ""),
               "input": list(x.shape), "input_strides": list(x.stride()),
               "skip": None if skip is None else list(skip.shape),
               "output": list(out.shape), "windows": x.shape[0],
               "per_forward": len(t["sites"]), "max_abs_err": 0,
               "kernel_ms": graph_ms(torch, lambda: ik.quantize_pack_int8(
                   x, sx, skip, pool)),
               "kernel_eager_ms": time_ms(
                   torch, lambda: ik.quantize_pack_int8(x, sx, skip, pool),
                   reps=5, warmup=1),
               "plain_ms": time_ms(
                   torch, lambda: ik.quantize_pack_int8_ref(
                       x, sx, skip, pool), reps=3, warmup=1),
               **bound(in_bytes + out.numel() + 4, 0,
                       "source bytes (every pooled pixel) + N*H*W*Cpad + "
                       "4", "none (a few per byte)", INT8_TENSOR_OPS,
                       "int8 tensor cores")}
        rows[row["name"]] = row
        emit("int8_pack_timing", **row)
        del x, skip, out
    rec.pack_timing.clear()
    torch.cuda.empty_cache()
    return rows


def int8_pack_totals(rows: dict) -> dict:
    """The quantize launches of a forward, summed: device ms, plain ms,
    bound ms and bytes."""
    out = {key: sum(r[key] * r["per_forward"] for r in rows.values())
           for key in ("kernel_ms", "plain_ms", "bound_ms", "bytes")}
    out["launches"] = sum(r["per_forward"] for r in rows.values())
    out["windows"] = WINDOW_BATCH
    out["share_of_bound"] = out["bound_ms"] / out["kernel_ms"]
    return out


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
    kernels, 24 quantized inputs a scoring forward through the quantize
    kernel, and B1 twice a forward.  Then the same command again under
    :class:`Int8Recorder`: every kernel call of the first forward at each of
    the run's batch sizes (the calibration's, and each video length's
    windows) against its plain version, bitwise; then each distinct launch
    of the largest forward timed on its real inputs (the quantize's
    widened to 192 windows)."""
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
                "quantize_pack_int8": ik.quantize_pack_int8.launches,
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
    def convs(b):
        return {k: b["calls"][k] for k in rec.KERNELS}
    per_forward = convs(rec.batches[0]) if rec.batches else {}
    # the quantize kernel takes the calibrated inputs: none in a record pass
    if (sorted(b["windows"] for b in rec.batches) != want_windows
            or any(convs(b) != per_forward for b in rec.batches)
            or sum(per_forward.values()) != N_SITES
            or any(b["calls"][rec.PACK] != INT8_PACK_PER_FORWARD
                   * (not b["record_pass"]) for b in rec.batches)
            or rec.helper_calls != rec.kernel_calls):
        fail(f"int8_path: checked forwards {rec.batches} (want one at each "
             f"of {want_windows} windows, {N_SITES} conv calls each and "
             f"{INT8_PACK_PER_FORWARD} quantize calls each but the record "
             f"pass's), {rec.helper_calls} convs and {rec.kernel_calls} "
             "conv kernel calls")
    emit("int8_check", batches=rec.batches, seconds=check_s,
         plain_slice=PLAIN_SLICE)
    want = {**{name: c * forwards for name, c in per_forward.items()},
            rec.PACK: INT8_PACK_PER_FORWARD * main_run["forwards"],
            "b1": {r: 2 * forwards * (r == mk.TENSOR_CORE)
                   for r in mk.ROUTES}}
    if launches != want:
        fail(f"int8_path: launches {launches}, want {want} (the scoring "
             f"run's {main_run['forwards']} forwards and "
             f"{INT8_CALIB_CLIPS // 8} calibration passes)")
    pack_rows = int8_pack_timing_rows(torch, rec)
    pack_totals = int8_pack_totals(pack_rows)
    emit("int8_pack_totals", **pack_totals)
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
    return {"run": out, "checks": rows, "totals": totals,
            "pack_checks": pack_rows, "pack_totals": pack_totals}


# FlowNet 2.0's correlation kernel against its plain version: the products
# of two bf16 values are exact in float32, so the two float32 sums over C
# differ only in their order, each within C * 2^-24 of the sum of the
# products' magnitudes (the float32 summation bound), and the outputs then
# by one bf16 rounding, 2^-8 of the value (tests/test_torch_cuda.py)
CORR_ROUNDING = 2.0 ** -8
# FlowNet 2.0's extractor as the cell serves it: Ped2's first lengths,
# padded to 192 frames
FLOWNET2_VIDEOS, FLOWNET2_PAD = 4, 192


def correlation_check(f1, f2, out, leaky: bool) -> dict:
    """One correlation output against the plain version in float32 (before
    its rounding to bf16), within the bound of ``CORR_ROUNDING``."""
    from ammcnet_aaai2021_torch.ops import correlation as corr

    a, b = f1.float(), f2.float()
    want = corr.correlation_ref(a, b, leaky)
    magnitude = corr.correlation_ref(a.abs(), b.abs())
    allowed = (CORR_ROUNDING * want.abs()
               + f1.shape[1] * 2.0 ** -24 * magnitude + 1e-30)
    err = (out.float() - want).abs()
    return {"max_abs_err": float(err.max()),
            "share_of_rounding": float((err / allowed).max()),
            "bitwise_share": float(
                (out == corr.correlation_ref(f1, f2, leaky)).float().mean())}


class CorrelationRecorder:
    """Every correlation call of FlowNet 2.0's forwards, through the name
    ``models/flownet2.py`` calls (``ops/library.py``'s registered op over
    the kernel's wrapper): each output held against the plain version by
    :func:`correlation_check`, a failure naming the call; the first call's
    arguments at each batch size kept for timing."""

    def __init__(self):
        from ammcnet_aaai2021_torch.models import flownet2

        self.module = flownet2
        self.calls, self.kept = [], {}

    def __enter__(self):
        self.saved = self.module.correlation
        self.module.correlation = self._call
        return self

    def __exit__(self, *exc):
        self.module.correlation = self.saved

    def _call(self, f1, f2, leaky=False):
        out = self.saved(f1, f2, leaky)
        check = correlation_check(f1, f2, out, leaky)
        if check["share_of_rounding"] > 1:
            fail(f"correlation call {len(self.calls)} on "
                 f"{tuple(f1.shape)}: {check['max_abs_err']:.3g} off the "
                 f"plain version, {check['share_of_rounding']:.3g} of the "
                 f"summation bound")
        self.calls.append({"batch": f1.shape[0], **check})
        if f1.shape[0] not in self.kept:
            self.kept[f1.shape[0]] = (f1.clone(), f2.clone(), leaky)
        return out


def correlation_bound(b: int, c: int, h: int, w: int) -> dict:
    """The correlation's least time on (b, c, h, w) maps: both maps read
    and the (b, 441, h, w) bf16 output written once, against its products
    on the bf16 tensor cores (``benchmark/counts/flownet2.py``'s)."""
    return bound(2 * b * c * h * w * 2 + b * 441 * h * w * 2,
                 2 * 441 * c * h * w * b,
                 f"2 maps x {b}x{c}x{h}x{w} x 2 B + {b}x441x{h}x{w} x 2 B",
                 f"2 x 441 x {c} x {h} x {w} x {b}")


def flownet2_path_phase(torch) -> dict:
    """FlowNet 2.0 through the port's extractor on the card, every
    correlation call checked (:class:`CorrelationRecorder`), the launches
    counted from 0 at the wrapper, then the kernel timed on a forward's
    real inputs at each batch size."""
    from ammcnet_aaai2021_torch.eval.infer import make_otf_flow_extractor
    from ammcnet_aaai2021_torch.models import FlowNet2, init_flownet_weights
    from ammcnet_aaai2021_torch.ops import correlation as corr
    from benchmark.counts import flownet2 as flow_counts

    net = init_flownet_weights(FlowNet2(), torch.Generator().manual_seed(2))
    net = net.to("cuda").eval().requires_grad_(False)
    extract = make_otf_flow_extractor(net, pad_to=FLOWNET2_PAD, gray=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    lengths = PED2_TEST_LENGTHS[:FLOWNET2_VIDEOS]
    videos = [torch.randint(0, 256, (t, IMAGE_SIZE, IMAGE_SIZE, 1),
                            generator=g, device="cuda", dtype=torch.uint8)
              for t in lengths]
    pairs = FLOWNET2_PAD - 1
    chunk = net.pairs_per_forward
    ragged = pairs % chunk or chunk
    forwards = len(lengths) * math.ceil(pairs / chunk)
    corr.correlation.launches_by_route = dict.fromkeys(corr.ROUTES, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CorrelationRecorder() as rec:
        for video in videos:
            _, flows = extract(video)
            if (flows.shape != (pairs, IMAGE_SIZE, IMAGE_SIZE, 2)
                    or not torch.isfinite(flows).all()):
                fail(f"FlowNet 2.0 flows {tuple(flows.shape)}: want "
                     f"({pairs}, {IMAGE_SIZE}, {IMAGE_SIZE}, 2), finite")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = dict(corr.correlation.launches_by_route)
    if extract.forwards != forwards or routes != {"kernel": forwards,
                                                  "plain": 0}:
        fail(f"correlation launches {routes} over {extract.forwards} "
             f"FlowNet 2.0 forwards: want one kernel launch a forward, "
             f"{forwards}, and no plain call")
    if len(rec.calls) != forwards or set(rec.kept) != {chunk, ragged}:
        fail(f"{len(rec.calls)} correlation calls at batches "
             f"{sorted(rec.kept)}: want {forwards} at {chunk} and "
             f"{ragged}")
    timed = {}
    for b, (f1, f2, leaky) in sorted(rec.kept.items()):
        row = correlation_bound(*f1.shape)
        if not math.isclose(row["bound_ms"], 1e3 * flow_counts
                            .correlation_bound_s(b, IMAGE_SIZE), rel_tol=1e-9):
            fail(f"the correlation's bound at batch {b} differs from "
                 f"benchmark/counts/flownet2.py's")
        # cuDNN gives FlowNetC's conv3 maps channels-last, and the wrapper
        # makes them NCHW before the launch: op_ms holds those two copies,
        # kernel_ms (on NCHW copies of the same maps) the kernel alone
        a, c = f1.contiguous(), f2.contiguous()
        plain = [graph_ms(torch, lambda: corr.correlation_ref(f1, f2, leaky),
                          calls=2, replays=2) for _ in range(2)]
        kernel = [graph_ms(torch, lambda: corr.correlation(a, c, leaky))
                  for _ in range(2)]
        timed[b] = {**row, "kernel_ms": sum(kernel) / 2,
                    "plain_ms": sum(plain) / 2,
                    "timings_plain_plain_kernel_kernel_ms": plain + kernel,
                    "op_ms": graph_ms(
                        torch, lambda: corr.correlation(f1, f2, leaky)),
                    "input_strides": list(f1.stride()),
                    "kernel_eager_ms": time_ms(
                        torch, lambda: corr.correlation(a, c, leaky))}
        timed[b]["share_of_bound"] = timed[b]["bound_ms"] / timed[b][
            "kernel_ms"]
    out = {"videos": len(lengths), "pairs_a_video": pairs,
           "pairs_a_forward": chunk, "ragged": ragged, "forwards": forwards,
           "launches_by_route": routes, "wall_s": wall,
           "max_abs_err": max(c["max_abs_err"] for c in rec.calls),
           "max_share_of_rounding": max(c["share_of_rounding"]
                                        for c in rec.calls),
           "min_bitwise_share": min(c["bitwise_share"] for c in rec.calls),
           "timed": timed}
    emit("flownet2_path", **out)
    return out


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


def check_restore(torch, ckpt_dir: str, state, what: str) -> None:
    """Restore the latest step under ``ckpt_dir`` into a fresh state and
    fail unless it is ``state`` bit for bit: weights, buffers, both Adams'
    moments and counts, the step and the schedule."""
    from ammcnet_aaai2021_torch.configs import NetConfig, OptimConfig
    from ammcnet_aaai2021_torch.models import build_model
    from ammcnet_aaai2021_torch.train.checkpoint import (
        latest_step, restore_checkpoint)
    from ammcnet_aaai2021_torch.train.state import create_train_state

    if latest_step(ckpt_dir) != state.step:
        fail(f"{what}: no step-{state.step} checkpoint under {ckpt_dir}")
    model = build_model(NetConfig(), mode="training")
    fresh = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 1, device="cuda")
    restore_checkpoint(ckpt_dir, fresh, step=state.step)
    pairs = [(state.generator.state_dict(), fresh.generator.state_dict()),
             (state.discriminator.state_dict(),
              fresh.discriminator.state_dict())]
    for opt_a, opt_b in ((state.g_opt, fresh.g_opt),
                         (state.d_opt, fresh.d_opt)):
        sa, sb = opt_a.state_dict()["state"], opt_b.state_dict()["state"]
        pairs.append(({f"{i}.{n}": t for i, s in sa.items()
                       for n, t in s.items()},
                      {f"{i}.{n}": t for i, s in sb.items()
                       for n, t in s.items()}))
    for want, got in pairs:
        if set(want) != set(got) or not all(
                torch.equal(want[k], got[k]) for k in want):
            fail(f"{what} does not restore bit-exactly")
    if fresh.step != state.step or fresh.g_sched.last_epoch != state.step:
        fail(f"{what}: the step or schedule did not restore")


def train_path_phase(torch, mk, tmp: str) -> dict:
    """``run_train.main`` with the released defaults (bf16, batch 4,
    256x256) for ``TRAIN_STEPS`` steps, then ``--resume`` to
    ``RESUME_STEPS``, its tree and runs under ``tmp`` (the runs stay for
    watch_path: ``run_dirs`` in the result).  The kernels' counts are set
    to 0 just before and read just after."""
    from ammcnet_aaai2021_torch.runners import run_train

    os.makedirs(tmp)
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
    check_restore(torch, os.path.join(run1, "training", "checkpoints"),
                  state1, "the step-30 checkpoint")

    # the long-run loop flags: scalars fetched two periods at a time
    # (steps 10 and 20 in one copy), a checkpoint written on a writer
    # thread mid-run (step 20); then resumed from it to step 40 with
    # the same flags, its step-40 checkpoint also the writer thread's
    flagged = argv + ["--fetch_every_periods", "2", "--async_checkpoints",
                      "--step_save", "20"]
    time.sleep(1.0)
    torch.cuda.synchronize()
    reset_launches(mk)
    t0 = time.perf_counter()
    run3, state3 = run_train.main(flagged + ["--iterations",
                                             str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    time.sleep(1.0)
    run4, state4 = run_train.main(flagged + ["--iterations",
                                             str(RESUME_STEPS),
                                             "--resume", run3])
    torch.cuda.synchronize()
    flagged_counts = launch_counts(mk)
    steps_run = TRAIN_STEPS + RESUME_STEPS - 20
    for kernel, n in (("b2", 2 * steps_run), ("b1", 2 * steps_run // 10)):
        if flagged_counts[kernel] != {r: n * (r == mk.TENSOR_CORE)
                                      for r in mk.ROUTES}:
            fail(f"flagged training path: {kernel} launched "
                 f"{flagged_counts[kernel]}, want {n} on "
                 f"{mk.TENSOR_CORE!r}")
    flagged_scalars = [read_scalars(run3), read_scalars(run4)]
    for sc, steps in zip(flagged_scalars,
                         (range(10, TRAIN_STEPS + 1, 10),
                          range(30, RESUME_STEPS + 1, 10))):
        for tag in ("g_loss", "d_loss", "train_psnr", "steps_per_sec"):
            if sorted(sc.get(tag, {})) != list(steps):
                fail(f"flagged training path: {tag} rows at steps "
                     f"{sorted(sc.get(tag, {}))}, want {list(steps)}")
        for tag, vals in sc.items():
            if not all(math.isfinite(v) for v in vals.values()):
                fail(f"flagged training path: scalar {tag} not finite")
    flagged_rates = flagged_scalars[0]["steps_per_sec"]
    if flagged_rates[10] != flagged_rates[20]:
        fail("flagged training path: the periods of steps 10 and 20 "
             "were not fetched together (their rates differ)")
    saved = sorted(int(d) for d in os.listdir(
        os.path.join(run3, "training", "checkpoints")) if d.isdigit())
    if saved != [20]:
        fail(f"flagged training path: checkpoints at {saved}, want [20]")
    if state4.step != RESUME_STEPS:
        fail(f"the flagged run's resume ended at step {state4.step}")
    check_restore(torch, os.path.join(run4, "training", "checkpoints"),
                  state4, "the writer thread's step-40 checkpoint")

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
           "restored_bit_exact": True,
           # steps 10 and 20 share one rate (the span since the start, the
           # first step's set-up included); step 30's period holds the
           # writer thread's step-20 save
           "flagged": {"flags": "--fetch_every_periods 2 --async_checkpoints "
                                "--step_save 20",
                       "steps_per_s_by_period": flagged_rates,
                       "plain_steps_per_s_by_period": rates,
                       "first_run_wall_s": wall3,
                       "plain_first_run_wall_s": wall1,
                       "resumed_steps_per_s":
                           flagged_scalars[1]["steps_per_sec"],
                       "launches_by_route": flagged_counts,
                       "async_checkpoint_restored_bit_exact": True}}
    emit("train_path", **out)
    # the runs that saved steps 30 and 40 (the flagged run's resume)
    return {**out, "run_dirs": (run1, run4)}


# ---------------------------------------------------------------------------
# ckpt_path: the JAX package's checkpoint formats, written here by hand (the
# card's machine has no msgpack, flax or orbax)


def _mp_sized(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A msgpack header for a length ``n``: ``fix | n`` below ``fix_max``,
    else the first of ``codes`` (8-, 16-, 32-bit lengths) that holds it."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _mp_uint(n: int) -> bytes:
    if n < 128:
        return bytes([n])
    for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} too large")


def _mp_str(s: str) -> bytes:
    data = s.encode()
    return _mp_sized(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + data


def _mp_ndarray(arr) -> bytes:
    """flax's ext type 1: the msgpack triple (shape, dtype name, C bytes)."""
    data = arr.tobytes("C")
    payload = (_mp_sized(3, 0x90, 16, (None, 0xDC, 0xDD))
               + _mp_sized(arr.ndim, 0x90, 16, (None, 0xDC, 0xDD))
               + b"".join(_mp_uint(int(d)) for d in arr.shape)
               + _mp_str(arr.dtype.name)
               + _mp_sized(len(data), None, 0, (0xC4, 0xC5, 0xC6)) + data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(payload)
    head = (bytes([fixext[n]]) if n in fixext
            else _mp_sized(n, None, 0, (0xC7, 0xC8, 0xC9)))
    return head + struct.pack(">b", 1) + payload


def msgpack_bytes(tree) -> bytes:
    """What ``flax.serialization.to_bytes`` writes for a nested dict of
    numpy arrays under 1 GiB each (no chunked leaves): maps of str keys,
    arrays as flax's ndarray ext type."""
    import numpy as np

    if isinstance(tree, dict):
        return (_mp_sized(len(tree), 0x80, 16, (None, 0xDE, 0xDF))
                + b"".join(_mp_str(k) + msgpack_bytes(v)
                           for k, v in tree.items()))
    if isinstance(tree, np.ndarray) and tree.nbytes <= 1 << 30:
        return _mp_ndarray(tree)
    raise TypeError(f"msgpack_bytes: {type(tree).__name__} leaf")


def flax_variables(sd) -> dict:
    """The JAX two-stream generator's variables ``{'params',
    'batch_stats', 'codebook'}`` (numpy) holding a port state dict's
    weights: the inverse of ``tools/weights.state_dict_from_jax`` (kernels
    back with ``transpose(2, 3, 1, 0)``), as the JAX package's
    ``convert_twostream`` writes them."""
    import numpy as np

    def a(key):
        return np.ascontiguousarray(sd[key].detach().cpu().numpy())

    def kernel(key):
        return np.ascontiguousarray(a(key).transpose(2, 3, 1, 0))

    def conv(p):
        return {"kernel": kernel(f"{p}.weight"), "bias": a(f"{p}.bias")}

    def double_conv(p):
        params, stats = {}, {}
        for conv_name, bn, ci, bi in (("conv0", "bn0", 0, 1),
                                      ("conv1", "bn1", 3, 4)):
            params[conv_name] = {"kernel": kernel(f"{p}.conv.{ci}.weight")}
            params[bn] = {"scale": a(f"{p}.conv.{bi}.weight"),
                          "bias": a(f"{p}.conv.{bi}.bias")}
            stats[bn] = {"mean": a(f"{p}.conv.{bi}.running_mean"),
                         "var": a(f"{p}.conv.{bi}.running_var")}
        return params, stats

    def stream(s):
        params, stats = {}, {}
        params["inc"], stats["inc"] = double_conv(f"{s}.inc.conv")
        for d in ("down1", "down2", "down3"):
            p, st = double_conv(f"{s}.{d}.mpconv.1")
            params[d], stats[d] = {"conv": p}, {"conv": st}
        params["vq_down3"] = {"quan": {
            "enc": conv(f"{s}.vq_down3.quan.enc"),
            "dec": conv(f"{s}.vq_down3.quan.dec")}}
        codebook = {"vq_down3": {"quan": {"quantize": {
            leaf: a(f"{s}.vq_down3.quan.quantize.{leaf}")
            for leaf in ("embed", "cluster_size", "embed_avg")}}}}
        for u in ("up1", "up2", "up3"):
            p, st = double_conv(f"{s}.{u}.conv")
            params[u] = {"up": conv(f"{s}.{u}.up"), "conv": p}
            stats[u] = {"conv": st}
        params["outc"] = conv(f"{s}.outc")
        return params, stats, codebook

    out = {"params": {}, "batch_stats": {}, "codebook": {}}
    for s in ("rgb", "op"):
        (out["params"][s], out["batch_stats"][s],
         out["codebook"][s]) = stream(s)
    out["params"]["bridge"], out["batch_stats"]["bridge"] = {}, {}
    for flax_name, torch_name in (("O2F", "O2F"), ("F2O", "F20")):
        (out["params"]["bridge"][flax_name],
         out["batch_stats"]["bridge"][flax_name]) = double_conv(
            f"bridge.{torch_name}")
    return out


def _leaves(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + (k,))
    else:
        yield keys, tree


def write_orbax(step_dir: str, tree, ts=None) -> None:
    """An orbax ``StandardCheckpointer`` step directory of ``tree`` (nested
    dicts of numpy arrays): ``_METADATA``'s tree, and with tensorstore
    (``ts``) each leaf in an OCDBT zarr store, as orbax lays them out."""
    os.makedirs(step_dir)
    leaves = list(_leaves(tree))
    meta = {"tree_metadata": {str(keys): {
        "key_metadata": [{"key": k, "key_type": 2} for k in keys],
        "value_metadata": {"value_type": "jax.Array",
                           "skip_deserialize": False,
                           "write_shape": list(arr.shape)}}
        for keys, arr in leaves},
        "use_ocdbt": True, "use_zarr3": False}
    with open(os.path.join(step_dir, "_METADATA"), "w") as fh:
        json.dump(meta, fh)
    if ts is None:
        return
    context = ts.Context()
    base = f"file://{os.path.abspath(step_dir)}"
    for keys, arr in leaves:
        store = ts.open({"driver": "zarr", "path": ".".join(keys),
                         "kvstore": {"driver": "ocdbt", "base": base}},
                        create=True, dtype=arr.dtype.name, shape=arr.shape,
                        context=context).result()
        store.write(arr).result()


CKPT_LENGTHS = PED2_TEST_LENGTHS[:3]


def score_records(torch, mk, run_test, argv, forwards: int) -> dict:
    """``run_test.main(argv)`` with the counts set to 0 just before and read
    just after: its records, printed AUC line, B1's launches (2 a forward,
    all on the tensor-core route) and wall seconds."""
    stdout = io.StringIO()
    torch.cuda.synchronize()
    reset_launches(mk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        res = run_test.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_route = dict(mk.quantize_topk_fused.launches_by_route)
    if by_route != {r: 2 * forwards * (r == mk.TENSOR_CORE)
                    for r in mk.ROUTES}:
        fail(f"{argv[-1]}: B1 launched {by_route}, want {2 * forwards} all "
             f"on {mk.TENSOR_CORE!r}")
    with open(res["pickle"], "rb") as fh:
        records = pickle.load(fh)
    auc = [line for line in stdout.getvalue().splitlines()
           if line.startswith("the optimal auc")]
    if len(auc) != 1:
        fail(f"{argv[-1]}: run_test printed no 'the optimal auc =' line")
    return {"records": records, "auc_line": auc[0], "wall_s": wall,
            "launches_by_route": by_route}


def ckpt_path_phase(torch, mk) -> dict:
    """The released generator (``NetConfig()``: two-stream, bf16, full
    widths), seeded, written as the JAX package's flax ``.msgpack``
    (:func:`msgpack_bytes` of :func:`flax_variables`) and as a torch
    ``.pth``; ``run_test --ckptfile`` scores a 3-video ped2-shaped split at
    256x256 from each, and the records must be bitwise equal.  An orbax
    step dir of the same variables raises ``ImportError`` naming
    tensorstore and the converter where tensorstore is missing, and scores
    the same records where it is there."""
    import numpy as np

    from ammcnet_aaai2021_torch.configs import NetConfig
    from ammcnet_aaai2021_torch.models import build_model, init_weights
    from ammcnet_aaai2021_torch.runners import run_test
    from ammcnet_aaai2021_torch.tools.weights import load_generator_checkpoint

    sd = init_weights(build_model(NetConfig()).generator,
                      torch.Generator().manual_seed(14)).state_dict()
    variables = flax_variables(sd)
    forwards = sum(math.ceil((t - 4) / min(192, t - 4)) for t in CKPT_LENGTHS)
    with tempfile.TemporaryDirectory() as tmp:
        write_ped2_tree(tmp, CKPT_LENGTHS)
        os.rename(os.path.join(tmp, "ped2"), os.path.join(tmp, "toydata"))
        with open(os.path.join(tmp, "toydata", "toydata.json"), "w") as fh:
            json.dump({f"{vi:02d}": {"length": t, "gt": [[s - 1, e - 1]]}
                       for vi, (t, (s, e)) in enumerate(
                           zip(CKPT_LENGTHS, PED2_EVENTS), start=1)}, fh)
        paths = {"msgpack": os.path.join(tmp, "generator.msgpack"),
                 "pth": os.path.join(tmp, "generator.pth")}
        with open(paths["msgpack"], "wb") as fh:
            fh.write(msgpack_bytes(variables))
        torch.save(sd, paths["pth"])
        got = load_generator_checkpoint(paths["msgpack"])
        if set(got) != set(sd) or not all(torch.equal(got[k], sd[k])
                                          for k in sd):
            fail("the .msgpack does not load bitwise the generator's weights")
        try:
            import tensorstore as ts
        except ImportError:
            ts = None
        orbax_dir = os.path.join(tmp, "orbax", "000000")
        write_orbax(orbax_dir, variables, ts)
        if ts is None:
            try:
                load_generator_checkpoint(orbax_dir)
            except ImportError as exc:
                if ("tensorstore" not in str(exc)
                        or "tools.jax_checkpoint" not in str(exc)):
                    fail(f"the orbax dir raised without naming tensorstore "
                         f"and the converter: {exc}")
                orbax = f"ImportError: {exc}"
            else:
                fail("an orbax dir loaded without tensorstore")
        else:
            paths["orbax"] = orbax_dir
            orbax = "scored"
        size = os.path.getsize(paths["msgpack"])
        runs = {name: score_records(torch, mk, run_test, [
            "--dataset_name", "toydata", "--data_dir", tmp, "--save_dir",
            os.path.join(tmp, f"eval_{name}"), "--ckptfile", path], forwards)
            for name, path in paths.items()}
    want = runs["pth"]
    for name, run in runs.items():
        for key in ("rgb_img_pred_records", "rgb_fea_comm_records",
                    "op_img_pred_records", "op_fea_comm_records"):
            a, b = run["records"][key], want["records"][key]
            if len(a) != len(b) or not all(np.array_equal(x, y)
                                           for x, y in zip(a, b)):
                fail(f"ckpt_path: {name} records {key} differ from the "
                     ".pth run's")
        if run["auc_line"] != want["auc_line"]:
            fail(f"ckpt_path: {name} printed {run['auc_line']!r}")
    out = {"videos": len(CKPT_LENGTHS), "frames": sum(CKPT_LENGTHS),
           "image_size": IMAGE_SIZE, "dtype": "bfloat16",
           "msgpack_bytes": size,
           "records_bitwise": sorted(runs), "auc_line": want["auc_line"],
           "orbax": orbax,
           "wall_s": {name: run["wall_s"] for name, run in runs.items()},
           "quantize_topk_launches": sum(
               run["launches_by_route"][mk.TENSOR_CORE]
               for run in runs.values()),
           "quantize_topk_launches_by_run": {
               name: run["launches_by_route"] for name, run in runs.items()}}
    emit("ckpt_path", **out)
    return out


# ---------------------------------------------------------------------------
# export_path, watch_path, tools_path: the serving artifact, the
# watch-folder evaluator and the tools

# a chunk of 2 Ped2-length videos bucket-padded to 192 frames, one
# 192-window batch a video
EXPORT_VIDEOS, EXPORT_FRAMES, EXPORT_WINDOW_BATCH = 2, 192, 192
# the JAX export CLI's bound: the artifact against the live scorer
EXPORT_RTOL, EXPORT_ATOL = 1e-3, 1e-2
# int8 convolutions a forward of the released generator, and its
# statically quantized conv inputs (the quantize kernel's launches)
INT8_3X3_PER_FORWARD, INT8_2X2_PER_FORWARD = 34, 6
INT8_PACK_PER_FORWARD = 24


def load_artifact(path: str, device: str):
    """A serving artifact loaded through ``eval.export`` alone (no import
    of the port's ``models`` in this scope): ``(score_chunk, header,
    seconds)``."""
    from ammcnet_aaai2021_torch.eval.export import load_scorer

    t0 = time.perf_counter()
    score_chunk, header = load_scorer(path, device=device)
    return score_chunk, header, time.perf_counter() - t0


def split_chunk(torch, root: str, dataset: str, n_videos: int):
    """The first ``n_videos`` of a scoring split, each bucket-padded as
    ``score_dataset`` pads it, on the card: ``(rgbs, ops, lengths)``,
    frames uint8, flows bf16."""
    import numpy as np

    from ammcnet_aaai2021_torch.data.datasets import (VideoIndex,
                                                      _decode_rgb, load_flow)
    from ammcnet_aaai2021_torch.eval.infer import pad_video_to_bucket

    size = (IMAGE_SIZE, IMAGE_SIZE)
    frames = VideoIndex(os.path.join(root, dataset, "testing", "frames"))
    flows = VideoIndex(os.path.join(root, dataset, "testing", "flows"))
    rgbs, ops, lengths = [], [], []
    for name in frames.names[:n_videos]:
        rgb, op, t = pad_video_to_bucket(
            np.stack([_decode_rgb(p, size) for p in frames.videos[name]]),
            np.stack([load_flow(p, size) for p in flows.videos[name]]))
        rgbs.append(torch.from_numpy(rgb).cuda())
        ops.append(torch.from_numpy(op).cuda().to(torch.bfloat16))
        lengths.append(t)
    return tuple(rgbs), tuple(ops), lengths


def int8_counts() -> dict:
    from ammcnet_aaai2021_torch.ops import int8_kernels as ik

    return {"qconv3x3_int8": ik.qconv3x3_int8.launches,
            "qconv_transpose2x2_int8": ik.qconv_transpose2x2_int8.launches,
            "quantize_pack_int8": ik.quantize_pack_int8.launches}


def export_path_phase(torch, mk, tmp: str, main_run: dict) -> dict:
    """``runners.export_model --check`` on the released configuration
    (main_path's seeded weights; bf16, then ``--int8`` calibrated on 32
    clips of the training tree int8_path wrote), each artifact loaded here
    through ``eval.export`` alone and run on the split's first 2 videos:
    its output against the live ``ChunkScorer``'s within
    ``EXPORT_RTOL``/``EXPORT_ATOL``, B1 twice a forward inside it on its
    tensor-core route (and every int8 convolution of the int8 artifact on
    the int8 kernels), loading it for the CPU raises; the int8 artifact's
    records correlate with the bf16 one's; sizes, export and load seconds,
    and ms a chunk live and loaded (CUDA events)."""
    import numpy as np

    from ammcnet_aaai2021_torch.configs import preset
    from ammcnet_aaai2021_torch.eval.export import ChunkScorer
    from ammcnet_aaai2021_torch.models import build_model, init_weights
    from ammcnet_aaai2021_torch.models.quantized import (
        calibrated_int8_from_dataset)
    from ammcnet_aaai2021_torch.runners import export_model

    dataset = main_run["dataset"]
    rgbs, ops, lengths = split_chunk(torch, tmp, dataset, EXPORT_VIDEOS)
    if any(r.shape[0] != EXPORT_FRAMES for r in rgbs):
        fail(f"export_path: the chunk's videos pad to "
             f"{[r.shape[0] for r in rgbs]} frames, want {EXPORT_FRAMES}")
    forwards = EXPORT_VIDEOS * -(-(EXPORT_FRAMES - 4) // EXPORT_WINDOW_BATCH)
    cfg = preset(dataset, mode="testing", data_dir=tmp)
    gen = build_model(cfg.net, mode="testing", per_sample_diff=True).generator
    init_weights(gen, torch.Generator().manual_seed(cfg.seed))
    gen = gen.cuda().eval()
    calib = ["--calib_batches", str(INT8_CALIB_CLIPS // 8),
             "--calib_batch_size", "8"]
    out, outputs = {}, {}
    for name, extra in (("bf16", []), ("int8", ["--int8", *calib])):
        path = os.path.join(tmp, f"scorer_{name}.ammc")
        argv = ["--dataset_name", dataset, "--data_dir", tmp, "--out", path,
                "--n_videos", str(EXPORT_VIDEOS), "--frames",
                str(EXPORT_FRAMES), "--window_batch",
                str(EXPORT_WINDOW_BATCH), "--check", *extra]
        with contextlib.redirect_stdout(io.StringIO()):
            res = export_model.main(argv)
        score_chunk, header, load_s = load_artifact(path, "cuda")
        torch.cuda.synchronize()
        reset_launches(mk)
        with torch.no_grad():
            got = score_chunk(rgbs, ops)
        torch.cuda.synchronize()
        b1 = dict(mk.quantize_topk_fused.launches_by_route)
        convs = int8_counts()
        want_b1 = {r: 2 * forwards * (r == mk.TENSOR_CORE) for r in mk.ROUTES}
        per = name == "int8"
        want_convs = {"qconv3x3_int8": INT8_3X3_PER_FORWARD * forwards * per,
                      "qconv_transpose2x2_int8":
                          INT8_2X2_PER_FORWARD * forwards * per,
                      "quantize_pack_int8":
                          INT8_PACK_PER_FORWARD * forwards * per}
        if b1 != want_b1 or convs != want_convs:
            fail(f"export_path ({name}): the loaded artifact launched B1 "
                 f"{b1} and the int8 convolutions {convs}, want {want_b1} "
                 f"and {want_convs}")
        if name == "int8":
            model, _ = calibrated_int8_from_dataset(
                cfg.net, gen.state_dict(), tmp, dataset, IMAGE_SIZE,
                INT8_CALIB_CLIPS // 8, 8, device="cuda")
        else:
            model = gen
        live = ChunkScorer(model, window_batch=EXPORT_WINDOW_BATCH).eval()
        with torch.no_grad():
            want = live(rgbs, ops)
            diff = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=EXPORT_RTOL,
                                  atol=EXPORT_ATOL):
                fail(f"export_path ({name}): the loaded artifact and the "
                     f"live scorer differ by {diff} on the split's videos")
            if not torch.isfinite(got).all():
                fail(f"export_path ({name}): non-finite scores")
            loaded_ms = time_ms(torch, lambda: score_chunk(rgbs, ops),
                                reps=3, warmup=1)
            live_ms = time_ms(torch, lambda: live(rgbs, ops), reps=3,
                              warmup=1)
        try:
            load_artifact(path, "cpu")
        except ValueError as e:
            if "cannot serve on" not in str(e):
                fail(f"export_path: loading for the CPU raised {e!r}")
        else:
            fail("export_path: a CUDA artifact loaded for the CPU")
        outputs[name] = got.float().cpu().numpy()
        out[name] = {
            "bytes": res["bytes"], "export_s": res["export_s"],
            "check_load_s": res["load_s"], "load_s": load_s,
            "check_max_diff": res["check_max_diff"],
            "split_max_diff": diff, "rtol": EXPORT_RTOL, "atol": EXPORT_ATOL,
            "loaded_ms_per_chunk": loaded_ms, "live_ms_per_chunk": live_ms,
            "forwards_per_chunk": forwards, "b1_launches_by_route": b1,
            "int8_launches": convs, "header": header}
        del score_chunk, live, model, got, want
        torch.cuda.empty_cache()
    n_windows = [t - 4 for t in lengths]
    corr = {}
    for row, key in ((0, "rgb_psnr"), (1, "rgb_fea")):
        pick = [np.concatenate([outputs[name][v, row, :n]
                                for v, n in enumerate(n_windows)])
                for name in ("int8", "bf16")]
        corr[key] = float(np.corrcoef(*pick)[0, 1])
    if min(corr.values()) < INT8_MIN_CORR:
        fail(f"export_path: the int8 artifact's records correlate with the "
             f"bf16 one's by {corr}, want >= {INT8_MIN_CORR}")
    out.update(videos=EXPORT_VIDEOS, frames=EXPORT_FRAMES,
               window_batch=EXPORT_WINDOW_BATCH, true_lengths=lengths,
               int8_corr_with_bf16=corr)
    emit("export_path", **out)
    del gen
    torch.cuda.empty_cache()
    return out


WATCH_LENGTHS = PED2_TEST_LENGTHS[:3]


def watch_path_phase(torch, mk, tmp: str, train_run: dict) -> dict:
    """``runners.watch_eval --once --sweep`` on train_path's run dir with
    its step-30 and step-40 checkpoints (the flagged run's step 40 copied
    beside the first run's step 30), against main_path's split cut to its
    first 3 videos: two CSV rows, each AUC that of ``run_test`` on the
    same checkpoint and split, B1 twice a forward on its tensor-core
    route; a second pass scores nothing, and a pass with the other
    ``--sweep`` setting raises ``ValueError``."""
    import csv

    from ammcnet_aaai2021_torch.configs import FUSION_LAMBDAS
    from ammcnet_aaai2021_torch.eval.gt import GroundTruthLoader
    from ammcnet_aaai2021_torch.eval.scoring import img_pred_fea_comm_auc
    from ammcnet_aaai2021_torch.runners import run_test, watch_eval

    run30, run40 = train_run["run_dirs"]
    run_dir = os.path.join(tmp, "watch_run")
    shutil.copytree(run30, run_dir)
    ckpt_dir = os.path.join(run_dir, "training", "checkpoints")
    shutil.copytree(os.path.join(run40, "training", "checkpoints",
                                 f"{RESUME_STEPS:06d}"),
                    os.path.join(ckpt_dir, f"{RESUME_STEPS:06d}"))
    steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    if steps != [TRAIN_STEPS, RESUME_STEPS]:
        fail(f"watch_path: checkpoints at {steps}")
    data = os.path.join(tmp, "watch_data")
    dataset = write_scoring_tree(data, WATCH_LENGTHS)
    forwards = sum(math.ceil((t - 4) / min(192, t - 4))
                   for t in WATCH_LENGTHS)
    argv = ["--run_dir", run_dir, "--dataset_name", dataset, "--data_dir",
            data, "--once"]
    torch.cuda.synchronize()
    reset_launches(mk)
    t0 = time.perf_counter()
    best = watch_eval.main(argv + ["--sweep"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b1 = dict(mk.quantize_topk_fused.launches_by_route)
    want_b1 = {r: 2 * forwards * len(steps) * (r == mk.TENSOR_CORE)
               for r in mk.ROUTES}
    if b1 != want_b1:
        fail(f"watch_path: B1 launched {b1}, want {want_b1}")
    results = os.path.join(run_dir, "watch_results.csv")
    with open(results) as fh:
        rows = list(csv.DictReader(fh))
    if [int(r["step"]) for r in rows] != steps:
        fail(f"watch_path: CSV rows {rows}, want steps {steps}")
    run_test_auc = {}
    for row in rows:
        step_dir = os.path.join(ckpt_dir, f"{int(row['step']):06d}")
        res = score_records(torch, mk, run_test, [
            "--dataset_name", dataset, "--data_dir", data, "--save_dir",
            os.path.join(tmp, f"watch_test_{row['step']}"), "--ckptfile",
            step_dir], forwards)
        # run_test prints the AUC to 3 places, the CSV keeps 4: the AUC of
        # run_test's records, unrounded
        records = res["records"]
        auc = img_pred_fea_comm_auc(records, GroundTruthLoader(data)(
            dataset, video_lengths=[
                len(r) for r in records["rgb_img_pred_records"]]),
            FUSION_LAMBDAS[dataset])
        run_test_auc[row["step"]] = auc
        printed = float(res["auc_line"].split("=")[1])
        if round(auc, 4) != float(row["auc"]) or round(auc, 3) != printed:
            fail(f"watch_path: step {row['step']} AUC {row['auc']} in the "
                 f"CSV, run_test's records give {auc} ({printed} printed)")
    reset_launches(mk)
    again = watch_eval.main(argv + ["--sweep"])
    with open(results) as fh:
        rerun_rows = list(csv.DictReader(fh))
    if (again != (None, -1.0) or rerun_rows != rows
            or mk.quantize_topk_fused.launches):
        fail(f"watch_path: a second pass scored again ({again}, "
             f"{len(rerun_rows)} rows)")
    try:
        watch_eval.main(argv)
    except ValueError as e:
        other_sweep = str(e)
    else:
        fail("watch_path: a pass without --sweep appended to the --sweep "
             "CSV")
    out = {"steps": steps, "rows": rows, "best": list(best),
           "run_test_auc": run_test_auc, "videos": len(WATCH_LENGTHS),
           "forwards_per_checkpoint": forwards, "b1_launches_by_route": b1,
           "wall_s": wall, "other_sweep_raised": other_sweep}
    emit("watch_path", **out)
    return out


DEVICE_BENCH_PASSES = 3
DEVICE_BENCH_RUNS = (("bf16", []), ("int8_calibrated", ["--int8",
                                                        "--calibrated"]),
                     ("folded", ["--folded"]))
FOLDED_WINDOWS = 16
RECIPE_ITERS = 10


def folded_check(torch, mk) -> dict:
    """The folded forward against the unfolded generator at full width on
    a 16-window batch in float32 (TF32 off, cuDNN deterministic), the
    lookups' indices first (near-tie rule), then the outputs of the samples
    without a flip within ``MODEL_TOL``; each forward's B1 launches."""
    import dataclasses

    from ammcnet_aaai2021_torch.configs import NetConfig
    from ammcnet_aaai2021_torch.models import build_generator, init_weights
    from ammcnet_aaai2021_torch.models.folded import make_folded_forward

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    train_flags(torch)
    try:
        cfg = dataclasses.replace(NetConfig(), dtype="float32")
        gen = init_weights(build_generator(cfg, per_sample_diff=True),
                           torch.Generator().manual_seed(20200525))
        folded = make_folded_forward(
            gen.state_dict(), embed_dim=cfg.embed_dim, n_embed=cfg.n_embed,
            k=cfg.k, dtype=torch.float32, use_kernel=True,
            per_sample_diff=True).cuda()
        gen = gen.cuda().eval()
        g = torch.Generator(device="cuda").manual_seed(3)
        rgb = torch.rand(FOLDED_WINDOWS, 12, IMAGE_SIZE, IMAGE_SIZE,
                         device="cuda", generator=g) * 2 - 1
        op = torch.randn(FOLDED_WINDOWS, 6, IMAGE_SIZE, IMAGE_SIZE,
                         device="cuda", generator=g) * 0.01
        runs, launches = [], []
        for net in (folded, gen):
            reset_launches(mk)
            outs, lookups = generator_lookups(torch, net, rgb, op)
            torch.cuda.synchronize()
            launches.append(dict(mk.quantize_topk_fused.launches_by_route))
            runs.append((outs[:3], lookups))  # the codes: unfolded only
        for got in launches:
            if got[mk.CUDA_CORE] != 2:
                fail(f"folded check: B1 launched {got}, want 2 a forward on "
                     f"{mk.CUDA_CORE!r} (float32 latents)")
        res = compare_lookup_runs(torch, "folded forward", runs,
                                  FOLDED_WINDOWS)
        with torch.no_grad():
            res["folded_ms"] = time_ms(torch, lambda: folded(rgb, op),
                                       reps=3, warmup=1)
            res["unfolded_ms"] = time_ms(torch, lambda: gen(rgb, op),
                                         reps=3, warmup=1)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
    del gen, folded
    torch.cuda.empty_cache()
    res.update(windows=FOLDED_WINDOWS, dtype="float32",
               b1_launches_by_route=launches[0])
    return res


def tools_path_phase(torch, mk, tmp: str) -> dict:
    """The tools on the card: ``device_bench --passes 3`` (bf16, ``--int8
    --calibrated``, ``--folded``) with B1 twice a forward and the int8
    convolutions counted; the folded forward against the unfolded one
    (:func:`folded_check`); ``dtype_bench`` over the four levels;
    ``train_flops --measure`` at batch 4 (B2 twice a step); ``run_recipe``
    on an ``.npy`` toydata at 64x64, 10 iterations a stage (B2 once a
    stage-1 step and twice a stage-2 step, all on the tensor-core route),
    its AUC line printed."""
    from ammcnet_aaai2021_torch.tools import (device_bench, dtype_bench,
                                              run_recipe, train_flops)

    out = {"device_bench": {}}
    forwards = 6 * -(-(192 - 4) // 192)  # the default chunk a pass
    for name, extra in DEVICE_BENCH_RUNS:
        torch.cuda.synchronize()
        reset_launches(mk)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = device_bench.main(["--passes", str(DEVICE_BENCH_PASSES),
                                     *extra])
        wall = time.perf_counter() - t0
        b1 = dict(mk.quantize_topk_fused.launches_by_route)
        convs = int8_counts()
        # the warm pass and the timed ones; the calibration's record pass
        passes = DEVICE_BENCH_PASSES + 1
        calib = name == "int8_calibrated"
        want_b1 = 2 * (forwards * passes + calib)
        want_convs = {
            "qconv3x3_int8": INT8_3X3_PER_FORWARD * (forwards * passes + 1)
            * calib,
            "qconv_transpose2x2_int8": INT8_2X2_PER_FORWARD
            * (forwards * passes + 1) * calib,
            # none in the calibration's record pass
            "quantize_pack_int8": INT8_PACK_PER_FORWARD * forwards * passes
            * calib}
        if b1 != {r: want_b1 * (r == mk.TENSOR_CORE) for r in mk.ROUTES} \
                or convs != want_convs:
            fail(f"tools_path: device_bench {name} launched B1 {b1} and the "
                 f"int8 convolutions {convs}, want {want_b1} and "
                 f"{want_convs}")
        out["device_bench"][name] = {
            "frames_per_s": res["value"], "windows_per_s":
                res["windows_per_sec"], "pass_s": res["pass_s"],
            "card": res["card"], "config": res["config"],
            "b1_launches": want_b1, "int8_launches": convs, "wall_s": wall}
        print(f"device_bench {name}: {res['value']:.1f} frames/s on "
              f"{res['card']}", flush=True)
    out["folded_check"] = folded_check(torch, mk)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = dtype_bench.main([])
    out["dtype_bench"] = {"levels": res["levels"], "card": res["card"],
                          "batch": res["batch"],
                          "wall_s": time.perf_counter() - t0}

    torch.cuda.synchronize()
    reset_launches(mk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = train_flops.main(["--measure"])
    counts = launch_counts(mk)
    # the census step, the warm step and the chain of 30
    steps = 1 + 1 + 30
    if counts["b2"] != {r: 2 * steps * (r == mk.TENSOR_CORE)
                        for r in mk.ROUTES}:
        fail(f"tools_path: train_flops launched B2 {counts['b2']}, want "
             f"{2 * steps} on {mk.TENSOR_CORE!r}")
    out["train_flops"] = {**{k: res[k] for k in (
        "census", "step_ms", "tflops", "share_of_bf16_peak", "card",
        "batch", "size")}, "launches_by_route": counts,
        "wall_s": time.perf_counter() - t0}

    data = os.path.join(tmp, "recipe_data")
    stdout = io.StringIO()
    torch.cuda.synchronize()
    reset_launches(mk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        res = run_recipe.main([
            "--data_dir", data, "--save_dir", os.path.join(tmp, "recipe"),
            "--image_size", "64", "--stage1_iters", str(RECIPE_ITERS),
            "--stage2_iters", str(RECIPE_ITERS), "--skip_scratch_control",
            "--anomaly", "teleport", "--frame_format", "npy"])
    wall = time.perf_counter() - t0
    counts = launch_counts(mk)
    auc = [line for line in stdout.getvalue().splitlines()
           if line.startswith("the optimal auc")]
    if len(auc) != 1:
        fail("tools_path: run_recipe printed no 'the optimal auc =' line")
    print(auc[0], flush=True)
    want_b2 = 2 * RECIPE_ITERS + 2 * RECIPE_ITERS  # stage 1 x2, stage 2
    if (counts["b2"] != {r: want_b2 * (r == mk.TENSOR_CORE)
                         for r in mk.ROUTES}
            or counts["b1"][mk.CUDA_CORE] or not counts["b1"][mk.TENSOR_CORE]):
        fail(f"tools_path: run_recipe launched {counts}, want B2 {want_b2} "
             f"and B1 on {mk.TENSOR_CORE!r} only")
    out["run_recipe"] = {"auc_line": auc[0], "auc": res["auc_pretrained"],
                         "sweep": res["sweep_pretrained"],
                         "launches_by_route": counts, "wall_s": wall,
                         "iterations_a_stage": RECIPE_ITERS,
                         "image_size": 64}
    emit("tools_path", **out)
    return out


# remat_check: a remat step against the plain step, from one state and batch
REMAT_PARAM_TOL = 1e-6  # JAX tests/test_train_step.py's, after one Adam step
REMAT_TIMED_STEPS = 10


def remat_check_phase(torch, mk) -> dict:
    """One bf16 stage-2 step of the released configuration (full width,
    batch 4, 256x256) from one state and batch with ``remat=False`` and
    ``remat=True`` (TF32 off, cuDNN deterministic, as the caller sets):
    ``g_loss`` within ``TRAIN_LOSS_REL``, every generator parameter within
    ``REMAT_PARAM_TOL``, BatchNorm statistics and codebooks bitwise; B2 and
    B1 launches of each step by route; then ``REMAT_TIMED_STEPS`` more steps
    of each, timed by CUDA events, with the peak memory allocated; then the
    memory one training-mode generator forward of each leaves allocated
    for its backward."""
    import copy

    from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
    from ammcnet_aaai2021_torch.models import build_model, init_flownet_weights
    from ammcnet_aaai2021_torch.train.state import create_train_state
    from ammcnet_aaai2021_torch.train.steps import make_twostream_train_step

    g = torch.Generator(device="cuda").manual_seed(14)
    batch = {"rgb": torch.randint(0, 256, (4, 5, IMAGE_SIZE, IMAGE_SIZE, 3),
                                  device="cuda", generator=g,
                                  dtype=torch.uint8),
             "op": torch.randn(4, 4, IMAGE_SIZE, IMAGE_SIZE, 2, device="cuda",
                               generator=g) * 0.5}
    model = build_model(NetConfig(), mode="training")
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 20200525, device="cuda")
    flownet = init_flownet_weights(model.flow_network,
                                   torch.Generator().manual_seed(7))
    flownet.to("cuda").eval()
    init = copy.deepcopy({"g": state.generator.state_dict(),
                          "d": state.discriminator.state_dict(),
                          "g_opt": state.g_opt.state_dict(),
                          "d_opt": state.d_opt.state_dict(),
                          "g_sched": state.g_sched.state_dict(),
                          "d_sched": state.d_sched.state_dict()})
    runs = {}
    for remat in (False, True):
        state.generator.load_state_dict(init["g"])
        state.discriminator.load_state_dict(init["d"])
        for name in ("g_opt", "d_opt", "g_sched", "d_sched"):
            getattr(state, name).load_state_dict(copy.deepcopy(init[name]))
        state.step = 0
        step = make_twostream_train_step(LossConfig(), remat=remat)
        torch.cuda.synchronize()
        reset_launches(mk)
        metrics = step(state, batch, flownet)
        torch.cuda.synchronize()
        launches = launch_counts(mk)
        after = {k: v.clone() for k, v in state.generator.state_dict().items()}
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REMAT_TIMED_STEPS):
            step(state, batch, flownet)
        end.record()
        torch.cuda.synchronize()
        runs[remat] = {"g_loss": float(metrics["g_loss"]), "state": after,
                       "launches_by_route": launches,
                       "ms_per_step": start.elapsed_time(end)
                       / REMAT_TIMED_STEPS,
                       "peak_mem_gib": torch.cuda.max_memory_allocated()
                       / 2 ** 30,
                       # the peak over what was allocated before the steps
                       # (the state, and what earlier phases left)
                       "step_peak_gib": (torch.cuda.max_memory_allocated()
                                         - resident) / 2 ** 30}
    # what each step keeps between the generator's forward and its
    # backward: the memory a training-mode forward leaves allocated (its
    # buffer updates recorded, not written)
    import torch.utils.checkpoint

    from ammcnet_aaai2021_torch.models.blocks import (
        deferred_buffer_updates, recomputing)
    from ammcnet_aaai2021_torch.train.steps import _to_model_range

    rgb = _to_model_range(batch["rgb"])[:, :-3]
    op = _to_model_range(batch["op"])[:, :-2]
    for remat_on, run in runs.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        with deferred_buffer_updates():
            if remat_on:
                out = torch.utils.checkpoint.checkpoint(
                    state.generator, rgb, op, use_reentrant=False,
                    context_fn=lambda: (contextlib.nullcontext(), recomputing()))
            else:
                out = state.generator(rgb, op)
        torch.cuda.synchronize()
        run["held_after_forward_gib"] = (torch.cuda.memory_allocated()
                                         - base) / 2 ** 30
        del out
    plain, remat = runs[False], runs[True]
    loss_err = abs(remat["g_loss"] - plain["g_loss"]) / abs(plain["g_loss"])
    params = {n for n, _ in state.generator.named_parameters()}
    param_err = max(float((remat["state"][k].float()
                           - plain["state"][k].float()).abs().max())
                    for k in params)
    buffers_equal = all(torch.equal(remat["state"][k], plain["state"][k])
                        for k in plain["state"] if k not in params)
    if loss_err > TRAIN_LOSS_REL:
        fail(f"remat step: g_loss differs from the plain step's by "
             f"{loss_err:.3g} relative (> {TRAIN_LOSS_REL})")
    if param_err > REMAT_PARAM_TOL:
        fail(f"remat step: parameters differ from the plain step's by "
             f"{param_err:.3g} (> {REMAT_PARAM_TOL})")
    if not buffers_equal:
        fail("remat step: BatchNorm statistics or codebooks differ from the "
             "plain step's")
    want = {False: {"b1": 0, "b2": 2}, True: {"b1": 2, "b2": 2}}
    for r, run in runs.items():
        for kernel, n in want[r].items():
            if run["launches_by_route"][kernel] != {
                    route: n * (route == mk.TENSOR_CORE)
                    for route in mk.ROUTES}:
                fail(f"remat={r} step: {kernel} launched "
                     f"{run['launches_by_route'][kernel]}, want {n} on "
                     f"{mk.TENSOR_CORE!r}")
    out = {"batch": 4, "image_size": IMAGE_SIZE, "dtype": "bfloat16",
           "g_loss": plain["g_loss"], "g_loss_rel_err": loss_err,
           "g_loss_tol": TRAIN_LOSS_REL, "param_max_abs_err": param_err,
           "param_tol": REMAT_PARAM_TOL, "buffers_bitwise": buffers_equal,
           "timed_steps": REMAT_TIMED_STEPS,
           **{f"{name}_{key}": run[key] for name, run in
              (("plain", plain), ("remat", remat))
              for key in ("ms_per_step", "peak_mem_gib", "step_peak_gib",
                          "held_after_forward_gib", "launches_by_route")}}
    emit("remat_check", **out)
    return out


# the family path: the tags it builds with build_generator (the rest of
# its models are UNetMemV4 and the two ablation bridges), its batch, and
# the VQ-VAE nets' lookup sizes, timed: the top level's 8 * 32 * 32 rows
# and the bottom level's 8 * 64 * 64
FAMILY_TAGS = ("unet", "vqvae", "vqvae_topk", "vqvae_topk_res",
               "vqvae_twostream")
FAMILY_BATCH = 8
FAMILY_LOOKUP_ROWS = (FAMILY_BATCH * 32 * 32, FAMILY_BATCH * 64 * 64)
# tools.summarize's parameter total for each tag (64x64, NetConfig's
# widths), pinned against the JAX package by tests/test_torch_family.py
SUMMARIZE_TOTALS = {
    "unet": 7_707_011, "unet_vq_topk_res": 7_805_891,
    "unet_vq_twostream": 25_049_029, "twostream_concat_dire": 25_049_029,
    "vqvae": 1_398_083, "vqvae_topk": 1_414_595,
    "vqvae_topk_res": 1_435_203, "vqvae_twostream": 3_019_397,
}


def family_models(torch, dtype: str, use_kernel: bool):
    """``(name, seeded generator on the card, two_stream)`` for each model
    of the family path, at full width (NetConfig's: embed 64, n_embed 256,
    k 2), each built anew from the same seed."""
    import dataclasses

    from ammcnet_aaai2021_torch.configs import NetConfig
    from ammcnet_aaai2021_torch.models import (
        TwoStreamUNetMem, UNetMemV4, build_generator, init_weights)

    cfg = NetConfig(dtype=dtype, use_memory_kernel=use_kernel)
    dt = getattr(torch, dtype)
    nets = [(tag, lambda tag=tag: build_generator(
        dataclasses.replace(cfg, net_tag=tag))) for tag in FAMILY_TAGS]
    nets.append(("UNetMemV4", lambda: UNetMemV4(
        12, 3, cfg.embed_dim, cfg.n_embed, cfg.k, use_kernel, dtype=dt)))
    for kind in ("concat_dire", "add_dire"):
        nets.append((f"TwoStreamUNetMem[{kind}]", lambda kind=kind:
                     TwoStreamUNetMem(12, 6, 3, 2, cfg.embed_dim,
                                      cfg.n_embed, cfg.k, dt, use_kernel,
                                      bridge_kind=kind)))
    for name, build in nets:
        net = init_weights(build(), torch.Generator().manual_seed(20200525))
        yield name, net.to("cuda"), "TwoStream" in type(net).__name__


def family_loss(out):
    """``mean(prediction) + diff``: the mean of each image output that is
    a prediction (not a code) plus each commit distance."""
    preds, diffs = [], []
    for t in output_tensors(out):
        if t.ndim == 0:
            diffs.append(t)
        elif t.shape[1] <= 3:  # predictions have 2 or 3 channels, codes 64
            preds.append(t)
    return sum(t.float().mean() for t in preds) + sum(diffs)


def ema_bounds(torch, net, forward):
    """Run ``forward()`` (a train-mode forward of ``net``) with each
    memory's latents and codebook captured, and return its result and, for
    each memory's ``embed_avg`` and ``embed`` buffer, the most two float32
    EMA updates of it may differ by, elementwise: each side's ``embed_sum`` within
    ``ESUM_REL`` of the magnitude summed into the entry (the rows whose
    float64 top-1 is its codeword), times ``1 - decay``, plus two
    roundings of the result; ``embed`` that over the smoothed cluster
    size."""
    from ammcnet_aaai2021_torch.models import TopKMemory

    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append((mod, inp[0].detach(),
                                      mod.embed.clone())))
        for m in net.modules() if isinstance(m, TopKMemory)]
    try:
        result = forward()
    finally:
        for h in hooks:
            h.remove()
    names = {m: n for n, m in net.named_modules()}
    eps32 = torch.finfo(torch.float32).eps
    bounds = {}
    for mod, z, embed in seen:
        zf = z.permute(0, 2, 3, 1).reshape(-1, mod.embed_dim).double()
        e = embed.double()
        idx = (-2.0 * zf @ e + (e * e).sum(0)).argmin(1)
        mag = zf.abs().t() @ torch.nn.functional.one_hot(
            idx, mod.n_embed).double()
        cs = mod.cluster_size.double()
        n = cs.sum()
        smoothed = (cs + mod.eps) / (n + mod.n_embed * mod.eps) * n
        avg = ((1 - mod.decay) * 2 * ESUM_REL * mag
               + 2 * eps32 * mod.embed_avg.double().abs())
        bounds[f"{names[mod]}.embed_avg"] = avg
        bounds[f"{names[mod]}.embed"] = (
            avg / smoothed + 2 * eps32 * mod.embed.double().abs())
    return result, bounds


def family_path_phase(torch, mk) -> dict:
    """The model family at full width on a batch of 8 at 256x256 (TF32 off,
    cuDNN deterministic, as the caller sets): for each model,

    1. a bf16 eval forward through the kernels and through plain PyTorch
       (``use_memory_kernel=False``), held by :func:`compare_lookup_runs`,
       B1 launched once a memory, on the tensor-core route;
    2. a float32 train-mode forward and backward of ``mean(prediction) +
       diff`` through B2 (its CUDA-core route: float32 latents) and through
       plain PyTorch: the loss, every parameter's gradient and every buffer
       (the EMA codebooks, BatchNorm's statistics) within ``MODEL_TOL``;
    3. a bf16 train-mode forward and backward with every count set to 0
       just before and read just after: B2 once a memory, all on the
       tensor-core route, no B1;

    then ``tools.summarize.main(["--net_tag", tag])`` on the card for every
    tag, its total against ``SUMMARIZE_TOTALS``; then B1 and B2 at the
    VQ-VAE nets' two lookup sizes, bf16, k 1 and 2, against their plain
    versions and timed."""
    from ammcnet_aaai2021_torch.models import NET_TAGS, TopKMemory
    from ammcnet_aaai2021_torch.tools import summarize

    g = torch.Generator(device="cuda").manual_seed(15)
    b = FAMILY_BATCH
    rgb = torch.rand(b, 12, IMAGE_SIZE, IMAGE_SIZE, device="cuda",
                     generator=g) * 2 - 1
    op = torch.randn(b, 6, IMAGE_SIZE, IMAGE_SIZE, device="cuda",
                     generator=g) * 0.01
    t0 = time.perf_counter()
    out = {"models": {}, "launches_by_route": {}}

    # 1. bf16 eval, kernel against plain
    runs = {}
    for use_kernel in (True, False):
        for name, net, two in family_models(torch, "bfloat16", use_kernel):
            memories = sum(isinstance(m, TopKMemory) for m in net.modules())
            torch.cuda.synchronize()
            reset_launches(mk)
            res = generator_lookups(torch, net.eval(),
                                    *((rgb, op) if two else (rgb,)))
            torch.cuda.synchronize()
            counts = launch_counts(mk)
            want = {"b1": memories * use_kernel, "b2": 0}
            for kernel, n in want.items():
                if counts[kernel] != {r: n * (r == mk.TENSOR_CORE)
                                      for r in mk.ROUTES}:
                    fail(f"{name} bf16 eval (use_memory_kernel="
                         f"{use_kernel}): {kernel} launched "
                         f"{counts[kernel]}, want {n} on {mk.TENSOR_CORE!r}")
            runs.setdefault(name, []).append(res)
            out["models"].setdefault(name, {"memories": memories})
            if use_kernel:
                out["launches_by_route"][name] = {"eval": counts}
            del net
    for name, pair in runs.items():
        out["models"][name]["eval_bf16"] = compare_lookup_runs(
            torch, f"{name} bf16 eval", pair, b)
    del runs, pair
    torch.cuda.empty_cache()

    # 2. float32 train-mode forward and backward, B2 (CUDA-core) vs plain
    for (name, net_k, two), (_, net_p, _) in zip(
            family_models(torch, "float32", True),
            family_models(torch, "float32", False)):
        memories = out["models"][name]["memories"]
        got, bounds = [], {}
        for net in (net_k, net_p):
            def step():
                loss = family_loss(net.train()(
                    *((rgb, op) if two else (rgb,))))
                loss.backward()
                return float(loss.detach())
            torch.cuda.synchronize()
            reset_launches(mk)
            if net is net_k:
                loss, bounds = ema_bounds(torch, net, step)
            else:
                loss = step()
            torch.cuda.synchronize()
            counts = launch_counts(mk)
            n = memories * (net is net_k)
            if counts != {"b1": dict.fromkeys(mk.ROUTES, 0),
                          "b2": {r: n * (r == mk.CUDA_CORE)
                                 for r in mk.ROUTES}}:
                fail(f"{name} float32 train forward: launched {counts}, "
                     f"want B2 {n} times on {mk.CUDA_CORE!r}")
            got.append((loss, {k: p.grad for k, p in net.named_parameters()},
                        dict(net.named_buffers())))
        (loss_k, grad_k, buf_k), (loss_p, grad_p, buf_p) = got
        loss_err = abs(loss_k - loss_p)
        grad_err = max((float((grad_k[k] - grad_p[k]).abs().max())
                        for k in grad_p), default=0.0)
        buf_err, ema_ratio = 0.0, 0.0
        for k in buf_p:
            diff = (buf_k[k].double() - buf_p[k].double()).abs()
            if k in bounds:
                ema_ratio = max(ema_ratio, float(
                    (diff / bounds[k].clamp_min(1e-300)).max()))
            elif k.endswith("cluster_size") and not torch.equal(
                    buf_k[k], buf_p[k]):
                fail(f"{name} float32 train: {k} differs (the top-1 "
                     f"counts must be equal)")
            else:
                buf_err = max(buf_err, float(diff.max()))
        if max(loss_err, grad_err, buf_err) > MODEL_TOL or ema_ratio > 1:
            fail(f"{name} float32 train: kernel and plain differ: loss "
                 f"{loss_err:.3g}, gradients {grad_err:.3g}, buffers "
                 f"{buf_err:.3g} (> {MODEL_TOL}), codebooks "
                 f"{ema_ratio:.3g} of their bound")
        out["models"][name]["train_float32"] = {
            "loss": loss_k, "loss_abs_err": loss_err,
            "grad_max_abs_err": grad_err, "buffer_max_abs_err": buf_err,
            "tol": MODEL_TOL, "codebook_err_over_bound": ema_ratio,
            "b2_route": mk.CUDA_CORE}
        del net_k, net_p, got, grad_k, grad_p
        torch.cuda.empty_cache()

    # 3. bf16 train-mode forward and backward: the launch counts
    for name, net, two in family_models(torch, "bfloat16", True):
        memories = out["models"][name]["memories"]
        torch.cuda.synchronize()
        reset_launches(mk)
        loss = family_loss(net.train()(*((rgb, op) if two else (rgb,))))
        loss.backward()
        loss = float(loss.detach())
        torch.cuda.synchronize()
        counts = launch_counts(mk)
        if not math.isfinite(loss) or counts != {
                "b1": dict.fromkeys(mk.ROUTES, 0),
                "b2": {r: memories * (r == mk.TENSOR_CORE)
                       for r in mk.ROUTES}}:
            fail(f"{name} bf16 train forward: loss {loss}, launched "
                 f"{counts}, want B2 {memories} times on "
                 f"{mk.TENSOR_CORE!r} and no B1")
        out["launches_by_route"][name]["train"] = counts
        out["models"][name]["train_bf16_loss"] = loss
        del net, loss
        torch.cuda.empty_cache()

    # 4. tools.summarize on the card
    out["summarize"] = {}
    for tag in NET_TAGS:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            total = summarize.main(["--net_tag", tag])
        if total != SUMMARIZE_TOTALS[tag]:
            fail(f"tools.summarize --net_tag {tag}: total {total}, want "
                 f"{SUMMARIZE_TOTALS[tag]}")
        out["summarize"][tag] = total
    out["models_seconds"] = time.perf_counter() - t0

    # B1 and B2 at the VQ-VAE nets' lookup sizes
    dim, n_embed = 64, 256
    embed = torch.randn(dim, n_embed, device="cuda", generator=g)
    z = (torch.randn(max(FAMILY_LOOKUP_ROWS), dim, device="cuda",
                     generator=g) * 0.5).to(torch.bfloat16)
    tc = mk.TENSOR_CORE
    out["kernels"] = {}
    for n in FAMILY_LOOKUP_ROWS:
        flat = z[:n]
        for k in (1, 2):
            b1 = {**public(b1_check(torch, mk, flat, embed, k, tc)),
                  **time_pair(torch, mk.quantize_topk_fused,
                              mk.quantize_topk_fused_ref, flat, embed, k),
                  **lookup_bound(n, dim, n_embed, k, 2)}
            b2 = {**public(compare_train_lookup(torch, mk, flat, embed, k,
                                                tc)),
                  **time_pair(torch, train_on(mk, tc),
                              mk.quantize_topk_train_fused_ref, flat, embed,
                              k),
                  **train_lookup_bound(n, dim, n_embed, k, 2)}
            for kernel, row in (("quantize_topk_fused", b1),
                                ("quantize_topk_train_fused", b2)):
                out["kernels"][(kernel, n, k)] = row
                emit("family_kernel_check", kernel=kernel,
                     input=f"bfloat16 N={n} k={k}", **row)
    out["seconds"] = time.perf_counter() - t0
    emit("family_path", **{key: val for key, val in out.items()
                           if key != "kernels"})
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


# the data-parallel phases: the released configuration at 256x256 on a
# global batch of DP_BATCH; dp_path's two ranks take DP_STEPS steps in each
# dtype, dp_check's step is timed over DP_TIMED_STEPS more each way
DP_BATCH, DP_STEPS, DP_TIMED_STEPS = 4, 3, 5
# The step under a process group against the plain step (one rank), and
# two ranks against one process on the global batch, differ only in
# BatchNorm's training statistics: two-pass float32 sums over the group's
# batch (on two ranks, the halves' sums added) against ATen's kernel, a few
# float32 ulps of each statistic.  After one float32 step from the same
# state that leaves the CPU tests' one-step bounds
# (tests/test_torch_train.py): losses 1e-5 relative; gradients 2e-2 per
# tensor and 5e-3 over the generator relative to their norms (BatchNorm's
# backward loses digits level by level); BatchNorm statistics and codebooks
# 1e-5 of their scale (a running mean's is its standard deviation, a
# codeword's its RMS) plus 1e-5, cluster sizes equal.  Adam's update is
# about lr * sign(g), and rounding decides the sign of a near-zero
# gradient, so a parameter is held to Adam's own bound, 2 * lr.  The
# rounding moves each memory's latents too, so a row two of whose k + 1
# nearest codewords lie within the near-tie rule (NEAR_TIE_REL, as the
# kernel checks) may take either, and ``dp_compare`` says what a flipped
# row leaves bounded.  In bf16 every BatchNorm output rounds to bf16 either way, and
# those ulps flip some elements by one bf16 ulp (2^-8): losses and
# statistics 2e-2 (five bf16 ulps); codebooks 4e-2 (the latents pass ten
# BatchNorm layers on the way to a memory, each flipping its ulps anew);
# near-ties within 2^-7 (a latent an ulp off moves its distances to two
# codewords by up to 2^-8 each, in opposite directions).  dp_path holds
# each of its steps against one process's step from the same state, so
# every step takes the one-step bounds.
DP_STEP1 = {"loss_rel": 1e-5, "stat_rel": 1e-5, "stat_abs": 1e-5,
            "codebook_rel": 1e-5, "codebook_abs": 1e-5,
            "near_tie": NEAR_TIE_REL}
DP_BF16 = {"loss_rel": 2e-2, "stat_rel": 2e-2, "stat_abs": 1e-5,
           "codebook_rel": 4e-2, "codebook_abs": 1e-5, "near_tie": 2 ** -7}
# beyond Adam's 2 * lr: the float32 rounding of the two updated values
# (parameters of order 1)
DP_PARAM_ROUNDING = 1e-6
DP_GRAD_REL_TENSOR, DP_GRAD_REL_ALL = 2e-2, 5e-3
# mh_score: Ped2's first test lengths, scored by two ranks and by one
MH_LENGTHS = PED2_TEST_LENGTHS[:4]
WORKER_TIMEOUT_S = 600
# the card every rank of these phases runs on (two ranks share it)
DP_DEVICE = "cuda"


def train_flags(torch) -> None:
    """The float32 comparisons' settings: TF32 off, cuDNN deterministic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def dp_setup(torch, dtype: str, group=None):
    """The released configuration in ``dtype``, seeded state on the card
    (generator, discriminator, optimizers) under ``group``, and the seeded
    FlowNet2-SD teacher."""
    import dataclasses

    from ammcnet_aaai2021_torch.configs import NetConfig, OptimConfig
    from ammcnet_aaai2021_torch.models import build_model, init_flownet_weights
    from ammcnet_aaai2021_torch.train.state import create_train_state

    model = build_model(dataclasses.replace(NetConfig(), dtype=dtype),
                        mode="training", group=group)
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 20200525, device=DP_DEVICE)
    flownet = init_flownet_weights(model.flow_network,
                                   torch.Generator().manual_seed(7))
    return state, flownet.to(DP_DEVICE).eval()


def dp_batch(torch) -> dict:
    """The global batch, seeded, on the host."""
    g = torch.Generator().manual_seed(16)
    return {"rgb": torch.randint(0, 256, (DP_BATCH, 5, IMAGE_SIZE, IMAGE_SIZE,
                                          3), generator=g, dtype=torch.uint8),
            "op": torch.randn(DP_BATCH, 4, IMAGE_SIZE, IMAGE_SIZE, 2,
                              generator=g) * 0.5}


TRAIN_STATE_PARTS = ("g_opt", "d_opt", "g_sched", "d_sched")


def host_copy(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def host_rows(latents: dict) -> dict:
    return {name: host_copy(rows) for name, rows in latents.items()}


def step_record(state, metrics: dict, latents: dict) -> dict:
    """One step's metrics, G's gradients and state, and each memory's
    rows of the step's forward (``dp_run``), on the host."""
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g_grads": host_copy({n: p.grad for n, p in
                                  state.generator.named_parameters()}),
            "state": host_copy(state.generator.state_dict()),
            "latents": host_rows(latents)}


def train_state_dict(state) -> dict:
    """Everything a step reads: both models, optimizers and schedulers."""
    import copy

    return copy.deepcopy({
        "step": state.step, "g": state.generator.state_dict(),
        "d": state.discriminator.state_dict(),
        **{name: getattr(state, name).state_dict()
           for name in TRAIN_STATE_PARTS}})


def load_train_state(state, saved: dict) -> None:
    import copy

    state.generator.load_state_dict(saved["g"])
    state.discriminator.load_state_dict(saved["d"])
    for name in TRAIN_STATE_PARTS:
        getattr(state, name).load_state_dict(copy.deepcopy(saved[name]))
    state.step = saved["step"]


def dp_run(torch, mk, state, step, batch, flownet, steps: int,
           record=None) -> dict:
    """``steps`` steps with every count set to 0 just before and read just
    after: each step's metrics, the launches by route and the all-reduces,
    and ms a step over the steps after the first (CUDA events);
    ``record(i, state, metrics, latents)`` after each step, ``latents``
    each memory's input rows (``z``) and gathered codewords (``q``, its
    ``q_topk``) of the step's forward, by module name."""
    from ammcnet_aaai2021_torch.models import TopKMemory
    from ammcnet_aaai2021_torch.parallel import all_reduce_sum

    latents, hooks = {}, []
    if record is not None:
        def rows(x):  # NCHW -> one row a position
            return x.detach().permute(0, 2, 3, 1).reshape(-1, x.shape[1])

        def keep(name):
            def hook(module, args, out):
                latents[name] = {"z": rows(args[0]), "q": rows(out[0])}
            return hook
        hooks = [m.register_forward_hook(keep(name))
                 for name, m in state.generator.named_modules()
                 if isinstance(m, TopKMemory)]
    torch.cuda.synchronize()
    reset_launches(mk)
    calls = all_reduce_sum.calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics = []
    try:
        for i in range(steps):
            if i == 1:
                start.record()
            m = step(state, batch, flownet)
            metrics.append({k: float(v) for k, v in m.items()})
            if record is not None:
                record(i, state, m, latents)
    finally:
        for h in hooks:
            h.remove()
    end.record()
    torch.cuda.synchronize()
    return {"metrics": metrics, "launches_by_route": launch_counts(mk),
            "all_reduces": all_reduce_sum.calls - calls,
            "ms_per_step": (start.elapsed_time(end) / (steps - 1)
                            if steps > 1 else None)}


def one_step(torch, mk, state, step, batch, flownet) -> tuple:
    """One step's ``dp_run`` result and its ``step_record``."""
    rec = []
    run = dp_run(torch, mk, state, step, batch, flownet, 1,
                 record=lambda i, st, m, z: rec.append(step_record(st, m, z)))
    return run, rec[0]


def loss_rel_err(got: dict, want: dict) -> float:
    """The largest relative difference of one step's metrics."""
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
               for k in want)


def codebooks(generator_state: dict) -> dict:
    """Each memory's codebook (on the host) in a generator state dict, by
    the memory's module name."""
    return {k[:-len(".embed")]: v.detach().cpu()
            for k, v in generator_state.items() if k.endswith(".embed")}


def lookup_flips(torch, what: str, got: dict, want: dict, embeds: dict,
                 rel: float) -> dict:
    """Each memory's rows whose gathered codewords (``q_topk``) differ
    between the runs.  Each must be a near-tie: two of its k + 1 nearest
    codewords (float64 distances to the codebook the step read, in either
    run) within ``rel`` relative of each other, so that the rounding of the
    step's sums could reorder them.  Returns, by memory, the rows, the
    flipped rows and the codewords they touch (the k + 1 nearest in both
    runs)."""
    out = {}
    for name, w in want.items():
        g = got[name]
        k = w["q"].shape[1] // w["z"].shape[1]
        flipped = (g["q"] != w["q"]).any(dim=1)
        e = embeds[name].double()
        e_sq = e.square().sum(0, keepdim=True)
        near, touched = torch.zeros_like(flipped), []
        for rows in (g, w):
            z = rows["z"][flipped].double()
            top = (z.square().sum(1, keepdim=True) - 2 * z @ e + e_sq).topk(
                k + 1, dim=1, largest=False)
            gaps = top.values.diff(dim=1) / top.values[:, :-1].abs().clamp_min(
                1e-30)
            near[flipped] |= (gaps < rel).any(dim=1)
            touched.append(top.indices.ravel())
        if not bool(near[flipped].all()):
            fail(f"{what}: {name}'s codewords differ between the runs at a "
                 f"row that is no near-tie (within {rel} relative)")
        out[name] = {"rows": len(flipped), "flipped": int(flipped.sum()),
                     "codewords": torch.cat(touched).unique()}
    return out


def is_encoder_layer(key: str) -> bool:
    """A BatchNorm buffer of a stream's encoder (inc, down1..down3), which
    runs before that stream's memory."""
    return ".inc." in key or ".down" in key


def dp_compare(torch, what: str, got: dict, want: dict, tol: dict,
               embeds: dict, grads: bool) -> dict:
    """One step's ``step_record`` against another's from the same state,
    within ``tol`` (and the gradients' bounds with ``grads``); ``embeds``
    the codebooks the step read.  Fails where a bound is broken; returns
    the largest errors.

    A latent within ``tol["near_tie"]`` of the boundary between two
    codewords may take either (the rounding of the step's sums moves it),
    and a row that flips carries another codeword into the decoder and back
    through the whole backward pass.  So the codewords a flipped row
    touches leave the codebook comparison; the bounds of the losses and of
    the BatchNorm statistics after the memories grow by the flipped rows'
    share of the rows (four times that share for the statistics: a row's
    positions and their 3x3 neighbours at each level), since each moves
    its own share by about its scale; and with any flipped row the
    gradients are reported, not bounded.  The encoders' statistics, the
    other codewords and the parameters keep their bounds."""
    from ammcnet_aaai2021_torch.configs import OptimConfig

    sd_got, sd_want = got["state"], want["state"]
    params = set(want["g_grads"])
    flips = lookup_flips(torch, what, got["latents"], want["latents"],
                         embeds, tol["near_tie"])
    by_prefix = {name + ".": f for name, f in flips.items()}
    n_flipped = sum(f["flipped"] for f in flips.values())
    share = n_flipped / sum(f["rows"] for f in flips.values())
    loss_rel = loss_rel_err(got["metrics"], want["metrics"])
    param_bound = 2 * OptimConfig().lr_g + DP_PARAM_ROUNDING
    param_err = 0.0
    errs = {kind: [0.0, 0.0, True] for kind in
            ("encoder_stat", "stat", "codebook")}
    for key, w in sd_want.items():
        g = sd_got[key]
        if key in params:
            param_err = max(param_err, float((g - w).abs().max()))
            continue
        if key.endswith("num_batches_tracked"):
            if not torch.equal(g, w):
                fail(f"{what}: {key} differs")
            continue
        # |got - want| <= rel * scale + abs: a running mean's scale is its
        # standard deviation, a running variance's itself, a codeword's
        # (a column of embed and embed_avg) its RMS, a cluster size exact
        if key.endswith(("running_mean", "running_var")):
            encoder = is_encoder_layer(key)
            kind = "encoder_stat" if encoder else "stat"
            scale = (sd_want[key[:-4] + "var"].sqrt()
                     if key.endswith("running_mean") else w.abs())
            rel = tol["stat_rel"] + (0.0 if encoder else 4 * share)
            absolute = tol["stat_abs"]
        else:
            keep = torch.ones(w.shape[-1], dtype=torch.bool)
            keep[by_prefix[key[:key.rindex(".") + 1]]["codewords"]] = False
            g, w = g[..., keep], w[..., keep]
            kind = "codebook"
            if key.endswith("cluster_size"):
                scale, rel, absolute = w.abs(), 0.0, 0.0
            else:
                scale = w.square().mean(0, keepdim=True).sqrt()
                rel, absolute = tol["codebook_rel"], tol["codebook_abs"]
        d = (g - w).abs()
        err = errs[kind]
        err[0] = max(err[0], float(d.max()))
        err[1] = max(err[1], float((d / scale.clamp_min(1e-30)).max()))
        err[2] &= bool((d <= rel * scale + absolute).all())
    bounded = n_flipped == 0
    out = {"loss_max_rel_err": loss_rel,
           "loss_bound": tol["loss_rel"] + share,
           "param_max_abs_err": param_err, "param_bound": param_bound,
           "lookup_rows": {n: f["rows"] for n, f in flips.items()},
           "flipped_rows": {n: f["flipped"] for n, f in flips.items()},
           "codewords_left_out": {n: int(f["codewords"].numel())
                                  for n, f in flips.items()},
           **{f"{kind}_max_abs_err": e[0] for kind, e in errs.items()},
           **{f"{kind}_max_err_of_scale": e[1] for kind, e in errs.items()},
           "decoder_stat_bound": tol["stat_rel"] + 4 * share,
           "gradients_bounded": bounded, "tol": tol}
    if grads:
        g_got, g_want = got["g_grads"], want["g_grads"]
        rel = {n: float((g_got[n] - g_want[n]).norm()
                        / max(float(g_want[n].norm()), 1e-30)) for n in g_want}
        flat = [torch.cat([g[n].ravel() for n in g_want])
                for g in (g_got, g_want)]
        out["grad_max_rel_err_tensor"] = max(rel.values())
        out["grad_rel_err_all"] = float((flat[0] - flat[1]).norm()
                                        / flat[1].norm())
        if bounded and (out["grad_max_rel_err_tensor"] > DP_GRAD_REL_TENSOR
                        or out["grad_rel_err_all"] > DP_GRAD_REL_ALL):
            fail(f"{what}: gradients differ by {out['grad_max_rel_err_tensor']:.3g}"
                 f" per tensor, {out['grad_rel_err_all']:.3g} over the "
                 f"generator (> {DP_GRAD_REL_TENSOR}, {DP_GRAD_REL_ALL})")
    if loss_rel > out["loss_bound"]:
        fail(f"{what}: losses differ by {loss_rel:.3g} relative "
             f"(> {out['loss_bound']:.3g})")
    if param_err > param_bound:
        fail(f"{what}: parameters differ by {param_err:.3g} (> Adam's "
             f"{param_bound:.3g})")
    for kind in ("encoder_stat", "stat", "codebook"):
        if not errs[kind][2]:
            fail(f"{what}: {kind} differs by {errs[kind][0]:.3g}, "
                 f"{errs[kind][1]:.3g} of its scale (> the bound of {tol})")
    return out


def dp_check_phase(torch, mk, tmp: str) -> dict:
    """World size 1 (NCCL, a ``file://`` init): one bf16 and one float32
    stage-2 step of the released configuration (256x256, batch
    ``DP_BATCH``) with and without the group, from one state and batch,
    TF32 off and cuDNN deterministic: losses, parameters, BatchNorm
    statistics and codebooks (and in float32 the gradients) within the
    bounds above; B2 twice a step on its route (tensor-core in bf16,
    general in float32); the all-reduces a step; then
    ``DP_TIMED_STEPS`` more steps each way, ms a step by CUDA events."""
    import torch.distributed as dist

    from ammcnet_aaai2021_torch.configs import LossConfig
    from ammcnet_aaai2021_torch.models import BatchNorm2d, set_process_group
    from ammcnet_aaai2021_torch.train.steps import make_twostream_train_step

    started = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/dp_check_pg",
                            world_size=1, rank=0)
    try:
        batch = {k: v.to(DP_DEVICE) for k, v in dp_batch(torch).items()}
        out = {}
        for dtype, route in (("bfloat16", mk.TENSOR_CORE),
                             ("float32", mk.CUDA_CORE)):
            state, flownet = dp_setup(torch, dtype)
            n_bn = sum(isinstance(m, BatchNorm2d)
                       for m in state.generator.modules())
            init = train_state_dict(state)
            runs = {}
            for grouped in (False, True):
                group = dist.group.WORLD if grouped else None
                load_train_state(state, init)
                set_process_group(state.generator, group)
                step = make_twostream_train_step(LossConfig(), group=group)
                run, rec = one_step(torch, mk, state, step, batch, flownet)
                timed = dp_run(torch, mk, state, step, batch, flownet,
                               DP_TIMED_STEPS + 1)
                runs[grouped] = {**run, "record": rec,
                                 "ms_per_step": timed["ms_per_step"]}
                want = {"b1": 0, "b2": 2}
                for kernel, n in want.items():
                    if run["launches_by_route"][kernel] != {
                            r: n * (r == route) for r in mk.ROUTES}:
                        fail(f"dp_check {dtype} (group={grouped}): {kernel} "
                             f"launched {run['launches_by_route']}, want "
                             f"{n} a step on {route!r}")
            plain, grouped = runs[False], runs[True]
            # a BatchNorm's two all-reduces forward and two backward, one
            # a memory's EMA, one each of G's and D's gradients, one for the
            # metrics
            want_calls = 4 * n_bn + 2 + 2 + 1
            if plain["all_reduces"] != 0 or grouped["all_reduces"] != want_calls:
                fail(f"dp_check {dtype}: {grouped['all_reduces']} all-reduces "
                     f"a step under the group (want {want_calls}), "
                     f"{plain['all_reduces']} without")
            res = dp_compare(torch, f"dp_check {dtype}", grouped["record"],
                             plain["record"],
                             DP_STEP1 if dtype == "float32" else DP_BF16,
                             codebooks(init["g"]), grads=dtype == "float32")
            out[dtype] = {
                "b2_route": route, **res,
                "launches_by_route": grouped["launches_by_route"],
                "plain_ms_per_step": plain["ms_per_step"],
                "group_ms_per_step": grouped["ms_per_step"],
                "all_reduces_per_step": grouped["all_reduces"],
                "batchnorm_layers": n_bn,
                "g_loss": plain["record"]["metrics"]["g_loss"]}
            del state, flownet
    finally:
        dist.destroy_process_group()
    emit("dp_check", world_size=1, backend="nccl", batch=DP_BATCH,
         image_size=IMAGE_SIZE, timed_steps=DP_TIMED_STEPS,
         seconds=time.perf_counter() - started, **out)
    return out


def spawn_workers(role: str, workdir: str, world: int = 2):
    """``world`` ranks of this script (``--worker role``), each on the one
    card."""
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", role,
         "--rank", str(rank), "--world", str(world), "--workdir", workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for rank in range(world)]


def reap_workers(procs, what: str) -> list:
    """Each worker's output, every worker ended by its PID whatever
    happens; fails if one did not exit 0."""
    outs = []
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(text[-6000:], file=sys.stderr, flush=True)
            fail(f"{what}: rank {rank} exited {p.returncode}")
    return outs


def worker_group(torch, rank: int, world: int, workdir: str):
    """Join the workers' gloo group (CUDA tensors ride through the host:
    NCCL refuses two ranks on one card)."""
    import datetime

    from ammcnet_aaai2021_torch.parallel import initialize

    initialize(backend="gloo", init_method=f"file://{workdir}/pg",
               world_size=world, rank=rank,
               timeout=datetime.timedelta(seconds=WORKER_TIMEOUT_S))


def dp_worker(torch, mk, rank: int, world: int, workdir: str) -> None:
    """One rank of ``dp_path``: its shard of the global batch, the step
    under the gloo group, ``DP_STEPS`` float32 steps then ``DP_STEPS``
    bf16 steps from the same seeded state.  Rank 0 writes the float32
    run's train state before its first step (``before.pt``) and after each
    step with the step's record (``after_<i>_0.pt``), rank 1 its latents
    of each step (``after_<i>_1.pt``); each rank writes its runs and its
    last generator state (``out_<rank>.pt``)."""
    import torch.distributed as dist

    from ammcnet_aaai2021_torch.configs import LossConfig
    from ammcnet_aaai2021_torch.parallel import (make_global_batch, replicate,
                                                 shard_batch)
    from ammcnet_aaai2021_torch.train.steps import make_twostream_train_step

    def snapshot(i, state, metrics, latents):
        path = os.path.join(workdir, f"after_{i}_{rank}.pt")
        if rank != 0:  # its memories' rows; rank 0 writes the rest
            torch.save({"latents": host_rows(latents)}, path)
            return
        torch.save({**step_record(state, metrics, latents),
                    "train_state": train_state_dict(state)}, path)

    train_flags(torch)
    worker_group(torch, rank, world, workdir)
    try:
        group = dist.group.WORLD
        batch = make_global_batch(shard_batch(dp_batch(torch), rank, world),
                                  DP_DEVICE, group)
        out = {}
        for dtype in ("float32", "bfloat16"):
            state, flownet = dp_setup(torch, dtype, group)
            replicate(state.generator, group)
            replicate(state.discriminator, group)
            step = make_twostream_train_step(LossConfig(), group=group)
            keep = dtype == "float32"
            if keep and rank == 0:
                torch.save(train_state_dict(state),
                           os.path.join(workdir, "before.pt"))
            out[dtype] = dp_run(torch, mk, state, step, batch, flownet,
                                DP_STEPS, record=snapshot if keep else None)
            if dtype == "float32":
                out["float32_state"] = host_copy(state.generator.state_dict())
            del state, flownet
        torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_path_phase(torch, mk, tmp: str) -> dict:
    """Two ranks on the one card (gloo, CUDA tensors), ``DP_BATCH //
    2`` samples each of the global batch: ``DP_STEPS`` float32 steps, each
    held against one process's step on the global batch from the same
    state (rank 0's state before that step): losses, gradients,
    parameters, BatchNorm statistics and codebooks within the one-step
    bounds above; the ranks' metrics and states bitwise equal; then
    ``DP_STEPS`` bf16 steps; each rank's B2 launches (twice a step, on the
    route of each dtype), all-reduces and ms a step."""
    from ammcnet_aaai2021_torch.configs import LossConfig
    from ammcnet_aaai2021_torch.train.steps import make_twostream_train_step

    workdir = os.path.join(tmp, "dp_path")
    os.makedirs(workdir)
    torch.cuda.empty_cache()  # the card's memory to the two ranks
    started = time.perf_counter()
    reap_workers(spawn_workers("dp", workdir), "dp_path")
    wall = time.perf_counter() - started
    ranks = [torch.load(os.path.join(workdir, f"out_{r}.pt"),
                        weights_only=False) for r in range(2)]
    for key, val in ranks[0]["float32_state"].items():
        if not torch.equal(ranks[1]["float32_state"][key], val):
            fail(f"dp_path: the ranks' {key} differ")
    if ranks[0]["float32"]["metrics"] != ranks[1]["float32"]["metrics"]:
        fail("dp_path: the ranks report different metrics")
    state, flownet = dp_setup(torch, "float32")
    step = make_twostream_train_step(LossConfig())
    batch = {k: v.to(DP_DEVICE) for k, v in dp_batch(torch).items()}
    before = torch.load(os.path.join(workdir, "before.pt"),
                        weights_only=False)
    per_step = []
    for i in range(DP_STEPS):
        load_train_state(state, before)
        _, want = one_step(torch, mk, state, step, batch, flownet)
        got, other = (torch.load(os.path.join(workdir, f"after_{i}_{r}.pt"),
                                 weights_only=False) for r in range(2))
        # the global batch's rows: rank 0's samples, then rank 1's
        got["latents"] = {name: {k: torch.cat([v, other["latents"][name][k]])
                                 for k, v in rows.items()}
                          for name, rows in got["latents"].items()}
        embeds = codebooks(before["g"])
        before = got.pop("train_state")
        per_step.append(dp_compare(torch, f"dp_path step {i + 1}", got, want,
                                   DP_STEP1, embeds, grads=True))
    del state, flownet, batch, before
    routes = {"float32": mk.CUDA_CORE, "bfloat16": mk.TENSOR_CORE}
    for rank, out in enumerate(ranks):
        for dtype, route in routes.items():
            n = 2 * DP_STEPS
            if out[dtype]["launches_by_route"]["b2"] != {
                    r: n * (r == route) for r in mk.ROUTES}:
                fail(f"dp_path rank {rank} {dtype}: B2 launched "
                     f"{out[dtype]['launches_by_route']['b2']}, want {n} on "
                     f"{route!r}")
    res = {"ranks": 2, "backend": "gloo (CUDA tensors)",
           "batch_per_rank": DP_BATCH // 2, "global_batch": DP_BATCH,
           "image_size": IMAGE_SIZE, "steps": DP_STEPS, "wall_s": wall,
           "float32_by_step": per_step,
           "b2_launches_by_rank": {
               dtype: [out[dtype]["launches_by_route"]["b2"]
                       for out in ranks] for dtype in routes},
           "all_reduces_by_rank": {
               dtype: [out[dtype]["all_reduces"] for out in ranks]
               for dtype in routes},
           "ms_per_step_by_rank": {
               dtype: [out[dtype]["ms_per_step"] for out in ranks]
               for dtype in routes},
           "g_loss_by_step": {dtype: [m["g_loss"] for m in
                                      ranks[0][dtype]["metrics"]]
                              for dtype in routes},
           "seconds": time.perf_counter() - started}
    emit("dp_path", **res)
    return res


def write_scoring_tree(root: str, lengths) -> str:
    """``write_ped2_tree``'s split of these lengths; a cut split carries its
    videos' ped2 events in the toydata label format, since the builtin ped2
    labels need all 12 videos.  Returns the dataset name ``run_test``
    takes."""
    write_ped2_tree(root, lengths)
    if len(lengths) == len(PED2_TEST_LENGTHS):
        return "ped2"
    os.rename(os.path.join(root, "ped2"), os.path.join(root, "toydata"))
    with open(os.path.join(root, "toydata", "toydata.json"), "w") as fh:
        json.dump({f"{vi:02d}": {"length": t, "gt": [[s - 1, e - 1]]}
                   for vi, (t, (s, e)) in enumerate(
                       zip(lengths, PED2_EVENTS), start=1)}, fh)
    return "toydata"


def score_worker(torch, mk, rank: int, world: int, workdir: str) -> None:
    """One rank of ``mh_score``: ``run_test.main`` on the split under
    ``workdir`` with every count set to 0 just before; prints its B1
    launches and result as the JSON line ``MH_RESULT``."""
    import torch.distributed as dist

    from ammcnet_aaai2021_torch.runners import run_test

    train_flags(torch)  # as the single-process run's
    worker_group(torch, rank, world, workdir)
    try:
        with open(os.path.join(workdir, "argv.json")) as fh:
            argv = json.load(fh)
        reset_launches(mk)
        res = run_test.main(argv)
        torch.cuda.synchronize()
        print("MH_RESULT " + json.dumps({
            "rank": rank, "return": res,
            "b1_launches_by_route": dict(
                mk.quantize_topk_fused.launches_by_route)}, default=float),
            flush=True)
    finally:
        dist.destroy_process_group()


def mh_score_phase(torch, mk, tmp: str) -> dict:
    """``run_test`` on ``main_path``'s split cut to ``MH_LENGTHS`` (the same
    seeded frames, flows and weights) by two ranks on the one card (gloo)
    and by this process: rank 0's merged records bitwise the single run's,
    the same "the optimal auc =" line, rank 1 returning ``{"fps",
    "rank"}``, B1 twice a forward of each rank's videos on its tensor-core
    route, and the run's shard directory gone."""
    import numpy as np

    from ammcnet_aaai2021_torch.runners import run_test

    started = time.perf_counter()
    workdir = os.path.join(tmp, "mh_score")
    os.makedirs(workdir)
    dataset = write_scoring_tree(workdir, MH_LENGTHS)
    base = ["--dataset_name", dataset, "--data_dir", workdir,
            "--device", DP_DEVICE]
    multi_dir = os.path.join(workdir, "eval_multi")
    with open(os.path.join(workdir, "argv.json"), "w") as fh:
        json.dump(base + ["--save_dir", multi_dir], fh)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = spawn_workers("score", workdir)
    outs = reap_workers(procs, "mh_score")
    wall = time.perf_counter() - t0
    results = [json.loads(next(line for line in out.splitlines()
                               if line.startswith("MH_RESULT "))[10:])
               for out in outs]
    stdout = io.StringIO()
    reset_launches(mk)
    with contextlib.redirect_stdout(stdout):
        single = run_test.main(base + ["--save_dir",
                                       os.path.join(workdir, "eval_single")])
    torch.cuda.synchronize()
    single_b1 = dict(mk.quantize_topk_fused.launches_by_route)

    def auc_line(text):
        return next((line for line in text.splitlines()
                     if "the optimal auc = " in line), None)

    if auc_line(outs[0]) is None or auc_line(outs[0]) != auc_line(
            stdout.getvalue()):
        fail(f"mh_score: rank 0 printed {auc_line(outs[0])!r}, one process "
             f"{auc_line(stdout.getvalue())!r}")
    if set(results[1]["return"]) != {"fps", "rank"} or results[1][
            "return"]["rank"] != 1:
        fail(f"mh_score: rank 1 returned {results[1]['return']}")
    with open(single["pickle"], "rb") as fh:
        want = pickle.load(fh)
    with open(results[0]["return"]["pickle"], "rb") as fh:
        got = pickle.load(fh)
    keys = ("rgb_img_pred_records", "rgb_fea_comm_records",
            "op_img_pred_records", "op_fea_comm_records")
    if set(got) != set(want) or got["dataset"] != want["dataset"]:
        fail(f"mh_score: merged keys {sorted(got)}, want {sorted(want)}")
    for key in keys:
        if len(got[key]) != len(MH_LENGTHS) or not all(
                g.dtype == w.dtype and np.array_equal(g, w)
                for g, w in zip(got[key], want[key])):
            fail(f"mh_score: rank 0's merged {key} is not bitwise the single "
                 "process's")
    leftovers = os.listdir(os.path.join(multi_dir, "record_shards"))
    if leftovers:
        fail(f"mh_score: shard directories left behind: {leftovers}")
    # round robin: rank r scores videos r, r + 2; one forward a video
    # (window_batch 192 covers every Ped2 length)
    want_b1 = [2 * len(MH_LENGTHS[r::2]) for r in range(2)]
    for r, res in enumerate(results):
        if res["b1_launches_by_route"] != {
                route: want_b1[r] * (route == mk.TENSOR_CORE)
                for route in mk.ROUTES}:
            fail(f"mh_score rank {r}: B1 launched "
                 f"{res['b1_launches_by_route']}, want {want_b1[r]} on "
                 f"{mk.TENSOR_CORE!r}")
    if single_b1[mk.TENSOR_CORE] != sum(want_b1):
        fail(f"mh_score: one process launched B1 {single_b1}")
    out = {"ranks": 2, "backend": "gloo", "videos": len(MH_LENGTHS),
           "frames": sum(MH_LENGTHS), "records_bitwise": True,
           "auc_line": auc_line(outs[0]), "auc": single["auc"],
           "two_rank_wall_s": wall,
           "fps_by_rank": [results[0]["return"]["fps"],
                           results[1]["return"]["fps"]],
           "single_fps": single["fps"],
           "b1_launches_by_rank": [res["b1_launches_by_route"]
                                   for res in results],
           "single_b1_launches": single_b1,
           "seconds": time.perf_counter() - started}
    emit("mh_score", **out)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--videos", type=int, default=len(PED2_TEST_LENGTHS),
                        help="ped2-shaped videos in the main path (cut only "
                             "to fit a time limit)")
    # one rank of dp_path or mh_score, started by those phases
    parser.add_argument("--worker", choices=["dp", "score"],
                        help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--workdir", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    started = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs the card")
    sys.path.insert(0, REPO)
    from ammcnet_aaai2021_torch.ops import cuda_build
    from ammcnet_aaai2021_torch.ops import memory_kernels as mk

    if args.worker:
        worker = {"dp": dp_worker, "score": score_worker}[args.worker]
        worker(torch, mk, args.rank, args.world, args.workdir)
        return

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
    # kernels); the int8 convolutions; FlowNet 2.0's correlation
    seconds = cuda_build.build(["quantize_topk", "quantize_topk_mma",
                                "jpeg_decode", "int8_conv", "correlation"])
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
        ckpt = ckpt_path_phase(torch, mk)
        t0 = time.perf_counter()
        export = export_path_phase(torch, mk, tmp, main_run)
        new_phases_s = {"export_path": time.perf_counter() - t0}
        t0 = time.perf_counter()
        flownet2 = flownet2_path_phase(torch)
        new_phases_s["flownet2_path"] = time.perf_counter() - t0

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        train_check_phase(torch, mk)
        remat = remat_check_phase(torch, mk)
        family = family_path_phase(torch, mk)
        with tempfile.TemporaryDirectory() as dp_tmp:
            dp_check = dp_check_phase(torch, mk, dp_tmp)
            dp_path = dp_path_phase(torch, mk, dp_tmp)
            mh_score = mh_score_phase(torch, mk, dp_tmp)
        torch.backends.cudnn.deterministic = deterministic
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        train_run = train_path_phase(torch, mk, os.path.join(tmp, "train"))
        t0 = time.perf_counter()
        watch = watch_path_phase(torch, mk, tmp, train_run)
        new_phases_s["watch_path"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tools = tools_path_phase(torch, mk, tmp)
        new_phases_s["tools_path"] = time.perf_counter() - t0
    emit("new_phases", seconds=new_phases_s,
         total_s=sum(new_phases_s.values()))
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
    corr_full = flownet2["timed"][flownet2["pairs_a_forward"]]
    corr_ragged = flownet2["timed"][flownet2["ragged"]]

    def family_launches(run, kernel):
        """The family path's launches of one kernel on its tensor-core
        route, by model."""
        return {name: counts[run][kernel][mk.TENSOR_CORE]
                for name, counts in family["launches_by_route"].items()}

    def family_rows(kernel):
        """One wrapper's timed rows at the family's lookup sizes."""
        return {f"at_n_{n}_k_{k}": {key: row[key] for key in (
            "kernel_ms", "kernel_eager_ms", "plain_ms", "bound_ms",
            "bound_by", "flips", "max_abs_err")}
            for (name, n, k), row in family["kernels"].items()
            if name == kernel}

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
                             "ckpt": ckpt["quantize_topk_launches_by_run"],
                             "train": train_run["quantize_topk_launches"],
                             "train_flagged": train_run["flagged"][
                                 "launches_by_route"]["b1"],
                             "remat_step": remat["remat_launches_by_route"][
                                 "b1"],
                             **stage1_launches("b1"),
                             "family_eval": family_launches("eval", "b1"),
                             "mh_score_by_rank": [
                                 r[mk.TENSOR_CORE] for r in
                                 mh_score["b1_launches_by_rank"]],
                             "mh_score_single": mh_score[
                                 "single_b1_launches"][mk.TENSOR_CORE],
                             "export_loaded_bf16": export["bf16"][
                                 "b1_launches_by_route"][mk.TENSOR_CORE],
                             "export_loaded_int8": export["int8"][
                                 "b1_launches_by_route"][mk.TENSOR_CORE],
                             "watch": watch["b1_launches_by_route"][
                                 mk.TENSOR_CORE],
                             "device_bench": {
                                 name: run["b1_launches"] for name, run in
                                 tools["device_bench"].items()},
                             "folded_check_cuda_core": tools[
                                 "folded_check"]["b1_launches_by_route"][
                                 mk.CUDA_CORE],
                             "run_recipe": tools["run_recipe"][
                                 "launches_by_route"]["b1"][mk.TENSOR_CORE]},
        "max_abs_err": max(v["max_abs_err"] for v in (
            *checks.values(), *family_rows("quantize_topk_fused").values())),
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
        "family_lookups": family_rows("quantize_topk_fused"),
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
                             "train_flagged": train_run["flagged"][
                                 "launches_by_route"]["b2"],
                             "remat_step": remat["remat_launches_by_route"][
                                 "b2"],
                             "plain_step": remat["plain_launches_by_route"][
                                 "b2"],
                             **stage1_launches("b2"),
                             "family_train": family_launches("train", "b2"),
                             "dp_check_group_step": {
                                 dtype: dp_check[dtype]["launches_by_route"][
                                     "b2"] for dtype in dp_check},
                             "dp_path_by_rank": dp_path[
                                 "b2_launches_by_rank"],
                             "train_flops": tools["train_flops"][
                                 "launches_by_route"]["b2"][mk.TENSOR_CORE],
                             "run_recipe": tools["run_recipe"][
                                 "launches_by_route"]["b2"][mk.TENSOR_CORE]},
        "max_abs_err": max(b2["max_abs_err"], b2_f32["max_abs_err"], *(
            row["max_abs_err"] for row in family_rows(
                "quantize_topk_train_fused").values())),
        "esum_max_rel_err": max(b2["esum_max_rel_err"],
                                b2_f32["esum_max_rel_err"]),
        "flips": b2["flips"],
        "flips_vs_b1": b2["flips_vs_b1"],
        "ms": b2["kernel_ms"],
        **{key: b2[key] for key in b2_keys},
        "previous_source": "ammcnet_aaai2021_torch/csrc/quantize_topk.cu",
        "library_ms": None,
        "at_n_196608": {key: b2_big[key] for key in b2_keys},
        "family_lookups": family_rows("quantize_topk_train_fused"),
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
        "launches_by_path": {
            "int8_path": int8["run"]["launches"]["qconv3x3_int8"],
            "export_loaded_int8": export["int8"]["int8_launches"][
                "qconv3x3_int8"],
            "device_bench_int8_calibrated": tools["device_bench"][
                "int8_calibrated"]["int8_launches"][
                "qconv3x3_int8"]},
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
        "launches_by_path": {
            "int8_path": int8["run"]["launches"]["qconv_transpose2x2_int8"],
            "export_loaded_int8": export["int8"]["int8_launches"][
                "qconv_transpose2x2_int8"],
            "device_bench_int8_calibrated": tools["device_bench"][
                "int8_calibrated"]["int8_launches"][
                "qconv_transpose2x2_int8"]},
        "max_abs_err": 0,
        "ms": conv2["kernel_ms"],
        **{key: conv2[key] for key in (
            "kernel_eager_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_call", "cudnn_bf16_ms")},
        "at": int8_at(conv2),
        "per_forward": int8["totals"]["2x2"],
        "by_shape": int8_by_shape("2x2"),
    }, {
        "name": "quantize_pack_int8",
        "route": "cuda",
        "source": "ammcnet_aaai2021_torch/csrc/int8_conv.cu",
        "replaces": "ammcnet_aaai2021_tpu/models/quantized.py:144 (XLA's "
                    "fused static quantize) and the up levels' cat and the "
                    "down levels' max-pool before it",
        "launches": int8["run"]["launches"]["quantize_pack_int8"],
        "launches_by_path": {
            "int8_path": int8["run"]["launches"]["quantize_pack_int8"],
            "export_loaded_int8": export["int8"]["int8_launches"][
                "quantize_pack_int8"],
            "device_bench_int8_calibrated": tools["device_bench"][
                "int8_calibrated"]["int8_launches"]["quantize_pack_int8"]},
        "max_abs_err": 0,
        "ms": int8["pack_totals"]["kernel_ms"],
        "at": f"the {int8['pack_totals']['launches']} launches of a "
              f"{int8['pack_totals']['windows']}-window forward, summed",
        "per_forward": int8["pack_totals"],
        "by_shape": int8["pack_checks"],
    }, {
        "name": "correlation",
        "route": "cuda",
        "source": "ammcnet_aaai2021_torch/csrc/correlation.cu",
        "replaces": "flownet2-pytorch's correlation_package (FlowNetC); "
                    "the JAX package has no FlowNet 2.0",
        "launches": flownet2["launches_by_route"]["kernel"],
        "launches_by_route": flownet2["launches_by_route"],
        "launches_by_path": {"flownet2_path": flownet2[
            "launches_by_route"]["kernel"]},
        "max_abs_err": flownet2["max_abs_err"],
        "max_share_of_rounding": flownet2["max_share_of_rounding"],
        "min_bitwise_share": flownet2["min_bitwise_share"],
        "ms": corr_full["kernel_ms"],
        "at": f"({flownet2['pairs_a_forward']}, 256, 32, 32) bf16: one "
              f"FlowNet 2.0 forward's conv3 maps at 256x256",
        **{key: corr_full[key] for key in (
            "kernel_ms", "kernel_eager_ms", "op_ms", "input_strides",
            "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "at_ragged": {key: corr_ragged[key] for key in (
            "kernel_ms", "op_ms", "plain_ms", "bound_ms", "bound_by")},
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
