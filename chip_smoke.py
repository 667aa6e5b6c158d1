#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``ammcnet_aaai2021_torch``).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py            # the whole check, 12 ped2-shaped videos
    python3 chip_smoke.py --videos 2 # a shorter scoring path

Phases, one JSON line each; any failure exits non-zero:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles every CUDA kernel of the paths from ``csrc/`` (nvcc);
3. kernel check: each kernel (B1, the inference memory lookup, on its
   tensor-core route for bf16 latents and its CUDA-core route for float32,
   and B2, the training lookup with the EMA statistics) against its plain
   PyTorch version on the card at the paths' shapes, plus edge cases, with
   the device time of each (CUDA graphs timed by CUDA events), the kernel's
   back-to-back eager time (host work included), the card's bound for the
   same work, and for B1's bf16 cases the CUDA-core kernel's device time
   on the same input;
4. model check: the released generator on a small 256x256 batch, its
   memory lookups in the kernel and in plain PyTorch, in float32 and bf16:
   the lookups' indices first, then the outputs of the samples whose
   indices all agree;
5. scoring path: ``runners.run_test.main`` scores a ped2-shaped test split
   (12 videos, 2,010 frames of 256x256) with the released configuration,
   bf16 and seeded random weights; checks the records, the AUC line and that
   every kernel of the path was launched (two memory lookups per forward,
   all on B1's tensor-core route);
6. train check: one float32 training step of the released generator at
   256x256, batch 4, through the kernels and through plain PyTorch;
7. training path: ``runners.run_train.main`` trains the released
   configuration (bf16, batch 4, 256x256) for 30 steps on a numpy training
   tree, then resumes from its step-30 checkpoint to step 40; checks the
   scalars, the codebook, the checkpoint and the kernels' launches (B2 twice
   per step, B1 twice per train-PSNR forward);
8. the ``kernels`` summary line, then the last line
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
# HBM3 bandwidth, and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12

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
          flops_formula: str) -> dict:
    """The least time the card could take: compulsory bytes over HBM
    bandwidth vs the operations over the bf16 tensor-core peak."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    return {
        "bytes": bytes_moved, "flops": flops,
        "arithmetic": (
            f"bytes = {bytes_formula} = {bytes_moved:,}; / 3.35e12 B/s = "
            f"{bytes_ms:.5f} ms. flops = {flops_formula} = {flops:,}; / "
            f"989e12 FLOP/s (bf16 tensor cores) = {flops_ms:.5f} ms"),
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


def compare_train_lookup(torch, mk, flat, embed, k: int) -> dict:
    """B2 against its plain version: its own q_topk, q1 and idx under the
    near-tie rule; counts equal to the histogram of the kernel's own top-1
    indices (and to the plain version's counts where no top-1 index
    flipped); embed_sum within ``ESUM_REL`` of the plain sum over the
    kernel's own indices; a second call bitwise equal; the lookup equal to
    B1's on the same input under the near-tie rule (B1 takes its own route:
    the tensor-core kernel for bf16 latents)."""
    res = compare_lookup(torch, mk.quantize_topk_train_fused,
                         mk.quantize_topk_train_fused_ref, flat, embed, k)
    q, q1, idx, counts, esum = res["out"]
    _, _, idx2, counts2, esum2 = mk.quantize_topk_train_fused(flat, embed, k)
    b1 = mk.quantize_topk_fused(flat, embed, k)
    torch.cuda.synchronize()
    if not (torch.equal(counts, counts2) and torch.equal(esum, esum2)
            and torch.equal(idx, idx2)):
        fail("B2: two calls on the same input gave different statistics")
    vs_b1 = compare_outputs(torch, flat, (q, q1, idx), b1, k)
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
    return {"rows": res["rows"], "flips": res["flips"],
            "flip_max_rel_gap": res["flip_max_rel_gap"],
            "top1_flips": top1_flips, "max_abs_err": res["max_abs_err"],
            "flips_vs_b1": vs_b1["flips"],
            "esum_max_rel_err": worst, "deterministic": True, "idx": idx,
            "counts": counts}


def train_kernel_phase(torch, mk) -> dict:
    """B2 at the training path's shape (N = 4 clips * 32 * 32 = 4,096 rows)
    and at B1's (N = 196,608), in bf16 and f32, plus a ragged N and a
    codebook of duplicated codewords."""
    g = torch.Generator(device="cuda").manual_seed(2)
    dim, n_embed, k = 64, 256, 2
    embed = torch.randn(dim, n_embed, device="cuda", generator=g)
    z32 = torch.randn(192 * 32 * 32, dim, device="cuda", generator=g) * 0.5
    out = {}
    for n in (4 * 32 * 32, 192 * 32 * 32):
        for name, flat in (("bfloat16", z32[:n].to(torch.bfloat16)),
                           ("float32", z32[:n].contiguous())):
            res = public(compare_train_lookup(torch, mk, flat, embed, k))
            row = {"shape": [n, dim, n_embed, k], **res,
                   **time_pair(torch, mk.quantize_topk_train_fused,
                               mk.quantize_topk_train_fused_ref,
                               flat, embed, k),
                   **train_lookup_bound(n, dim, n_embed, k,
                                        flat.element_size())}
            out[(n, name)] = row
            emit("kernel_check", kernel="quantize_topk_train_fused",
                 input=f"N={n} {name}", **row)

    ragged = compare_train_lookup(torch, mk, z32[:1037].to(torch.bfloat16),
                                  embed, k)
    emit("kernel_check", kernel="quantize_topk_train_fused",
         input="ragged N=1037 bf16", **public(ragged))
    dup = embed.clone()
    dup[:, 1::2] = dup[:, 0::2]
    res = compare_train_lookup(torch, mk, z32[:65536], dup, k)
    if bool((res["idx"] % 2 != 0).any()) or bool(res["counts"][1::2].any()):
        fail("B2 tie-break: a higher index of equal codewords was picked")
    emit("kernel_check", kernel="quantize_topk_train_fused",
         input="duplicated codewords f32", lowest_index_wins=True,
         **public(res))
    try:
        mk.quantize_topk_train_fused(z32[:64], torch.randn(
            dim, 512, device="cuda", generator=g), k)
    except ValueError as exc:
        emit("kernel_check", kernel="quantize_topk_train_fused",
             input="n_embed=512 f32", raises=str(exc))
    else:
        fail("B2 at n_embed 512 (over the shared-memory limit) did not raise")
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
    """Every kernel's launch count to 0 (B1's by route too)."""
    mk.quantize_topk_fused.launches = 0
    mk.quantize_topk_fused.launches_by_route = dict.fromkeys(mk.ROUTES, 0)
    mk.quantize_topk_train_fused.launches = 0


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
    return out


def train_check_phase(torch, mk) -> dict:
    """One float32 step (TF32 off, cuDNN deterministic) of the released
    generator at 256x256, batch 4, from one state and batch: through the
    kernels (B2 in the forward) and with ``use_memory_kernel=False``."""
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
        metrics = make_twostream_train_step(LossConfig())(state, batch, flownet)
        torch.cuda.synchronize()
        launched = mk.quantize_topk_train_fused.launches - before
        if launched != (2 if use_kernel else 0):
            fail(f"train step (use_memory_kernel={use_kernel}) launched B2 "
                 f"{launched} times")
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
           "loss_max_rel_err": loss_err, "loss_tol": TRAIN_LOSS_REL,
           "codebook_max_abs_err": cb_err, "codebook_tol": TRAIN_CODEBOOK_TOL,
           "cluster_size_equal": cs_equal, "g_loss": m_k["g_loss"]}
    emit("train_check", **out)
    return out


def write_train_tree(root: str) -> None:
    """A ped2-shaped training split of numpy files: <root>/ped2/training/
    {frames,flows}/NN/, ``TRAIN_VIDEOS`` videos of ``TRAIN_FRAMES`` u8
    256x256 frames (.npy) and float32 flow fields, from a fixed seed."""
    import numpy as np

    rng = np.random.default_rng(20200526)
    s = IMAGE_SIZE
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    for vi in range(1, TRAIN_VIDEOS + 1):
        fdir = os.path.join(root, "ped2", "training", "frames", f"{vi:02d}")
        odir = os.path.join(root, "ped2", "training", "flows", f"{vi:02d}")
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
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        scalars = [read_scalars(run1), read_scalars(run2)]
        for sc in scalars:
            for tag, vals in sc.items():
                if not all(math.isfinite(v) for v in vals.values()):
                    fail(f"training path: scalar {tag} not finite: {vals}")
        if b2 != 2 * RESUME_STEPS:
            fail(f"B2 launched {b2} times in the training path, want 2 per "
                 f"step = {2 * RESUME_STEPS}")
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
           "resumed_steps_per_s": scalars[1]["steps_per_sec"],
           "first_run_wall_s": wall1, "peak_mem_gib": peak,
           "data_write_s": data_s, "quantize_topk_train_launches": b2,
           "quantize_topk_launches": b1,
           "quantize_topk_launches_by_route": b1_by_route,
           "g_loss_by_step": scalars[0]["g_loss"],
           "train_psnr_by_step": scalars[0]["train_psnr"],
           "restored_bit_exact": True}
    emit("train_path", **out)
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
    # B1's CUDA-core route and B2; B1's tensor-core route
    seconds = cuda_build.build(["quantize_topk", "quantize_topk_mma"])
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
    model_phase(torch, mk)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    main_run = main_path_phase(torch, mk, args.videos)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    train_check_phase(torch, mk)
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    train_run = train_path_phase(torch, mk)

    bf16 = checks[("bfloat16", 192 * 32 * 32, 2)]
    video = checks[("bfloat16", 176 * 32 * 32, 2)]
    psnr = checks[("bfloat16", 4 * 32 * 32, 2)]
    b2 = train_checks[(4 * 32 * 32, "bfloat16")]
    b2_f32 = train_checks[(4 * 32 * 32, "float32")]
    b2_big = train_checks[(192 * 32 * 32, "bfloat16")]
    print(json.dumps({"kernels": [{
        "name": "quantize_topk_fused",
        "route": "cuda",
        "kernel_route": mk.TENSOR_CORE,
        "source": "ammcnet_aaai2021_torch/csrc/quantize_topk_mma.cu",
        "replaces": "ammcnet_aaai2021_tpu/ops/memory_pallas.py:48",
        "launches": main_run["quantize_topk_launches"],
        "launches_by_route": main_run["quantize_topk_launches_by_route"],
        "launches_by_path": {"score": main_run["quantize_topk_launches"],
                             "train": train_run["quantize_topk_launches"]},
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
                              "kernel_ms", "plain_ms", "bound_ms",
                              "bound_by", "flips")}},
    }, {
        "name": "quantize_topk_train_fused",
        "route": "cuda",
        "source": "ammcnet_aaai2021_torch/csrc/quantize_topk.cu",
        "replaces": "ammcnet_aaai2021_tpu/ops/memory_pallas.py:84",
        "launches": train_run["quantize_topk_train_launches"],
        "max_abs_err": max(b2["max_abs_err"], b2_f32["max_abs_err"]),
        "esum_max_rel_err": max(b2["esum_max_rel_err"],
                                b2_f32["esum_max_rel_err"]),
        "flips": b2["flips"] + b2_f32["flips"],
        "ms": b2["kernel_ms"],
        "kernel_ms": b2["kernel_ms"],
        "kernel_eager_ms": b2["kernel_eager_ms"],
        "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"],
        "library_ms": None,
        "at_n_196608": {"kernel_ms": b2_big["kernel_ms"],
                        "kernel_eager_ms": b2_big["kernel_eager_ms"],
                        "plain_ms": b2_big["plain_ms"],
                        "bound_ms": b2_big["bound_ms"],
                        "bound_by": b2_big["bound_by"]},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
