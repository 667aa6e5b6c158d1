"""int8-vs-bf16 conv throughput at the model's real layer shapes.

Port of ``ammcnet_aaai2021_tpu/tools/dtype_bench.py``.  For each UNet
level's 3x3 double-conv shape at the released 256x256 resolution (every
level has Cin == Cout; reference topology ``Code/models/unet.py:8-100``)
it times the port's int8 kernel (``csrc/int8_conv.cu``, called as the
registered op ``ammcnet::qconv3x3_int8``, int32 accumulation, its int8
epilogue) against cuDNN's bf16 convolution of the same shape (NHWC).

Methodology, as the JAX tool's: the timed work is a chain of serially
dependent convolutions (each one's output is the next one's input, int8
to int8 through the kernel's epilogue, bf16 to bf16 for cuDNN), so no
call can be skipped or overlapped; the weights rotate through
``--k_weights`` buffers; two chain lengths are timed with CUDA events and
``(t(n_hi) - t(n_lo)) / (n_hi - n_lo)`` leaves the device time of one
convolution, the launch and synchronization costs cancelled.

Prints a per-shape table and one JSON line with each level's times,
rates and int8 speedup, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

# Per-stream double-conv shapes of the released generator at 256x256
# (name, H, W, Cin, Cout)
LEVEL_SHAPES = [
    ("L1 256x256 64->64", 256, 256, 64, 64),
    ("L2 128x128 128->128", 128, 128, 128, 128),
    ("L3 64x64 256->256", 64, 64, 256, 256),
    ("L4 32x32 512->512", 32, 32, 512, 512),
]


def parser_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=32,
                   help="conv batch (windows)")
    p.add_argument("--k_weights", type=int, default=8,
                   help="distinct weight buffers rotated through the chain")
    p.add_argument("--n_lo", type=int, default=64)
    p.add_argument("--n_hi", type=int, default=512)
    p.add_argument("--trials", type=int, default=2,
                   help="timing trials per chain length; the least is kept")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is visible")
    return p.parse_args(argv)


def _chain_seconds(step, x, n: int, device) -> float:
    """Seconds of ``n`` chained calls of ``step`` from ``x``: CUDA events
    on a GPU, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            x = step(i, x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t = time.perf_counter()
    for i in range(n):
        x = step(i, x)
    return time.perf_counter() - t


def level_steps(h: int, w: int, cin: int, cout: int, batch: int,
                k_weights: int, device):
    """``{"bf16": (step, x0), "int8": (step, x0)}`` for one level: each
    ``step(i, x)`` one convolution of the chain with weight buffer
    ``i % k_weights``."""
    from ..ops.int8_kernels import COLS_ALIGN
    from ..ops.library import qconv3x3_int8

    g = torch.Generator(device=device).manual_seed(0)
    xb = torch.randn((batch, cin, h, w), generator=g, device=device
                     ).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wb = [(torch.randn((cout, cin, 3, 3), generator=g, device=device) * 0.05
           ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
          for _ in range(k_weights)]

    def bf16_step(i, x):
        return F.conv2d(x, wb[i % k_weights], padding=1)

    xq = torch.randint(-127, 128, (batch, h, w, cin), generator=g,
                       device=device, dtype=torch.int8)
    # the kernel's weight rows: cout padded to its column tile with zeros
    rows = -(-cout // COLS_ALIGN) * COLS_ALIGN
    wq = [F.pad(torch.randint(-127, 128, (cout, 9, cin), generator=g,
                              device=device, dtype=torch.int8),
                (0, 0, 0, 0, 0, rows - cout))
          for _ in range(k_weights)]
    sx = torch.tensor([1e-3], device=device)
    scale = torch.full((cout,), 1e-3, device=device)
    bias = torch.zeros((cout,), device=device)
    out_scale = torch.tensor([1.0], device=device)

    def int8_step(i, x):
        # int8 out at out_scale: the next convolution's input
        return qconv3x3_int8(x, wq[i % k_weights], sx, scale, bias, cout,
                             out_scale=out_scale)

    return {"bf16": (bf16_step, xb), "int8": (int8_step, xq)}


def main(argv=None) -> dict:
    args = parser_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (pass --device cpu)")
    from ..utils.profiling import card_name

    t0 = time.perf_counter()

    def hb(msg):
        print(f"[dtype_bench +{time.perf_counter() - t0:6.1f}s] {msg}",
              file=sys.stderr, flush=True)

    results = {}
    for name, h, w, cin, cout in LEVEL_SHAPES:
        flops = 2 * args.batch * h * w * cin * cout * 9
        row = {}
        for dtype, (step, x) in level_steps(h, w, cin, cout, args.batch,
                                            args.k_weights, device).items():
            _chain_seconds(step, x, 2, device)  # warm

            def timed(n):
                return min(_chain_seconds(step, x, n, device)
                           for _ in range(args.trials))

            t_lo, t_hi = timed(args.n_lo), timed(args.n_hi)
            per_conv = max(t_hi - t_lo, 1e-12) / (args.n_hi - args.n_lo)
            row[dtype] = {"per_conv_ms": per_conv * 1e3,
                          "tera_ops_per_s": flops / per_conv / 1e12}
            unit = "TOP/s" if dtype == "int8" else "TFLOP/s"
            hb(f"{name} {dtype}: {per_conv * 1e3:.4f} ms/conv "
               f"({flops / per_conv / 1e12:.1f} {unit})")
        row["int8_speedup"] = (row["bf16"]["per_conv_ms"]
                               / row["int8"]["per_conv_ms"])
        results[name] = row

    print(f"\n{'shape':<24} {'bf16 ms':>9} {'int8 ms':>9} {'speedup':>8}")
    for name, row in results.items():
        print(f"{name:<24} {row['bf16']['per_conv_ms']:>9.4f} "
              f"{row['int8']['per_conv_ms']:>9.4f} "
              f"{row['int8_speedup']:>8.2f}x")
    out = {"metric": "int8_conv_speedup_by_level", "batch": args.batch,
           "card": card_name(device),
           "value": {n: r["int8_speedup"] for n, r in results.items()},
           "levels": results}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
