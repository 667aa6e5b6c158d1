#!/usr/bin/env python3
"""Device time of the general route of the memory lookups B1 and B2.

Times ``quantize_topk_fused`` (B1) and ``quantize_topk_train_fused`` (B2)
on the general route (``route="cuda_core"``: ``csrc/quantize_topk.cu``) at
``chip_smoke.py``'s shapes: its ``C1_TIMED`` (float32, width 64: n_embed
1024 at k 2 and n_embed 256 at k 16, N = 196,608 and 4,096), its
``kernel_check`` float32 rows (n_embed 256, k 2 at both N), bf16 latents
forced onto the route (N = 196,608, n_embed 256, k 2) and one width-128
row (float32, N = 196,608, n_embed 256, k 2); then the tensor-core route
(``csrc/quantize_topk_mma.cu``) at ``kernel_check``'s bf16 rows (N =
196,608 and 4,096, n_embed 256, k 2), so that a change to the general
route shows the other route held.  Each time is 20 calls in one CUDA
graph replayed 5 times between CUDA events (``chip_smoke.graph_ms``),
beside the card's bound for the same work; for B2 also the share of B1's
lookup (B1 alone on the same input and route) and of the statistics (the
rest).  A shape the package's kernel does not take is reported as
``raises``.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/torch_cuda_core_timing.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``ammcnet_aaai2021_torch`` is timed (by
default this one), so two commits can be compared in one call on one card,
in the order parent, change, change, parent.  Prints the card's name and
power limit, then one JSON line per shape and wrapper.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (N, width, n_embed, k, latent type, route)
SHAPES = ((196_608, 64, 1024, 2, "float32", "cuda_core"),
          (4_096, 64, 1024, 2, "float32", "cuda_core"),
          (4_096, 64, 256, 16, "float32", "cuda_core"),
          (196_608, 64, 256, 16, "float32", "cuda_core"),
          (196_608, 64, 256, 2, "float32", "cuda_core"),
          (4_096, 64, 256, 2, "float32", "cuda_core"),
          (196_608, 64, 256, 2, "bfloat16", "cuda_core"),
          (196_608, 128, 256, 2, "float32", "cuda_core"),
          (196_608, 64, 256, 2, "bfloat16", "tensor_core"),
          (4_096, 64, 256, 2, "bfloat16", "tensor_core"))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=REPO)
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs the card")
    sys.path.insert(0, root)
    from ammcnet_aaai2021_torch.ops import memory_kernels as mk

    if not os.path.abspath(mk.__file__).startswith(root + os.sep):
        sys.exit(f"imported {mk.__file__}, not the package under {root}")
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for n, dim, n_embed, k, dtype, route in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n_embed)
        embed = torch.randn(dim, n_embed, device="cuda", generator=g)
        flat = (torch.randn(n, dim, device="cuda", generator=g) * 0.5).to(
            getattr(torch, dtype))
        in_bytes = flat.element_size()
        lookup_ms = None
        for name, fn, bound in (
                ("quantize_topk_fused", mk.quantize_topk_fused,
                 smoke.lookup_bound),
                ("quantize_topk_train_fused", mk.quantize_topk_train_fused,
                 smoke.train_lookup_bound)):
            row = {"label": args.label, "card": card, "kernel": name,
                   "route": route, "dtype": dtype,
                   "shape": [n, dim, n_embed, k]}
            try:
                out = fn(flat, embed, k, route=route)
            except ValueError as exc:  # the shape this kernel does not take
                print(json.dumps({**row, "raises": str(exc)}), flush=True)
                continue
            call = lambda: fn(flat, embed, k, route=route)  # noqa: E731
            row["kernel_ms"] = smoke.graph_ms(torch, call)
            row["kernel_eager_ms"] = smoke.time_ms(torch, call)
            b = bound(n, dim, n_embed, k, in_bytes)
            row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
            if name == "quantize_topk_fused":
                lookup_ms = row["kernel_ms"]
            elif lookup_ms is not None:
                row["lookup_ms"] = lookup_ms
                row["stats_ms"] = row["kernel_ms"] - lookup_ms
                row["top1_max_share"] = float(torch.bincount(
                    out[2].long(), minlength=n_embed).max()) / n
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
