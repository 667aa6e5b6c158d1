#!/usr/bin/env python3
"""Device time of the CUDA-core route of the memory lookups B1 and B2.

Times ``quantize_topk_fused`` (B1) and ``quantize_topk_train_fused`` (B2)
on float32 latents (the CUDA-core route: ``csrc/quantize_topk.cu``), dim 64,
k 2, at N = 196,608 and 4,096 rows and n_embed 256 and 1024, each as 20
calls in one CUDA graph replayed 5 times between CUDA events (chip_smoke.py's
``graph_ms``), beside the card's bound for the same work.  A shape the
package's kernel does not take is reported as ``raises``.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/torch_cuda_core_timing.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``ammcnet_aaai2021_torch`` is timed (by
default this one), so two commits can be compared in one call on one card,
in the order parent, change, change, parent.  Prints the card's name and
power limit, then one JSON line per shape.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((196_608, 256), (4_096, 256), (196_608, 1024), (4_096, 1024))


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
    cc = mk.CUDA_CORE
    for n, n_embed in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n_embed)
        embed = torch.randn(64, n_embed, device="cuda", generator=g)
        flat = torch.randn(n, 64, device="cuda", generator=g) * 0.5
        for name, fn, bound in (
                ("quantize_topk_fused", mk.quantize_topk_fused,
                 smoke.lookup_bound),
                ("quantize_topk_train_fused", mk.quantize_topk_train_fused,
                 smoke.train_lookup_bound)):
            row = {"label": args.label, "card": card, "kernel": name,
                   "route": cc, "dtype": "float32", "shape": [n, 64, n_embed, 2]}
            try:
                fn(flat, embed, 2, route=cc)
            except ValueError as exc:  # the shape this kernel does not take
                print(json.dumps({**row, "raises": str(exc)}), flush=True)
                continue
            call = lambda: fn(flat, embed, 2, route=cc)  # noqa: E731
            row["kernel_ms"] = smoke.graph_ms(torch, call)
            row["kernel_eager_ms"] = smoke.time_ms(torch, call)
            b = bound(n, 64, n_embed, 2, 4)
            row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
