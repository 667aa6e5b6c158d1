"""Readings of the controls and the planted faults, which the limits of
``benchmark/limits/<workload>.json`` are set between (the benchmark's own
runs never run this).

    python3 -m benchmark.control --workload <cell> --what <what> \\
        --seeds <n> [<n> ...] [--seconds 3]

``--what none`` runs the cell as it is; ``--what <control>`` puts one of
the cell's controls in the program's place: for the bf16 scoring cell's
generator ``int8``, the port's own int8 forward, and ``fp8_gen``, the
reference's generator with every convolution in float8 e4m3, and for its
flow extractor ``fp8_flow``, the reference's FlowNet2-SD so; ``int4``, the
int8 reference quantized to int4, for the int8 cell; ``fp8``, the float32
reference with every convolution in float8 e4m3, for the bf16 training
cells.  A fault name
(``benchmark/faults.py``) plants that fault under the timed path.  Every
seed is a full run of the cell (a short window) in this one process; each
prints one JSON line with every reading (the compared ones and those that
decide nothing), the limits and ``correct``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

def controls(spec) -> tuple:
    """The cell's controls: each stage's lower precision in the program's
    place."""
    if spec.mix["driver"] == "train":
        return ("fp8",)
    if spec.config.get("int8"):
        return ("int4",)
    return ("int8", "fp8_gen") + (("fp8_flow",) if spec.mix["flows"] == "otf"
                                  else ())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--what", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import faults, harness

    device = torch.device("cuda", 0)
    for seed in args.seeds:
        spec = harness.load_spec(args.workload, seed, args.seconds, False,
                                 device, time.perf_counter())
        spec.diagnose = True
        kind = spec.mix["driver"]
        if args.what == "none":
            ctx = contextlib.nullcontext()
        elif args.what in controls(spec):
            spec.control = args.what
            ctx = contextlib.nullcontext()
        else:
            ctx = faults.planted(args.what)
        t0 = time.perf_counter()
        with ctx:
            out = harness.driver(kind).run(spec)
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "control": spec.control, "seed": seed,
                          "correct": out.correct, "values": out.values,
                          "limits": spec.limits,
                          "notes": out.notes,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
