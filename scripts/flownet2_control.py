#!/usr/bin/env python3
"""Readings of the FlowNet 2.0 cell (``score.ped2.int8.flownet2``) with a
control in the program's place, as ``benchmark/control.py`` takes them for
the other cells (whose list of controls has no ``fp8_flow`` for an int8
configuration).

    python3 scripts/flownet2_control.py --what fp8_flow|int4|none \\
        --seeds <n> [<n> ...] [--seconds 3]

``fp8_flow``: the reference FlowNet 2.0 with every convolution in float8
e4m3 in the extractor's place; ``int4``: the int8 reference at int4 in the
generator's; ``none``: the cell as it is.  Each seed is a full run of the
cell (a short window) in this one process; each prints one JSON line with
every reading, the limits and ``correct``.  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CELL = "score.ped2.int8.flownet2"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--what", required=True, choices=("fp8_flow", "int4",
                                                     "none"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    for seed in args.seeds:
        spec = harness.load_spec(CELL, seed, args.seconds, False,
                                 torch.device("cuda", 0), time.perf_counter())
        spec.diagnose = True
        spec.control = None if args.what == "none" else args.what
        t0 = time.perf_counter()
        out = harness.driver(spec.mix["driver"]).run(spec)
        print(json.dumps({"workload": CELL, "what": args.what, "seed": seed,
                          "correct": out.correct, "values": out.values,
                          "limits": spec.limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
