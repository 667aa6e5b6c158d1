"""Run one cell of the benchmark of the PyTorch/CUDA port.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line, last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, with ``--trace 1``, ``breakdown``; the
numbers that decided ``correct``, each with its limit, come last in it
(``checks``) and as the last lines on standard error.  Exits non-zero,
printing no result, without enough CUDA devices, and if JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (from ``/proc``; 0 where it
    cannot be read)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS -= _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Python's bytecode of everything the run imports (torch's included) is
# cached at a fixed place inside the checkout, so that only a checkout's
# first run compiles it (about 5 s of every later run's set-up on the
# card's machine, whose environment turns bytecode writing off)
sys.pycache_prefix = str(Path(__file__).resolve().parent.parent / "build"
                         / "pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    doc = harness.manifest()
    cell = harness.find(doc["workloads"], args.workload, "workload")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    spec = harness.load_spec(args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             T_PROCESS, doc)
    kind = harness.load_json(harness.ROOT / "mixes" /
                             f"{cell['traffic']}.json")["driver"]
    outcome = harness.driver(kind).run(spec)

    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    metrics = {}
    if args.trace:
        for m in doc["per_layer"]:
            if harness.applies(m, args.workload):
                value = harness.metric_reader(m["name"])(outcome.readings)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in doc["end_to_end"]:
            if harness.applies(m, args.workload):
                metrics[m["name"]] = {"value": outcome.e2e[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    trace = outcome.readings.trace
    if args.trace:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in outcome.checks.items()}
    for note in outcome.notes:
        print(note, file=sys.stderr)
    print("readings: " + json.dumps(outcome.values), file=sys.stderr)
    print("setup phases (s): " + json.dumps(outcome.setup_phases),
          file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for name, (v, lim) in outcome.checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
