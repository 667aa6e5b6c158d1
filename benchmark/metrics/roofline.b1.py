"""B1's share of its roofline in the scoring cells: the traced segment's
calls of the tensor-core lookup kernel times each call's bound
(benchmark/counts/lookup.py at N = windows x 32 x 32) over their device
time."""

import re

PATTERN = re.compile(r"quantize_topk_mma_kernel")


def read(r):
    bound = r.bounds.get("b1_call_s")
    if r.trace is None or r.kind != "score" or bound is None:
        return None
    calls, secs = r.trace.kernel_time(PATTERN)
    return 100.0 * calls * bound / secs if calls and secs > 0 else None
