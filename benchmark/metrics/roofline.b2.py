"""B2's share of its roofline in the training cells: B2 is the lookup
kernel, then ema_stats_kernel.  The lookup kernel also serves B1 in the
PSNR forward of the log steps, at the same N, so B2's part of the lookup
time is its share of the lookup calls; the bound is each B2 call's
(benchmark/counts/lookup.py at N = batch x 32 x 32)."""

import re

LOOKUP = re.compile(r"quantize_topk_mma_kernel")
STATS = re.compile(r"ema_stats_kernel")


def read(r):
    bound = r.bounds.get("b2_call_s")
    if r.trace is None or r.kind != "train" or bound is None:
        return None
    n_lookup, t_lookup = r.trace.kernel_time(LOOKUP)
    n_b2, t_stats = r.trace.kernel_time(STATS)
    if not n_b2 or not n_lookup:
        return None
    secs = t_lookup * n_b2 / n_lookup + t_stats
    return 100.0 * n_b2 * bound / secs if secs > 0 else None
