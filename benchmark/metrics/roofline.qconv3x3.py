"""The int8 qconv3x3 convolutions' share of their roofline: the traced
segment's calls of ``qconv_wgmma_kernel<9, ...>`` against the sum of each
call's bound (benchmark/counts/int8.py: operations at the int8 peak or
compulsory bytes at the memory bandwidth, from the forward's shapes) over
their device time."""

import re

PATTERN = re.compile(r"qconv_wgmma_kernel<\s*9\s*,")


def read(r):
    bound = r.bounds.get("qconv3x3_forward_s")
    per_forward = r.bounds.get("qconv3x3_calls")
    if r.trace is None or bound is None:
        return None
    calls, secs = r.trace.kernel_time(PATTERN)
    if not calls or secs <= 0 or calls % per_forward:
        return None
    return 100.0 * (calls // per_forward) * bound / secs
