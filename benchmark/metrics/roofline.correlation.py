"""FlowNet 2.0's correlation kernel's share of its roofline: the traced
segment's calls of ``correlation_kernel`` times each call's bound
(benchmark/counts/flownet2.py: the larger of its compulsory bytes at the
memory bandwidth and its products at the bf16 peak, averaged over a
video's calls, the mix's ``flow_chunk`` pairs each but the ragged last) over
their device time.
None where the run has no such kernel or bound."""

import re

PATTERN = re.compile(r"correlation_kernel")


def read(r):
    bound = r.bounds.get("correlation_call_s")
    if r.trace is None or r.kind != "score" or bound is None:
        return None
    calls, secs = r.trace.kernel_time(PATTERN)
    return 100.0 * calls * bound / secs if calls and secs > 0 else None
