"""Kernel launches a training step: the profiler's kernel-launch API calls
in the traced segment, over its steps (the PSNR forward of its log steps
included)."""


def read(r):
    if r.trace is None or r.kind != "train" or not r.traced_units:
        return None
    return r.trace.launches / r.traced_units
