"""The share of the traced segment in which no kernel, copy or memset ran
on the card (1 - the union of their intervals over the segment), for
score cells."""


def read(r):
    if r.trace is None or r.kind != "score" or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
