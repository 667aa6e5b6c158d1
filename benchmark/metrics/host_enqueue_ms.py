"""Host time a training step spends in the port's step call (its launches
being enqueued; the call returns before the card is done), by the host
clock around each call in the window, averaged."""


def read(r):
    t = r.timings.get("enqueue")
    return 1e3 * sum(t) / len(t) if t else None
