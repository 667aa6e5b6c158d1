"""FlowNet2-SD's device time a video: CUDA events around each call of the
port's flow extractor in the window (its upload's padding and broadcast
included), averaged."""


def read(r):
    t = r.timings.get("flow")
    return 1e3 * sum(t) / len(t) if t else None
