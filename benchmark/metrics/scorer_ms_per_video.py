"""The chunk scorer's device time a video: CUDA events around each call of
``ChunkScorer`` in the window (window gather, normalization, the generator
or the int8 forward, B1, the records), averaged."""


def read(r):
    t = r.timings.get("score")
    return 1e3 * sum(t) / len(t) if t else None
