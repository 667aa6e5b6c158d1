"""Model FLOPs of the window's work (benchmark/counts/model.py: true
windows only for scoring, the step's own FLOPs for training) over the
window's seconds, as a share of the peak the configuration declares, for
score cells."""


def read(r):
    if r.kind != "score" or r.window_s <= 0 or not r.window_flops:
        return None
    return 100.0 * r.window_flops / r.window_s / r.peak_flops
