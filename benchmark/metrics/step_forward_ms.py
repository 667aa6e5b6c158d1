"""A training step's forward phase (the generator's train-mode forward,
its BatchNorm statistics and B2's codebook update): the device time of the
port's ``train_step.forward`` spans (``train/steps.py``, timed by CUDA
events on the stream) in the traced segment, over its steps.  None where
the program has no such span."""

SPAN = "train_step.forward"


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    try:
        from ammcnet_aaai2021_torch.utils.profiling import summary
    except ImportError:
        return None
    s = summary().get(SPAN)
    if not s or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / r.traced_units
