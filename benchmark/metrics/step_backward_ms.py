"""A training step's backward phase (the two ``autograd.grad`` calls, G's
loss through D and G, D's loss through D): the device time of the port's
``train_step.backward`` spans (``train/steps.py``, timed by CUDA events on
the stream) in the traced segment, over its steps.  None where the program
has no such span."""

SPAN = "train_step.backward"


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
