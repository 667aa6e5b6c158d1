"""The int8 forward's activation quantize a video: the device time of the
port's ``int8.quantize`` spans (``models/quantized.py``: each conv input's
quantize and the padding that makes the kernel's input, timed by CUDA
events on the stream) in the traced segment, over its videos.  None where
the program has no such span."""


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    try:
        from ammcnet_aaai2021_torch.utils.profiling import summary
    except ImportError:
        return None
    s = summary().get("int8.quantize")
    if not s or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / r.traced_units
