"""The share of the int8 forward's conv inputs that arrive already int8
(quantized to the site's scale by the producing conv's epilogue), from the
port's counters ``int8.inputs.{resident,static,dynamic}``
(``models/quantized.py``) over the traced segment.  None where the program
has no such counters."""

INPUTS = ("int8.inputs.resident", "int8.inputs.static", "int8.inputs.dynamic")


def read(r):
    if r.trace is None:
        return None
    try:
        from ammcnet_aaai2021_torch.utils.profiling import counts
    except ImportError:
        return None
    got = counts()
    total = sum(got.get(name, 0) for name in INPUTS)
    if not total:
        return None
    return 100.0 * got.get(INPUTS[0], 0) / total
