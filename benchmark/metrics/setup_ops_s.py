"""The port's op set-up: the host seconds of its one-time ``setup.ops``
record (``ops/library.py``'s imports, ``torch._dynamo`` among them, and
op registrations; each kernel library's build or load,
``ops/cuda_build.load``), in the run's process.  None where the program
has no such record."""


def read(r):
    if r.trace is None:
        return None
    try:
        from ammcnet_aaai2021_torch.utils.profiling import summary
    except ImportError:
        return None
    s = summary().get("setup.ops")
    return s["host_s"] if s else None
