"""Device time by kernel group from a ``torch.profiler`` trace.

Shared by ``torch_score_profile.py`` and ``torch_train_profile.py``: one
table of coarse kernel groups and one aggregation of ``key_averages()``.
"""

from __future__ import annotations

# coarse kernel groups, first match wins (cuDNN / ATen / the port's kernel
# names, lower case)
GROUPS = (
    ("memory lookup kernels (B1, B2)", ("quantize_topk", "prep_codebook",
                                        "ema_stats")),
    ("int8 convolution kernels", ("qconv_int8",)),
    ("optimizer (Adam, foreach)", ("multi_tensor", "adam")),
    ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("convolution (fwd, dgrad, wgrad)", ("conv", "xmma", "gemm", "cutlass",
                                         "implicit", "winograd", "fft",
                                         "dgrad", "wgrad")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("pooling and upsampling", ("pool", "upsample")),
    ("reductions (statistics, losses)", ("reduce",)),
    ("elementwise (casts, ReLU, adds, copies)",
     ("elementwise", "vectorized", "unrolled", "cat", "copy", "index",
      "gather", "fill", "scatter")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_summary(prof, wall_us: float, repeats: int, per: str,
                   top: int = 15) -> dict:
    """Device milliseconds per ``per`` (a step, a batch) over ``repeats``
    traced repeats: the total, by kernel group and for the ``top`` largest
    kernels, the kernel launches, and the device's busy share of the traced
    wall time ``wall_us``.  The profiler also puts the optimizer's range
    (``Optimizer.step#Adam.step``) on the device's timeline; it is not a
    kernel and is left out."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Optimizer.")]
    device_us = sum(e.device_time_total for e in kernels)
    groups: dict = {}
    for e in kernels:
        key = group_of(e.key)
        groups[key] = groups.get(key, 0.0) + e.device_time_total
    largest = sorted(kernels, key=lambda e: -e.device_time_total)[:top]
    return {
        f"wall_ms_per_{per}": wall_us / repeats / 1e3,
        f"device_ms_per_{per}": device_us / repeats / 1e3,
        "device_busy_share": device_us / wall_us if wall_us else None,
        f"kernel_launches_per_{per}": sum(e.count for e in kernels) / repeats,
        f"groups_ms_per_{per}": {k: v / repeats / 1e3 for k, v in
                                 sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": e.key[:120], "calls": e.count // repeats,
                         f"ms_per_{per}": e.device_time_total / repeats / 1e3}
                        for e in largest]}
