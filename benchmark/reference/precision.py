"""Lower-precision quantizers for the controls: the reference computed one
step below the precision the configuration states."""

import torch

FP8_E4M3_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 at a per-tensor scale (amax to the format's
    largest value), back in float32: the bf16 configuration's next step
    down."""
    scale = torch.clamp_min(t.detach().abs().amax(), 1e-30) / FP8_E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_e5m2(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e5m2 at a per-tensor scale, back in float32: the
    format fp8 training keeps its gradients in."""
    scale = torch.clamp_min(t.detach().abs().amax(), 1e-30) / FP8_E5M2_MAX
    return (t / scale).to(torch.float8_e5m2).to(torch.float32) * scale
