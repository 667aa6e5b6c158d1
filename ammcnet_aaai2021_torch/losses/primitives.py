"""Loss primitives (NCHW).

Port of ``ammcnet_aaai2021_tpu/losses/primitives.py`` (reference
``Code/models/losses/losses_utils.py``): flow L1, intensity (l_num 1/2),
gradient difference (GDL), and the LSGAN adversarial / discriminator pair.
Inputs are ``(b, c, h, w)`` tensors, the layout of the port's models; every
loss computes in float32 whatever the input dtype and returns a float32
scalar.  Two reference quirks are kept: the L2 intensity loss is the mean
of the channel-axis L2 norm (``torch.norm(x - y, p=2, dim=1).mean()``,
losses_utils.py:117-129, with ``1e-20`` inside the square root), not an MSE;
and the GDL differences the channel *sum* with left/top zero padding
(losses_utils.py:30-61).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flow_loss(gen_flows: torch.Tensor, gt_flows: torch.Tensor) -> torch.Tensor:
    """Mean absolute error between flows (losses_utils.py:10-15)."""
    return (gen_flows.float() - gt_flows.float()).abs().mean()


def intensity_loss(gen: torch.Tensor, gt: torch.Tensor, l_num: int = 2
                   ) -> torch.Tensor:
    """l_num=1: mean |x-y|; l_num=2: mean over pixels of the channel-axis L2
    norm (losses_utils.py:117-129)."""
    d = gen.float() - gt.float()
    if l_num == 1:
        return d.abs().mean()
    if l_num == 2:
        return (d.square().sum(dim=1) + 1e-20).sqrt().mean()
    raise ValueError(f"l_num must be 1 or 2, got {l_num}")


def _channel_sum_grads(x: torch.Tensor):
    s = x.float().sum(dim=1)  # (b, h, w)
    dx = s - F.pad(s, (1, 0))[:, :, :-1]  # left zero pad, then difference
    dy = s - F.pad(s, (0, 0, 1, 0))[:, :-1, :]  # top zero pad
    return dx, dy


def gradient_loss(gen: torch.Tensor, gt: torch.Tensor, alpha: int = 1
                  ) -> torch.Tensor:
    """Gradient-difference loss (losses_utils.py:30-61): the reference's
    channel-summing [-1, 1] conv after left/top zero padding, written as a
    channel sum and a padded difference."""
    gen_dx, gen_dy = _channel_sum_grads(gen)
    gt_dx, gt_dy = _channel_sum_grads(gt)
    return ((gt_dx - gen_dx).abs() ** alpha
            + (gt_dy - gen_dy).abs() ** alpha).mean()


def adversarial_loss(fake_outputs: torch.Tensor) -> torch.Tensor:
    """Generator-side LSGAN term: mean((D(G)-1)^2 / 2) (losses_utils.py:100-104)."""
    return ((fake_outputs.float() - 1.0).square() / 2.0).mean()


def discriminate_loss(real_outputs: torch.Tensor,
                      fake_outputs: torch.Tensor) -> torch.Tensor:
    """Discriminator-side LSGAN: mean((D(x)-1)^2/2) + mean(D(G)^2/2)
    (losses_utils.py:106-110)."""
    return (((real_outputs.float() - 1.0).square() / 2.0).mean()
            + (fake_outputs.float().square() / 2.0).mean())
