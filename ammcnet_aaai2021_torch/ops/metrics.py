"""Image/flow quality metrics, batched, per frame.

Port of ``ammcnet_aaai2021_tpu/ops/metrics.py`` (reference
``Code/utils/utils.py:97-152`` and ``Code/utils/pytorch_ssim.py``),
vectorized over the batch axis.  Inputs are NCHW ``(b, c, h, w)``, the
layout of the port's models; outputs are ``(b,)`` float32 vectors
(``gray_diff``: ``(b, h, w)``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr_per_frame(gen: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-frame PSNR on [-1, 1] images mapped to [0, 1] (utils.py:130-148)."""
    gen = (gen.float() + 1.0) / 2.0
    gt = (gt.float() + 1.0) / 2.0
    mse = (gt - gen).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / mse)


def mse_per_frame(gen: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-frame MSE x 256 (reference utils.py:97-111 scales by 16*16)."""
    d = gt.float() - gen.float()
    return d.square().mean(dim=(1, 2, 3)) * 256.0


def epe_per_frame(gen_flow: torch.Tensor, gt_flow: torch.Tensor) -> torch.Tensor:
    """Per-frame mean endpoint error over (b, 2, h, w) flows (reference
    utils.py:151-152)."""
    d = gt_flow.float() - gen_flow.float()
    return (d.square().sum(dim=1) + 1e-20).sqrt().mean(dim=(1, 2))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim_per_frame(gen: torch.Tensor, gt: torch.Tensor, window_size: int = 11,
                   sigma: float = 1.5) -> torch.Tensor:
    """Per-frame Gaussian-window SSIM (reference pytorch_ssim.py): a
    per-channel (depthwise) filter, the map's mean over channels and space."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    img1, img2 = gen.float(), gt.float()
    channels = img1.shape[1]
    w = _gaussian_window(window_size, sigma, img1.device)
    kernel = w.expand(channels, 1, window_size, window_size)
    pad = window_size // 2

    def filt(x):
        return F.conv2d(x, kernel, padding=pad, groups=channels)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean(dim=(1, 2, 3))


# scoring-metric registry (reference loss_func_mapp, test_helper.py:397-401)
PER_FRAME_METRICS = {
    "psnr": psnr_per_frame,
    "mse": mse_per_frame,
    "ssim": ssim_per_frame,
}

# op-stream-only metrics: EPE is flow-native (2-channel displacement
# fields), so it is selectable only for the motion stream (run_test
# --op_metric epe); the rgb stream keeps the reference's psnr/mse/ssim map
OP_PER_FRAME_METRICS = {**PER_FRAME_METRICS, "epe": epe_per_frame}


def gray_diff(gen: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Abs grayscale difference (reference diff_mask/bgr_gray path)."""
    weights = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                           device=gen.device)
    g1 = torch.einsum("bchw,c->bhw", gen.float(), weights)
    g2 = torch.einsum("bchw,c->bhw", gt.float(), weights)
    return (g1 - g2).abs()
