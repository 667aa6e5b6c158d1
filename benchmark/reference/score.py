"""The plain float32 reference of the scoring path's records.

A frozen copy of the arithmetic of the port's ``eval/infer.py``
(``_stack_windows``, ``_make_score_batch`` with per-frame PSNR and commit
distance, ``otf_flows``) and ``ops/metrics.py``'s ``psnr_per_frame``:
sliding windows of 5 u8 frames and 4 flows, time folded into channels,
frames normalized to [-1, 1], the generator in eval mode, per-window rows
``(rgb_psnr, rgb_commit, op_psnr, op_commit)``.
"""

from __future__ import annotations

import torch

RGB_CLIP, OP_CLIP = 5, 4


def stack_windows(video: torch.Tensor, starts: torch.Tensor, t: int
                  ) -> torch.Tensor:
    """(T, h, w, c) + (b,) window starts -> (b, t*c, h, w), channel
    ``ti*c + ch``."""
    idx = starts[:, None] + torch.arange(t, device=starts.device)[None, :]
    frames = video[idx]
    b, _, h, w, c = frames.shape
    return frames.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)


def psnr_per_frame(gen: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    gen = (gen.float() + 1.0) / 2.0
    gt = (gt.float() + 1.0) / 2.0
    return 10.0 * torch.log10(1.0 / (gt - gen).square().mean(dim=(1, 2, 3)))


@torch.no_grad()
def records(forward, rgb_u8: torch.Tensor, flows: torch.Tensor,
            n_windows: int, block: int = 32) -> torch.Tensor:
    """(4, n_windows) float32 rows of the first ``n_windows`` windows,
    ``block`` windows a forward.  ``forward(rgb_x, op_x)`` is the
    generator or the quantized reference."""
    rows = []
    for start in range(0, n_windows, block):
        starts = torch.arange(start, min(start + block, n_windows),
                              device=rgb_u8.device)
        rgb = (stack_windows(rgb_u8, starts, RGB_CLIP).float() / 255.0
               - 0.5) / 0.5
        op = stack_windows(flows, starts, OP_CLIP).float()
        rgb_pred, op_pred, (rgb_diff, op_diff), _ = forward(rgb[:, :-3],
                                                           op[:, :-2])
        rows.append(torch.stack([psnr_per_frame(rgb_pred, rgb[:, -3:]),
                                 rgb_diff.float(),
                                 psnr_per_frame(op_pred, op[:, -2:]),
                                 op_diff.float()]))
    return torch.cat(rows, dim=1)


@torch.no_grad()
def otf_flows(flownet, video_u8: torch.Tensor, n_pairs: int,
              chunk: int = 16) -> torch.Tensor:
    """FlowNet2-SD over the first ``n_pairs`` consecutive frame pairs of a
    (T, h, w, 3) u8 video, normalized as the ``.flo`` loader normalizes
    with the reference's channel overwrite: (n_pairs, h, w, 2) float32
    ``(u/h, u/h/w)``.  Each pair is computed alone, so the pairs a padded
    video adds change none of these."""
    outs = []
    for start in range(0, n_pairs, chunk):
        stop = min(start + chunk, n_pairs)
        f = video_u8[start:stop + 1].float()
        pairs = torch.stack([f[:-1], f[1:]], dim=-1)
        outs.append(flownet(pairs.permute(0, 3, 4, 1, 2)))
    flows = torch.cat(outs).permute(0, 2, 3, 1)
    h, w = flows.shape[1:3]
    u = flows[..., 0] / h
    return torch.stack([u, u / w], dim=-1)
