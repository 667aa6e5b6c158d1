"""Clip -> anomaly-score inference over a test set.

Port of the scoring path of ``ammcnet_aaai2021_tpu/eval/infer.py``
(reference ``Code/run_helper/test_helper.py:387-488``): each sub-video is
uploaded once (u8 frames, flows at the model's compute dtype), sliding
windows are gathered on the device, normalized, run through the two-stream
generator, and scored per frame; each video costs one result fetch.

Record-assembly semantics preserved exactly (test_helper.py:455-476):
positions ``cnt + clip_len - 1`` hold scores, the leading ``clip_len - 1``
frames are back-filled with the first score, and the op arrays' final
position is copied from its predecessor.

Deliberate deviations from the reference, as in the JAX package:
* per-frame commit distance instead of the batch-mean scalar the reference
  replicates across the batch (``batch_commit=True`` restores it);
* the op-stream PSNR target is the clip's last flow field
  (``reproduce_op_psnr_bug=True`` restores the reference's broadcast).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import VideoIndex, _decode_rgb, load_flow
from ..ops.metrics import OP_PER_FRAME_METRICS, PER_FRAME_METRICS


def _stack_windows(video: torch.Tensor, idx: torch.Tensor, t: int
                   ) -> torch.Tensor:
    """Gather ``len(idx)`` sliding windows of ``t`` frames and fold time into
    channels: (T,h,w,c) + (b,) starts -> (b, t*c, h, w), channel ``ti*c + ch``
    — the order ``[f0_c0..f0_cn, f1_c0..]`` of the reference's
    ``view(b,-1,h,w)`` fold (train_helper.py:302-305)."""
    widx = idx[:, None] + torch.arange(t, device=idx.device)[None, :]
    frames = video[widx]  # (b, t, h, w, c)
    b, _, h, w, c = frames.shape
    return frames.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)


def op_psnr_reference_bug(op_pred: torch.Tensor, op_input: torch.Tensor
                          ) -> torch.Tensor:
    """Reference-exact op-stream 'PSNR': the torch test loop compares the
    (1,2,h,w) prediction against the (1,3,2,h,w) INPUT stack via accidental
    broadcasting (test_helper.py:434-436 with utils.psnr_error:130-148):
    num_pixels = 2*h*w, the squared diff sums over (field, uv, h) leaving a
    per-column vector, log10, then mean.

    Args: op_pred (b,2,h,w); op_input (b,6,h,w) channel-stacked 3 fields.
    """
    b, _, h, w = op_pred.shape
    fields = op_input.float().reshape(b, 3, 2, h, w)
    gt = (fields + 1.0) / 2.0
    gen = (op_pred.float() + 1.0) / 2.0
    sq = (gt - gen[:, None]).square()  # (b, 3, 2, h, w)
    col = sq.sum(dim=(1, 2, 3))  # (b, w)
    num_pixels = 2 * h * w
    return (10.0 * torch.log10(num_pixels / col)).mean(dim=1)


def _make_score_batch(model, clip_len_rgb: int, clip_len_op: int,
                      rgb_channels: int, op_channels: int, metric: str,
                      op_metric: Optional[str],
                      reproduce_op_psnr_bug: bool) -> Callable:
    """``score_batch(video_rgb_u8, video_op, idx) -> (4, b)`` float32 rows
    (rgb_psnr, rgb_fea, op_psnr, op_fea): gathers uint8 windows on the
    device, normalizes only the gathered clip, runs the generator and
    computes the per-frame metrics."""
    metric_fn = PER_FRAME_METRICS[metric]
    op_metric_fn = OP_PER_FRAME_METRICS[op_metric or metric]

    def score_batch(video_rgb, video_op, idx):
        rgb_clip = _stack_windows(video_rgb, idx, clip_len_rgb)
        op_clip = _stack_windows(video_op, idx, clip_len_op)
        rgb = (rgb_clip.float() / 255.0 - 0.5) / 0.5
        rgb_input, rgb_target = rgb[:, :-rgb_channels], rgb[:, -rgb_channels:]
        op_input, op_target = op_clip[:, :-op_channels], op_clip[:, -op_channels:]
        rgb_pred, op_pred, (rgb_diff, op_diff), _ = model(rgb_input, op_input)
        if reproduce_op_psnr_bug:
            op_score = op_psnr_reference_bug(op_pred, op_input)
        else:
            op_score = op_metric_fn(op_pred, op_target.float())
        b = rgb_pred.shape[0]
        return torch.stack([
            metric_fn(rgb_pred, rgb_target),
            rgb_diff.float().expand(b),
            op_score,
            op_diff.float().expand(b),
        ])

    return score_batch


def pad_video_to_bucket(video_rgb_u8: np.ndarray, video_op: np.ndarray,
                        bucket: int = 64):
    """Edge-pad a video's frame count up to the next bucket multiple.
    Returns (rgb, op, true_n_frames)."""
    t = video_rgb_u8.shape[0]
    t_pad = -(-t // bucket) * bucket
    if t_pad != t:
        video_rgb_u8 = np.concatenate(
            [video_rgb_u8,
             np.repeat(video_rgb_u8[-1:], t_pad - t, axis=0)], axis=0)
        video_op = np.concatenate(
            [video_op, np.repeat(video_op[-1:], t_pad - t, axis=0)], axis=0)
    return video_rgb_u8, video_op, t


def window_batches(n_windows: int, window_batch: int):
    """Window-start batches for one video: ``min(window_batch, n_windows)``
    starts each, the last batch edge-padded so every forward of the video
    has one shape.  Yields (starts, actual_count)."""
    wb = min(window_batch, n_windows)
    for start in range(0, n_windows, wb):
        idx = np.arange(start, min(start + wb, n_windows))
        actual = len(idx)
        yield np.pad(idx, (0, wb - actual), mode="edge"), actual


def blockwise_mean(values: np.ndarray, block: int) -> np.ndarray:
    """Replace each length-`block` chunk (last chunk partial) with its mean —
    the reference's batch-replicated fea_comm (one DataLoader batch = one
    value), with partial final batches averaged over REAL members only."""
    out = np.empty_like(values)
    for start in range(0, len(values), block):
        chunk = values[start : start + block]
        out[start : start + block] = chunk.mean()
    return out


def _assemble_records(scores: np.ndarray, num_frame: int,
                      clip_len: int) -> np.ndarray:
    """Sliding-window scores -> per-frame array with reference boundary
    padding (test_helper.py:465-476)."""
    arr = np.empty((num_frame,), dtype=np.float32)
    arr[clip_len - 1 : clip_len - 1 + len(scores)] = scores
    arr[: clip_len - 1] = arr[clip_len - 1]
    # windows stop at num_frame - clip_len + 1; any tail frames (op stream is
    # one file shorter than rgb) copy their predecessor
    tail_start = clip_len - 1 + len(scores)
    for i in range(tail_start, num_frame):
        arr[i] = arr[i - 1]
    return arr


def score_dataset(
    model: torch.nn.Module,
    rgb_root: str,
    op_root: str,
    dataset_name: str,
    clip_len_rgb: int = 5,
    clip_len_op: int = 4,
    batch_size: int = 16,
    window_batch: Optional[int] = None,
    image_size: int = 256,
    reproduce_flow_bug: bool = True,
    logger=None,
    metric: str = "psnr",
    op_metric: Optional[str] = None,
    batch_commit: bool = False,
    reproduce_op_psnr_bug: bool = False,
    scorer_mode: str = "auto",
) -> Tuple[Dict, float]:
    """Per-video batched scoring over a test set, on the device the
    ``model``'s parameters live on (it must be in eval mode).

    ``window_batch`` is the windows per forward; None means 192 for
    ``scorer_mode`` "video"/"auto" and ``batch_size`` for "batch" (the JAX
    package's two scorers; here both run the same eager loop).  Scores do not
    depend on it.  ``batch_size`` is also the record granularity of
    ``batch_commit``.

    Decoding (and, on a GPU, pinning) of the next video runs on a thread
    pool while the current one's forwards run; its copy to the device is
    queued behind them.  Returns (result_dict in the reference's
    golden-pickle schema, windows scored per second).
    """
    if scorer_mode not in ("auto", "video", "batch"):
        raise ValueError(f"unknown scorer_mode {scorer_mode!r} "
                         "(batch | video | auto)")
    if window_batch is None:
        window_batch = batch_size if scorer_mode == "batch" else 192
    device = next(model.parameters()).device
    flow_dtype = getattr(model, "dtype", torch.float32)
    pin = device.type == "cuda"
    score_batch = _make_score_batch(
        model, clip_len_rgb, clip_len_op, 3, 2, metric, op_metric,
        reproduce_op_psnr_bug)
    rgb_index = VideoIndex(rgb_root)
    op_index = VideoIndex(op_root)
    size = (image_size, image_size)

    def decode_video(name):
        frames = np.stack(list(pool.map(lambda p: _decode_rgb(p, size),
                                        rgb_index.videos[name])))
        flows = np.stack(list(pool.map(
            lambda p: load_flow(p, size, reproduce_flow_bug),
            op_index.videos[name])))
        # fixed bucket shapes let the device allocator reuse the previous
        # video's blocks
        return pad_video_to_bucket(frames, flows)

    def upload(decoded):
        # torch work stays on this thread: a torch op on a pool thread starts
        # a second OpenMP team there, which keeps spinning and starves this
        # thread's CPU kernels
        frames, flows, true_frames = decoded
        rgb_h = torch.from_numpy(frames)
        op_h = torch.from_numpy(flows).to(flow_dtype)
        if pin:
            rgb_h, op_h = rgb_h.pin_memory(), op_h.pin_memory()
        return (rgb_h.to(device, non_blocking=True),
                op_h.to(device, non_blocking=True), true_frames)

    result: Dict = {
        "dataset": dataset_name,
        "rgb_img_pred_records": [], "rgb_fea_comm_records": [],
        "op_img_pred_records": [], "op_fea_comm_records": [],
    }
    names = rgb_index.names
    total_frames = 0
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=8) as pool, torch.inference_mode():
        if names:
            pending = pool.submit(decode_video, names[0])
            current = upload(pending.result())
            if len(names) > 1:
                pending = pool.submit(decode_video, names[1])
        for vi, name in enumerate(names):
            v_rgb, v_op, num_frame = current
            n_windows = num_frame - clip_len_rgb + 1
            launched, counts = [], []
            for starts, actual in window_batches(n_windows, window_batch):
                idx = torch.from_numpy(starts).to(device)
                launched.append(score_batch(v_rgb, v_op, idx))
                counts.append(actual)
            if vi + 1 < len(names):
                current = upload(pending.result())  # queued behind the forwards
                if vi + 2 < len(names):
                    pending = pool.submit(decode_video, names[vi + 2])
            stacked = torch.stack(launched).cpu().numpy()  # the one fetch
            rgb_psnr, rgb_fea, op_psnr, op_fea = (
                np.concatenate([row[:n] for row, n in zip(stacked[:, i], counts)])
                for i in range(4))
            if batch_commit:
                # reference-exact commit records: one batch-mean value per
                # DataLoader batch (test_helper.py:446)
                rgb_fea = blockwise_mean(rgb_fea, batch_size)
                op_fea = blockwise_mean(op_fea, batch_size)
            total_frames += len(rgb_psnr)
            result["rgb_img_pred_records"].append(
                _assemble_records(rgb_psnr, num_frame, clip_len_rgb))
            result["rgb_fea_comm_records"].append(
                _assemble_records(rgb_fea, num_frame, clip_len_rgb))
            result["op_img_pred_records"].append(
                _assemble_records(op_psnr, num_frame, clip_len_op))
            result["op_fea_comm_records"].append(
                _assemble_records(op_fea, num_frame, clip_len_op))
            if logger:
                logger.info("finish test video set %s", name)
    used = time.time() - t0
    fps = total_frames / used if used > 0 else 0.0
    if logger:
        logger.info("total time = %s, fps = %s", used, fps)
    return result, fps
