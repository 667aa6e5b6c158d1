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

Raw video (JAX ``eval/infer.py:287-365,563,629-709``): ``use_native_loader``
decodes JPEG frames and ``.flo`` flows with ``data/native.py`` (frames on
the scoring device: the IDCT, colour and resize kernels on a GPU, the C++
loader on the CPU), and a
``flow_extractor`` from :func:`make_otf_flow_extractor` makes the flows on
the device with FlowNet2-SD or FlowNet 2.0, so no flow file is read.

Deliberate deviations from the reference, as in the JAX package:
* per-frame commit distance instead of the batch-mean scalar the reference
  replicates across the batch (``batch_commit=True`` restores it);
* the op-stream PSNR target is the clip's last flow field
  (``reproduce_op_psnr_bug=True`` restores the reference's broadcast).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import VideoIndex, _decode_rgb, load_flow
from ..ops.metrics import OP_PER_FRAME_METRICS, PER_FRAME_METRICS
from ..parallel import multihost as multihost_lib
from ..utils.profiling import span


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


def otf_flows(flow_net: torch.nn.Module, video_u8: torch.Tensor,
              reproduce_flow_bug: bool = True, chunk: Optional[int] = None
              ) -> Tuple[torch.Tensor, int]:
    """A flow network over a video's consecutive frame pairs, normalized as
    the ``.flo`` loader normalizes: (T, h, w, 3) u8 -> ``((T-1, h, w, 2)
    float32, forwards)``, ``chunk`` pairs a forward (the last one ragged;
    None: the network's ``pairs_per_forward``, else 16),
    ``flow_net`` taking FlowNet2-SD's (b, 3, 2, h, w) pairs in [0, 255] to
    (b, 2, h, w) flows (``models.FlowNet2SD`` or ``models.FlowNet2``),
    under ``torch.inference_mode``.  ``reproduce_flow_bug``: the reference's
    channel overwrite (ch0 = u/h, ch1 = ch0/w); else (u/w, v/h)."""
    if chunk is None:
        chunk = getattr(flow_net, "pairs_per_forward", 16)
    n = video_u8.shape[0] - 1
    outs = []
    with torch.inference_mode():
        for start in range(0, n, chunk):
            f = video_u8[start:start + chunk + 1].float()  # [0, 255]
            pairs = torch.stack([f[:-1], f[1:]], dim=-1)  # (b, h, w, 3, 2)
            outs.append(flow_net(pairs.permute(0, 3, 4, 1, 2)))
        flows = torch.cat(outs).permute(0, 2, 3, 1)  # (T-1, h, w, 2)
        h, w = flows.shape[1:3]
        if reproduce_flow_bug:
            u = flows[..., 0] / h
            flows = torch.stack([u, u / w], dim=-1)
        else:
            flows = torch.stack([flows[..., 0] / w, flows[..., 1] / h],
                                dim=-1)
    return flows, len(outs)


def make_otf_flow_extractor(flow_net: torch.nn.Module,
                            reproduce_flow_bug: bool = True,
                            chunk: Optional[int] = None,
                            pad_to: Optional[int] = None,
                            gray: bool = False) -> Callable:
    """On-the-fly optical flow on the device (JAX ``eval/infer.py:287-365``):
    ``extract(video_u8 (T, h, w, 3)) -> (T-1, h, w, 2) bf16`` flows from
    :func:`otf_flows` of ``flow_net`` (FlowNet2-SD, or FlowNet 2.0, which
    the JAX package lacks) on the device ``video_u8`` lies on, cast to bf16
    whatever the network's type, as the JAX extractor does.  ``chunk``
    pairs a forward, by default the network's own (:func:`otf_flows`).

    ``pad_to``: edge-pad the video to this frame count on the device first.
    ``gray``: the input is (T, h, w, 1) u8, broadcast to the 3 equal
    channels a colour decode of a grayscale JPEG gives (exact, and a third
    of the upload).  With either, ``extract`` returns the pair
    ``(rgb (T', h, w, 3) u8, flows)`` for the scorer.  ``extract.forwards``
    counts FlowNet's forwards.  A call is the span ``flow.extract``
    (``utils/profiling.py``).
    """
    returns_pair = gray or pad_to is not None

    def extract(video_u8: torch.Tensor):
        with span("flow.extract"):
            return _extract(video_u8)

    def _extract(video_u8):
        if gray:
            if video_u8.shape[-1] != 1:
                raise ValueError(f"the gray extractor takes (T, h, w, 1) "
                                 f"frames, got {tuple(video_u8.shape)}")
            video_u8 = video_u8.expand(*video_u8.shape[:-1], 3).contiguous()
        if pad_to is not None and pad_to > video_u8.shape[0]:
            video_u8 = torch.cat([video_u8, video_u8[-1:].expand(
                pad_to - video_u8.shape[0], *video_u8.shape[1:])])
        flows, forwards = otf_flows(flow_net, video_u8, reproduce_flow_bug,
                                    chunk)
        extract.forwards += forwards
        flows = flows.to(torch.bfloat16)
        return (video_u8, flows) if returns_pair else flows

    extract.forwards = 0
    extract.gray, extract.returns_pair = gray, returns_pair
    return extract


def _edge_pad(x, extra: int):
    """Repeat the last frame of a numpy array or a tensor ``extra`` times."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(extra, *x.shape[1:])])
    return np.concatenate([x, np.repeat(x[-1:], extra, axis=0)], axis=0)


def pad_video_to_bucket(video_rgb_u8, video_op, bucket: int = 64):
    """Edge-pad a video's frame count up to the next bucket multiple (numpy
    arrays, or tensors on their device).  Returns (rgb, op,
    true_n_frames); ``video_op`` None (flows made on the device later)
    stays None."""
    t = video_rgb_u8.shape[0]
    extra = -(-t // bucket) * bucket - t
    if extra:
        video_rgb_u8 = _edge_pad(video_rgb_u8, extra)
        if video_op is not None:
            video_op = _edge_pad(video_op, extra)
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


def _one_channel(frames):
    """A video's first channel for the gray extractor (numpy or a tensor),
    guarded as the JAX package guards it (``eval/infer.py:698-702``): a
    video whose first frame's channels 0 and 2 differ raises, since a
    colour video would be scored on its red channel alone; so does a
    grayscale JPEG whose channel 0 the resize rounded 1 LSB off in frame
    0.  Later frames' channel 0 goes to the extractor as it is."""
    equal = torch.equal if isinstance(frames, torch.Tensor) else np.array_equal
    if not equal(frames[0, ..., 0], frames[0, ..., -1]):
        raise ValueError(
            "gray_upload/on-the-fly gray extractor on a video whose decoded "
            "channels differ — this dataset is not grayscale; drop "
            "--gray_upload")
    first = frames[..., :1]
    return (first.contiguous() if isinstance(first, torch.Tensor)
            else np.ascontiguousarray(first))


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
    use_native_loader: bool = False,
    flow_extractor: Optional[Callable] = None,
    shard_dir: Optional[str] = None,
) -> Tuple[Dict, float]:
    """Per-video batched scoring over a test set, on the device the
    ``model``'s parameters live on (it must be in eval mode).

    ``window_batch`` is the windows per forward; None means 192 for
    ``scorer_mode`` "video"/"auto" and ``batch_size`` for "batch" (the JAX
    package's two scorers; here both run the same eager loop).  Scores do not
    depend on it.  ``batch_size`` is also the record granularity of
    ``batch_commit``.

    ``use_native_loader``: JPEG frames and ``.flo`` flows through
    ``data/native.py``, the frames decoded on the scoring device (the IDCT,
    colour and resize kernels on a GPU, into an RGB tensor there; the C++
    loader on the CPU).
    ``flow_extractor`` (:func:`make_otf_flow_extractor`): the flows come
    from its network on the device over each bucket-padded video (T_pad - 1
    pairs); ``op_root`` is not read.  A gray extractor gets channel 0 of
    each frame and raises ``ValueError`` on a video whose first frame's
    channels 0 and 2 differ, as the JAX package does.

    Decoding of the next video runs on a thread pool while the current
    one's forwards run; its copy to the device (or, for a GPU decode, the
    wait for the decode's stream) is queued behind them.  Returns
    (result_dict in the reference's golden-pickle schema, windows scored
    per second).

    Multi-host (JAX ``eval/infer.py:662-772``): when a ``torch.distributed``
    group of more than one rank is initialized, the ranks agree on a run
    token, each scores its round-robin deal of the videos and writes its
    records to a shard under ``shard_dir/run_<token>`` (a directory every
    rank can reach; ``ValueError`` without one); rank 0 waits for every
    shard, merges them in global video order into its result and removes
    the directory, and the other ranks wait for that removal.  Their result
    holds their own videos only, and their windows per second.
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
    op_index = VideoIndex(op_root) if flow_extractor is None else None
    size = (image_size, image_size)
    gpu_decode = use_native_loader and device.type == "cuda"
    # the GPU decode's stream (its pool thread's current stream)
    side = torch.cuda.Stream(device) if gpu_decode else None
    if use_native_loader:
        from ..data import native

    def decode_video(name):
        # C++ and CUDA calls only (ctypes releases the GIL): no torch op on
        # the CPU; a GPU decode and its padding queue on `side`
        with torch.cuda.stream(side):
            if use_native_loader:
                frames = native.decode_video(rgb_index.videos[name], size,
                                             device=device)
            else:
                frames = np.stack(list(pool.map(
                    lambda p: _decode_rgb(p, size), rgb_index.videos[name])))
            if flow_extractor is not None:
                flows = None  # made on the device by the extractor
            elif use_native_loader:
                flows = native.load_flow_video(op_index.videos[name], size,
                                               reproduce_flow_bug)
            else:
                flows = np.stack(list(pool.map(
                    lambda p: load_flow(p, size, reproduce_flow_bug),
                    op_index.videos[name])))
            # fixed bucket shapes let the device allocator reuse the
            # previous video's blocks
            return pad_video_to_bucket(frames, flows)

    def to_device(x):
        # a host array or tensor goes through pinned memory to a GPU
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if pin and x.device.type == "cpu":
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    def upload(decoded):
        # torch work stays on this thread: a torch op on a pool thread starts
        # a second OpenMP team there, which keeps spinning and starves this
        # thread's CPU kernels
        frames, flows, true_frames = decoded
        if gpu_decode:
            # decoded on `side`: this stream waits for it, and the allocator
            # for this stream's reads before it reuses the frames' blocks
            main = torch.cuda.current_stream(device)
            main.wait_stream(side)
            frames.record_stream(main)
        if flow_extractor is not None and flow_extractor.gray:
            frames = _one_channel(frames)
        v_rgb = to_device(frames)
        if flow_extractor is not None:
            out = flow_extractor(v_rgb)
            v_rgb, v_op = out if flow_extractor.returns_pair else (v_rgb, out)
            return v_rgb, v_op, true_frames
        return (v_rgb, to_device(torch.from_numpy(flows).to(flow_dtype)),
                true_frames)

    result: Dict = {
        "dataset": dataset_name,
        "rgb_img_pred_records": [], "rgb_fea_comm_records": [],
        "op_img_pred_records": [], "op_fea_comm_records": [],
    }
    names = all_names = rgb_index.names
    multihost = multihost_lib.process_count() > 1
    if multihost:
        if not shard_dir:
            raise ValueError(
                "multi-host evaluation needs shard_dir (a directory every "
                "rank can reach) to merge the ragged per-video records")
        # a fresh per-run directory (the token is agreed while the ranks
        # start aligned): a rerun into the same directory, with fewer ranks
        # or another checkpoint, never merges another run's stale shards
        shard_dir = os.path.join(
            shard_dir, f"run_{multihost_lib.agree_on_run_token()}")
        names = multihost_lib.host_shard(names)
        if logger:
            logger.info("rank %d/%d scoring %d of %d videos",
                        multihost_lib.process_index(),
                        multihost_lib.process_count(), len(names),
                        len(all_names))
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
    if multihost:
        multihost_lib.write_record_shard(shard_dir, result, names)
        # a collective-free end of the run: rank 0 polls for the other
        # ranks' (atomically renamed) shard files
        if multihost_lib.process_index() == 0:
            multihost_lib.wait_for_shards(shard_dir)
            result.update(multihost_lib.merge_record_shards(shard_dir,
                                                            all_names))
            # the rename is the "merge done" signal the other ranks poll
            # for; removing the directory keeps recurring evaluations from
            # piling up stale shards
            multihost_lib.consume_shard_dir(shard_dir)
        else:
            multihost_lib.wait_for_merge(shard_dir)
    used = time.time() - t0
    fps = total_frames / used if used > 0 else 0.0
    if logger:
        logger.info("total time = %s, fps = %s", used, fps)
    return result, fps
