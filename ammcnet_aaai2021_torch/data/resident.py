"""Device-resident training data: upload the split once, gather on the card.

Port of ``ammcnet_aaai2021_tpu/data/resident.py``.  A surveillance training
split is small next to the card's memory (ped2 at 256x256: about 0.3 GB of
u8 frames and bf16 flows against 80 GB), so the whole split lives on the
device and a batch is one small index upload plus one gather: no pixel
crosses the host link per step.

Sampling is the host samplers' (``TwoStreamTrainSampler`` in aligned mode,
``SingleStreamTrainSampler``): the same ``default_rng(seed)`` draw sequence
gives the same (video, offset) coordinates, and the gathered pixels equal
the host samplers' packed clips (u8 frames exactly; flows after their bf16
store).

Videos are padded to the longest along one flat frame axis
(V * Tmax, h, w, c); a clip is ``flat[v * Tmax + off + arange(t)]``.
Padding frames are never gathered: offsets are drawn against each video's
own length.  Frames go to the device one video at a time; no host copy of
the split is kept.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .datasets import VideoIndex, _decode_rgb, load_flow


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device-resident data on {dev}: no CUDA device "
                           "is visible")
    return dev


def _upload(index: VideoIndex, names: Sequence[str], data_type: str,
            image_size: int, reproduce_flow_bug: bool,
            dev: torch.device) -> torch.Tensor:
    """The split of one modality on ``dev``, (V * Tmax, h, w, c): u8 frames
    or bf16 flows, zero-padded per video to the longest."""
    lens = [index.length(n) for n in names]
    tmax = max(lens)
    size = (image_size, image_size)
    rgb = data_type == "rgb"
    flat = torch.zeros((len(names) * tmax, image_size, image_size,
                        3 if rgb else 2),
                       dtype=torch.uint8 if rgb else torch.bfloat16,
                       device=dev)
    for i, name in enumerate(names):
        paths = index.videos[name]
        frames = np.stack([_decode_rgb(p, size) if rgb
                           else load_flow(p, size, reproduce_flow_bug)
                           for p in paths])
        flat[i * tmax: i * tmax + len(paths)] = (
            torch.from_numpy(frames).to(dev).to(flat.dtype))
    return flat


class _Gather:
    """Clips of ``clip_length`` frames out of one resident modality."""

    def __init__(self, flat: torch.Tensor, tmax: int, clip_length: int):
        self.flat, self.tmax, self.clip_length = flat, tmax, clip_length

    def __call__(self, vid: np.ndarray, off: np.ndarray) -> torch.Tensor:
        idx = (vid * self.tmax + off)[:, None] + np.arange(self.clip_length)
        return self.flat[torch.from_numpy(idx).to(self.flat.device)]


class DeviceResidentTwoStream:
    """Whole-split-on-device clip pairs for stage-2 (rgb + op) training:
    frame-packed u8 rgb (b, t_rgb, h, w, 3) and bf16 flows
    (b, t_op, h, w, 2) on ``device``; the train step normalizes and
    interleaves.  Aligned sampling only: the reference's independent rgb/op
    draws (two_stream_dataset.py:466-470) stay on the host backend."""

    def __init__(self, rgb_index: VideoIndex, op_index: VideoIndex,
                 clip_len_rgb: int = 5, clip_len_op: int = 4,
                 image_size: int = 256, aligned: bool = True,
                 reproduce_flow_bug: bool = True, seed: int = 2017,
                 device="cuda"):
        if not aligned:
            raise ValueError(
                "device-resident sampling implements the aligned mode; the "
                "reference's independent rgb/op draws stay on the normal "
                "backend (--backend normal --unaligned_sampling)")
        dev = _device(device)
        self.rng = np.random.default_rng(seed)
        self.names: List[str] = [n for n in rgb_index.names
                                 if n in op_index.videos]
        if not self.names:
            raise ValueError("no common sub-videos between the rgb and op "
                             "roots")
        len_rgb = np.array([rgb_index.length(n) for n in self.names])
        len_op = np.array([op_index.length(n) for n in self.names])
        self._max_off = np.minimum(len_rgb - clip_len_rgb,
                                   len_op - clip_len_op)
        if (self._max_off < 0).any():
            raise ValueError("a video is shorter than the clip")
        rgb = _upload(rgb_index, self.names, "rgb", image_size,
                      reproduce_flow_bug, dev)
        op = _upload(op_index, self.names, "op", image_size,
                     reproduce_flow_bug, dev)
        self._rgb = _Gather(rgb, int(len_rgb.max()), clip_len_rgb)
        self._op = _Gather(op, int(len_op.max()), clip_len_op)
        self.resident_bytes = sum(t.numel() * t.element_size()
                                  for t in (rgb, op))

    def draw(self):
        """TwoStreamTrainSampler.draw's rng calls (aligned mode)."""
        i = int(self.rng.integers(len(self.names)))
        return i, int(self.rng.integers(self._max_off[i] + 1))

    def batch(self, batch_size: int) -> Dict[str, torch.Tensor]:
        vid, off = np.array([self.draw() for _ in range(batch_size)]).T
        return {"rgb": self._rgb(vid, off), "op": self._op(vid, off)}


class DeviceResidentSingleStream:
    """The stage-1 variant: one modality, (b, t, h, w, c) clips on
    ``device`` (u8 rgb or bf16 flows), SingleStreamTrainSampler's draws."""

    def __init__(self, index: VideoIndex, data_type: str, clip_length: int,
                 image_size: int = 256, reproduce_flow_bug: bool = True,
                 seed: int = 2017, device="cuda"):
        if data_type not in ("rgb", "op"):
            raise ValueError(f"data_type must be rgb or op, got {data_type!r}")
        dev = _device(device)
        self.rng = np.random.default_rng(seed)
        self.names = index.names
        lens = np.array([index.length(n) for n in self.names])
        self._max_off = lens - clip_length
        if (self._max_off < 0).any():
            raise ValueError("a video is shorter than the clip")
        flat = _upload(index, self.names, data_type, image_size,
                       reproduce_flow_bug, dev)
        self._gather = _Gather(flat, int(lens.max()), clip_length)
        self.resident_bytes = flat.numel() * flat.element_size()

    def draw(self):
        i = int(self.rng.integers(len(self.names)))
        return i, int(self.rng.integers(self._max_off[i] + 1))

    def batch(self, batch_size: int) -> torch.Tensor:
        vid, off = np.array([self.draw() for _ in range(batch_size)]).T
        return self._gather(vid, off)
