"""Framepack: memory-mapped packed-frame storage.

The port's copy of ``ammcnet_aaai2021_tpu/data/framepack.py`` (the
successor of the reference's LMDB backend, ``Code/dataset/lmdb_dataset.py``),
in the same file format, so a pack written by either package reads in the
other.  A dataset split is ONE flat binary file of fixed-shape preprocessed
frames plus a JSON index, and reads are zero-copy ``np.memmap`` slices.

File layout:
    <name>.fpk       raw frames, C-order, concatenated video-major
    <name>.fpk.json  {"dtype", "shape": [h, w, c], "videos": {name: [offset,
                     n_frames]}}  (offset in frames)
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .datasets import VideoIndex, _decode_rgb, load_flow


class FramePackWriter:
    """Appends videos of ``frame_shape`` frames to ``path``; ``close`` (or
    leaving the ``with`` block) writes the JSON index."""

    def __init__(self, path: str, frame_shape: Tuple[int, int, int],
                 dtype: str = "uint8"):
        self.path = path
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self._fh = open(path, "wb")
        self._videos: Dict[str, List[int]] = {}
        self._offset = 0

    def add_video(self, name: str, frames: np.ndarray) -> None:
        if frames.shape[1:] != self.frame_shape:
            raise ValueError(f"frames of shape {frames.shape[1:]} in a pack "
                             f"of {self.frame_shape}")
        frames = np.ascontiguousarray(frames, dtype=self.dtype)
        self._videos[name] = [self._offset, frames.shape[0]]
        self._fh.write(frames.tobytes())
        self._offset += frames.shape[0]

    def close(self) -> None:
        self._fh.close()
        with open(self.path + ".json", "w") as fh:
            json.dump({"dtype": self.dtype.name,
                       "shape": list(self.frame_shape),
                       "videos": self._videos}, fh)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FramePack:
    """Read side: zero-copy mmap views per video or clip."""

    def __init__(self, path: str):
        with open(path + ".json") as fh:
            meta = json.load(fh)
        self.frame_shape = tuple(meta["shape"])
        self.dtype = np.dtype(meta["dtype"])
        self.videos: Dict[str, List[int]] = meta["videos"]
        n_total = sum(v[1] for v in self.videos.values())
        self._mm = np.memmap(path, dtype=self.dtype, mode="r",
                             shape=(n_total, *self.frame_shape))

    @property
    def names(self) -> List[str]:
        return sorted(self.videos)

    def length(self, name: str) -> int:
        return self.videos[name][1]

    def video(self, name: str) -> np.ndarray:
        off, n = self.videos[name]
        return self._mm[off: off + n]

    def clip(self, name: str, start: int, clip_length: int) -> np.ndarray:
        """(h, w, t*c) channel-stacked clip (ClipLoader's unpacked layout)."""
        off, n = self.videos[name]
        if not 0 <= start <= n - clip_length:
            raise IndexError(f"clip [{start}, {start + clip_length}) outside "
                             f"video {name!r} of {n} frames")
        frames = np.asarray(self._mm[off + start: off + start + clip_length])
        t, h, w, c = frames.shape
        return frames.transpose(1, 2, 0, 3).reshape(h, w, t * c)

    def gather(self, coords: Sequence[Tuple[str, int]], t: int) -> np.ndarray:
        """(b, t, h, w, c) clips starting at each (video, offset), in ONE
        fancy-index read off the mmap."""
        starts = np.asarray([self.videos[name][0] + off
                             for name, off in coords])
        idx = starts[:, None] + np.arange(t)[None, :]
        return self._mm[idx.reshape(-1)].reshape(len(coords), t,
                                                 *self.frame_shape)


def _normalize(rgb: np.ndarray) -> np.ndarray:
    return (rgb.astype(np.float32) / 255.0 - 0.5) / 0.5


class FramePackTrainSampler:
    """Random clip sampling over one FramePack (clip_Train_DS semantics):
    ``(b, h, w, t*c)`` batches, rgb normalized to [-1, 1] with
    ``normalize_rgb``."""

    def __init__(self, pack: FramePack, clip_length: int, seed: int = 2017,
                 normalize_rgb: bool = False):
        self.pack = pack
        self.clip_length = clip_length
        self.rng = np.random.default_rng(seed)
        self.normalize_rgb = normalize_rgb

    def sample(self) -> np.ndarray:
        names = self.pack.names
        name = names[self.rng.integers(len(names))]
        start = int(self.rng.integers(
            self.pack.length(name) - self.clip_length + 1))
        clip = self.pack.clip(name, start, self.clip_length)
        return _normalize(clip) if self.normalize_rgb else clip

    def batch(self, batch_size: int) -> np.ndarray:
        return np.stack([self.sample() for _ in range(batch_size)])


class FramePackTwoStreamSampler:
    """Frame-aligned rgb/op clip pairs over two FramePacks (the framepack
    counterpart of TwoStreamTrainSampler's aligned mode).  ``packed=True``
    returns frame-packed ``(b, t, h, w, c)`` batches, each stream one mmap
    gather, rgb as stored (uint8) unless ``normalize_rgb``; the train step
    normalizes and interleaves on the device.  The rng draw sequence is the
    same in both layouts."""

    def __init__(self, rgb_pack: FramePack, op_pack: FramePack,
                 clip_len_rgb: int = 5, clip_len_op: int = 4,
                 seed: int = 2017, normalize_rgb: bool = True,
                 packed: bool = False):
        self.rgb_pack, self.op_pack = rgb_pack, op_pack
        self.clip_len_rgb, self.clip_len_op = clip_len_rgb, clip_len_op
        self.rng = np.random.default_rng(seed)
        self.normalize_rgb = normalize_rgb
        self.packed = packed
        self.names = [n for n in rgb_pack.names if n in op_pack.videos]
        if not self.names:
            raise ValueError("no common sub-videos between the two packs")

    def _draw(self) -> Tuple[str, int]:
        name = self.names[self.rng.integers(len(self.names))]
        max_off = min(self.rgb_pack.length(name) - self.clip_len_rgb,
                      self.op_pack.length(name) - self.clip_len_op)
        return name, int(self.rng.integers(max_off + 1))

    def sample(self) -> Dict[str, np.ndarray]:
        name, off = self._draw()
        rgb = self.rgb_pack.clip(name, off, self.clip_len_rgb)
        return {"rgb": _normalize(rgb) if self.normalize_rgb else rgb,
                "op": self.op_pack.clip(name, off, self.clip_len_op)}

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        if not self.packed:
            samples = [self.sample() for _ in range(batch_size)]
            return {k: np.stack([s[k] for s in samples])
                    for k in ("rgb", "op")}
        coords = [self._draw() for _ in range(batch_size)]
        rgb = self.rgb_pack.gather(coords, self.clip_len_rgb)
        return {"rgb": _normalize(rgb) if self.normalize_rgb else rgb,
                "op": self.op_pack.gather(coords, self.clip_len_op)}


def pack_video_tree(frames_root: str, out_path: str, image_size: int = 256,
                    data_type: str = "rgb",
                    reproduce_flow_bug: bool = True) -> FramePack:
    """Offline packer: frame-folder tree -> framepack.  RGB packs as uint8
    (normalization stays on the device), flow as float32 after the loader's
    normalization."""
    index = VideoIndex(frames_root)
    size = (image_size, image_size)
    shape = (image_size, image_size, 3 if data_type == "rgb" else 2)
    dtype = "uint8" if data_type == "rgb" else "float32"
    with FramePackWriter(out_path, shape, dtype) as writer:
        for name in index.names:
            if data_type == "rgb":
                frames = np.stack([_decode_rgb(p, size)
                                   for p in index.videos[name]])
            else:
                frames = np.stack([load_flow(p, size, reproduce_flow_bug)
                                   for p in index.videos[name]])
            writer.add_video(name, frames)
    return FramePack(out_path)
