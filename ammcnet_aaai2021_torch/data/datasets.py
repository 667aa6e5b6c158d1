"""File-tree data: frame-folder scanning, per-frame decoding, and the
training samplers.

The port's copy of the scoring and training paths' part of the JAX
package's data layer (reference ``Code/dataset/two_stream_dataset.py``):
:class:`VideoIndex`, the decoders, :class:`FrameCache`, :class:`ClipLoader`,
:class:`TwoStreamTrainSampler` (stage 2), :class:`SingleStreamTrainSampler`
(stage 1) and :func:`parallel_batches`, in numpy.

Preprocessing parity (two_stream_dataset.py:72-98):
  RGB: decode (BGR) -> BGR2RGB -> cv2.resize to 256x256 (uint8, INTER_LINEAR).
       The [-1, 1] normalization runs on the device (eval/infer.py).
  Flow: read .flo -> cv2.resize -> normalize.  The reference overwrites the
       v channel (ch0 = u/h, then ch1 = ch0/w = u/(h*w)) — reproduced behind
       ``reproduce_bug`` (checkpoint parity); the fixed loader uses
       (u/w, v/h).

``cv2`` is imported only for JPEG decoding and resizing: ``.npy`` frames at
native size and ``.flo``/``.npy`` flows need nothing beyond numpy.  Where
cv2 is missing (the H100 machine has none), a file that needs it raises
``ImportError`` pointing at ``--native_loader`` (``data/native.py``), which
decodes and resizes without it.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .flo import read_flo

_RGB_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
_FLO_EXTS = (".flo",)
_NPY_EXTS = (".npy",)


def _cv2(path: str):
    """cv2, or ``ImportError`` naming it and the loader that needs none."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{path} needs cv2 (JPEG decoding or a resize), which is not "
            "installed; decode with the native loader instead (run_test "
            "--native_loader, data/native.py)") from e
    return cv2


def _decode_rgb(path: str, size: Tuple[int, int]) -> np.ndarray:
    """uint8 RGB (h, w, 3) resized; cv2 for parity with the reference."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        cv2 = _cv2(path)
        img = cv2.imread(path)  # BGR uint8
        if img is None:
            raise FileNotFoundError(path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.shape[:2] != size:
        img = _cv2(path).resize(img, (size[1], size[0]))
    return img


def load_flow(path: str, size: Tuple[int, int],
              reproduce_bug: bool = True) -> np.ndarray:
    """(h, w, 2) float32 normalized flow field."""
    if path.endswith(".npy"):
        flow = np.load(path).astype(np.float32)
    else:
        flow = read_flo(path)
    if flow.shape[:2] != size:
        flow = _cv2(path).resize(flow, (size[1], size[0]))
    h, w = size
    out = np.empty_like(flow)
    if reproduce_bug:
        # two_stream_dataset.py:94-95 — ch0 = u/h, ch1 = ch0/w = u/(h*w).
        out[:, :, 0] = flow[:, :, 0] / h
        out[:, :, 1] = out[:, :, 0] / w
    else:
        out[:, :, 0] = flow[:, :, 0] / w
        out[:, :, 1] = flow[:, :, 1] / h
    return out


@dataclass
class VideoIndex:
    """Scan of one frames-root: videos[name] = sorted absolute frame paths.

    Mirrors the reference's ``videos[sub]['frame'/'length']`` dict
    (two_stream_dataset.py setup loops).
    """

    root: str
    exts: Sequence[str] = _RGB_EXTS + _FLO_EXTS + _NPY_EXTS
    videos: Dict[str, List[str]] = field(default_factory=dict)

    def __post_init__(self):
        for sub in sorted(os.listdir(self.root)):
            folder = os.path.join(self.root, sub)
            if not os.path.isdir(folder):
                continue
            frames = sorted(
                os.path.join(folder, f) for f in os.listdir(folder)
                if f.lower().endswith(tuple(self.exts))
            )
            if frames:
                self.videos[sub] = frames

    @property
    def names(self) -> List[str]:
        return sorted(self.videos)

    def length(self, name: str) -> int:
        return len(self.videos[name])


class FrameCache:
    """Thread-safe byte-capped LRU of decoded (resized) frames.

    Training revisits every frame ``clip_len x epochs`` times; caching frames
    after decode and resize (uint8 rgb / float32 flow) turns steady-state
    clip assembly into copies.  Entries are frozen (``writeable=False``) so a
    hit can be shared across loader threads."""

    def __init__(self, capacity_bytes: int = 2 << 30):
        self._d: "OrderedDict[object, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self._bytes = 0
        self.capacity = int(capacity_bytes)
        self.hits = 0
        self.misses = 0

    def get(self, key, load):
        with self._lock:
            arr = self._d.get(key)
            if arr is not None:
                self._d.move_to_end(key)
                self.hits += 1
                return arr
        arr = load()  # decode outside the lock (a rare concurrent miss
        arr.flags.writeable = False  # just duplicates one decode)
        with self._lock:
            self.misses += 1
            if key not in self._d:
                self._d[key] = arr
                self._bytes += arr.nbytes
                while self._bytes > self.capacity and self._d:
                    _, old = self._d.popitem(last=False)
                    self._bytes -= old.nbytes
        return arr


class ClipLoader:
    """Assembles clips from frame paths.

    ``cache``: optional :class:`FrameCache` shared across loaders/threads.
    ``normalize_rgb=False`` returns rgb clips as raw uint8 (the train step
    normalizes on the device).  ``packed=True`` emits ``(t, h, w, c)`` frame
    stacks (contiguous per-frame copies; the step interleaves time into
    channels) instead of the channel-interleaved ``(h, w, t*c)``."""

    def __init__(self, data_type: str, image_size: int = 256,
                 reproduce_flow_bug: bool = True,
                 cache: Optional[FrameCache] = None,
                 normalize_rgb: bool = True, packed: bool = False):
        if data_type not in ("rgb", "op"):
            raise ValueError(f"data_type must be rgb or op, got {data_type!r}")
        self.data_type = data_type
        self.size = (image_size, image_size)
        self.reproduce_flow_bug = reproduce_flow_bug
        self.cache = cache
        self.normalize_rgb = normalize_rgb
        self.packed = packed

    @property
    def channels(self) -> int:
        return 3 if self.data_type == "rgb" else 2

    def clip_dtype(self):
        if self.data_type == "rgb" and not self.normalize_rgb:
            return np.uint8
        return np.float32

    def _frame(self, path: str) -> np.ndarray:
        if self.data_type == "rgb":
            if self.cache is None:
                return _decode_rgb(path, self.size)
            return self.cache.get((path, self.size),
                                  lambda: _decode_rgb(path, self.size))
        if self.cache is None:
            return load_flow(path, self.size, self.reproduce_flow_bug)
        return self.cache.get(
            (path, self.size, self.reproduce_flow_bug),
            lambda: load_flow(path, self.size, self.reproduce_flow_bug))

    def clip_shape(self, t: int) -> Tuple[int, ...]:
        h, w = self.size
        if self.packed:
            return (t, h, w, self.channels)
        return (h, w, t * self.channels)

    def load_clip_into(self, paths: Sequence[str], out: np.ndarray) -> None:
        """Assemble the clip directly into ``out`` (:meth:`clip_shape`)."""
        if self.packed:
            if self.data_type == "rgb" and self.normalize_rgb:
                for i, p in enumerate(paths):
                    np.divide(self._frame(p), 255.0, out=out[i])
                out -= 0.5
                out /= 0.5
                return
            for i, p in enumerate(paths):
                out[i] = self._frame(p)
            return
        c = self.channels
        h, w = self.size
        if self.data_type == "rgb" and self.normalize_rgb:
            tmp = np.empty((h, w, len(paths) * c), np.uint8)
            for i, p in enumerate(paths):
                tmp[..., i * c:(i + 1) * c] = self._frame(p)
            # the op order of the reference's rgb_to_tensor, (x/255 - .5)/.5
            np.divide(tmp, 255.0, out=out)
            out -= 0.5
            out /= 0.5
            return
        for i, p in enumerate(paths):
            out[..., i * c:(i + 1) * c] = self._frame(p)

    def load_clip(self, paths: Sequence[str]) -> np.ndarray:
        out = np.empty(self.clip_shape(len(paths)), self.clip_dtype())
        self.load_clip_into(paths, out)
        return out


class TwoStreamTrainSampler:
    """Random clip pairs for stage-2 training.

    ``aligned=True`` draws one (video, offset) and slices both modalities
    (a T-frame video has T-1 flow fields; offset o pairs rgb frames
    [o, o+t_rgb) with flows [o, o+t_op)).  ``aligned=False`` reproduces the
    reference's independent sampling (two_stream_dataset.py:466-470)."""

    def __init__(self, rgb_index: VideoIndex, op_index: VideoIndex,
                 clip_len_rgb: int = 5, clip_len_op: int = 4,
                 loader_rgb: Optional[ClipLoader] = None,
                 loader_op: Optional[ClipLoader] = None,
                 aligned: bool = True, seed: int = 2017,
                 image_size: int = 256, reproduce_flow_bug: bool = True,
                 cache_bytes: int = 2 << 30, normalize_rgb: bool = True,
                 packed: bool = False):
        self.rgb_index, self.op_index = rgb_index, op_index
        self.clip_len_rgb, self.clip_len_op = clip_len_rgb, clip_len_op
        cache = FrameCache(cache_bytes) if cache_bytes else None
        self.loader_rgb = loader_rgb or ClipLoader(
            "rgb", image_size, cache=cache, normalize_rgb=normalize_rgb,
            packed=packed)
        self.loader_op = loader_op or ClipLoader(
            "op", image_size, reproduce_flow_bug, cache=cache, packed=packed)
        self.aligned = aligned
        # the reference shares a module-level RandomState(2017)
        # (two_stream_dataset.py:31); this one is per sampler
        self.rng = np.random.default_rng(seed)
        self.names = [n for n in rgb_index.names if n in op_index.videos]
        if not self.names:
            raise ValueError("no common sub-videos between the rgb and op roots")

    def _draw_one(self, index: VideoIndex, clip_len: int):
        name = self.names[self.rng.integers(len(self.names))]
        offset = int(self.rng.integers(index.length(name) - clip_len + 1))
        return name, offset

    def draw(self):
        """One sample's (video, offset) coordinates, drawn rng-sequentially
        so a seed gives the same clips however many threads assemble them."""
        if not self.aligned:
            return (self._draw_one(self.rgb_index, self.clip_len_rgb),
                    self._draw_one(self.op_index, self.clip_len_op))
        name = self.names[self.rng.integers(len(self.names))]
        max_off = min(self.rgb_index.length(name) - self.clip_len_rgb,
                      self.op_index.length(name) - self.clip_len_op)
        return name, int(self.rng.integers(max_off + 1))

    def _paths(self, coord):
        if not self.aligned:
            (rgb_name, rgb_off), (op_name, op_off) = coord
        else:
            rgb_name = op_name = coord[0]
            rgb_off = op_off = coord[1]
        return (self.rgb_index.videos[rgb_name]
                [rgb_off: rgb_off + self.clip_len_rgb],
                self.op_index.videos[op_name]
                [op_off: op_off + self.clip_len_op])

    def alloc_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        return {
            "rgb": np.empty(
                (batch_size, *self.loader_rgb.clip_shape(self.clip_len_rgb)),
                self.loader_rgb.clip_dtype()),
            "op": np.empty(
                (batch_size, *self.loader_op.clip_shape(self.clip_len_op)),
                np.float32),
        }

    def load_into(self, coord, out: Dict[str, np.ndarray], i: int) -> None:
        """Assemble one drawn sample into batch row ``i`` (thread-safe)."""
        rgb_paths, op_paths = self._paths(coord)
        self.loader_rgb.load_clip_into(rgb_paths, out["rgb"][i])
        self.loader_op.load_clip_into(op_paths, out["op"][i])

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        out = self.alloc_batch(batch_size)
        for i in range(batch_size):
            self.load_into(self.draw(), out, i)
        return out


class SingleStreamTrainSampler:
    """Stage-1 random clips of one modality (reference clip_Train_DS): a
    video, then an offset, drawn from ``default_rng(seed)`` in the JAX
    sampler's order.  With a ``packed`` loader a batch is ``(b, t, h, w,
    c)``."""

    def __init__(self, index: VideoIndex, clip_length: int, loader: ClipLoader,
                 seed: int = 2017):
        self.index = index
        self.clip_length = clip_length
        self.loader = loader
        self.rng = np.random.default_rng(seed)

    def draw(self) -> Tuple[str, int]:
        names = self.index.names
        name = names[self.rng.integers(len(names))]
        offset = int(self.rng.integers(
            self.index.length(name) - self.clip_length + 1))
        return name, offset

    def alloc_batch(self, batch_size: int) -> np.ndarray:
        return np.empty(
            (batch_size, *self.loader.clip_shape(self.clip_length)),
            self.loader.clip_dtype())

    def load_into(self, coord: Tuple[str, int], out: np.ndarray,
                  i: int) -> None:
        """Assemble one drawn clip into batch row ``i`` (thread-safe)."""
        name, offset = coord
        self.loader.load_clip_into(
            self.index.videos[name][offset: offset + self.clip_length],
            out[i])

    def batch(self, batch_size: int) -> np.ndarray:
        out = self.alloc_batch(batch_size)
        for i in range(batch_size):
            self.load_into(self.draw(), out, i)
        return out


def parallel_batches(sampler, batch_size: int, num_workers: int = 8,
                     depth: int = 4) -> Iterator:
    """Infinite training-batch iterator with parallel clip assembly.

    Coordinates are drawn rng-sequentially on the calling thread (a seed
    gives the same clip sequence), decoding fans out on a thread pool
    (numpy and cv2 release the GIL), and ``depth`` whole batches stay in
    flight — the threads that replace the reference's
    ``DataLoader(num_workers=16)`` (train_helper.py:230-232).  Closing the
    iterator shuts the pool down."""
    pool = ThreadPoolExecutor(max_workers=num_workers)

    def submit():
        out = sampler.alloc_batch(batch_size)
        futures = [pool.submit(sampler.load_into, sampler.draw(), out, i)
                   for i in range(batch_size)]
        return out, futures

    try:
        inflight = deque(submit() for _ in range(max(1, depth)))
        while True:
            out, futures = inflight.popleft()
            for f in futures:
                f.result()
            inflight.append(submit())
            yield out
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
