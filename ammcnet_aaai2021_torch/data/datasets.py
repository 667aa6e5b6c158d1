"""File-tree test data: frame-folder scanning and per-frame decoding.

The port's copy of the scoring path's part of the JAX package's data
layer (reference ``Code/dataset/two_stream_dataset.py``).

Preprocessing parity (two_stream_dataset.py:72-98):
  RGB: decode (BGR) -> BGR2RGB -> cv2.resize to 256x256 (uint8, INTER_LINEAR).
       The [-1, 1] normalization runs on the device (eval/infer.py).
  Flow: read .flo -> cv2.resize -> normalize.  The reference overwrites the
       v channel (ch0 = u/h, then ch1 = ch0/w = u/(h*w)) — reproduced behind
       ``reproduce_bug`` (checkpoint parity); the fixed loader uses
       (u/w, v/h).

``cv2`` is imported only for JPEG decoding and resizing: ``.npy`` frames at
native size and ``.flo``/``.npy`` flows need nothing beyond numpy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .flo import read_flo

_RGB_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
_FLO_EXTS = (".flo",)
_NPY_EXTS = (".npy",)


def _decode_rgb(path: str, size: Tuple[int, int]) -> np.ndarray:
    """uint8 RGB (h, w, 3) resized; cv2 for parity with the reference."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        import cv2

        img = cv2.imread(path)  # BGR uint8
        if img is None:
            raise FileNotFoundError(path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.shape[:2] != size:
        import cv2

        img = cv2.resize(img, (size[1], size[0]))
    return img


def load_flow(path: str, size: Tuple[int, int],
              reproduce_bug: bool = True) -> np.ndarray:
    """(h, w, 2) float32 normalized flow field."""
    if path.endswith(".npy"):
        flow = np.load(path).astype(np.float32)
    else:
        flow = read_flo(path)
    if flow.shape[:2] != size:
        import cv2

        flow = cv2.resize(flow, (size[1], size[0]))
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
