"""Middlebury ``.flo`` optical-flow file IO.

Rebuild of the reference reader ``Code/utils/flowlib.py:589-611``: little-
endian float32, magic 202021.25 ("PIEH"), header (magic, width, height),
body (h, w, 2) interleaved u/v.  Vectorized via a single ``np.fromfile``.
"""

from __future__ import annotations

import numpy as np

FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file -> float32 array of shape (h, w, 2)."""
    with open(path, "rb") as fh:
        header = np.frombuffer(fh.read(12), dtype="<f4, <i4, <i4", count=1)[0]
        magic, width, height = float(header[0]), int(header[1]), int(header[2])
        if abs(magic - FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        data = np.frombuffer(fh.read(width * height * 2 * 4), dtype="<f4")
    if data.size != width * height * 2:
        raise ValueError(f"{path}: truncated .flo body")
    return data.reshape(height, width, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write a (h, w, 2) float32 array as .flo (for fixtures/tests)."""
    flow = np.asarray(flow, dtype="<f4")
    assert flow.ndim == 3 and flow.shape[2] == 2, flow.shape
    h, w = flow.shape[:2]
    with open(path, "wb") as fh:
        np.array([FLO_MAGIC], dtype="<f4").tofile(fh)
        np.array([w, h], dtype="<i4").tofile(fh)
        flow.tofile(fh)
