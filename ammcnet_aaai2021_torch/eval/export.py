"""Serialized serving artifacts of the chunk scorer (``torch.export``).

Port of ``ammcnet_aaai2021_tpu/eval/export.py``.  The reference's deploy
story rebuilds the Python model zoo and loads a ``.pth`` per serving
process (``Code/run_helper/test_helper.py:503-518``).  Here the chunk
scorer (:class:`ChunkScorer`: window assembly, normalization, the
two-stream forward with its memory lookups, the per-frame PSNR and commit
records, the program ``run_test`` runs) is exported once with
``torch.export``, its weights inside, and a serving process calls
:func:`load_scorer`, which needs no model code and no checkpoint format:
only ``ops/library.py``, where the port's kernels (B1, the int8
convolutions) are registered ops that run inside the loaded graph.

Format: one file, the magic ``AMMCSCR1``, an 8-byte little-endian header
length, a JSON header (the scorer's geometry, ``platforms``, the torch
version), then the ``torch.export.save`` bytes of the ``ExportedProgram``.
``platforms`` is the device type the exported constants live on
(``["cuda"]`` or ``["cpu"]``); :func:`load_scorer` refuses another device
before it deserializes, and refuses the JAX package's artifacts (same
magic, StableHLO inside), whose header has ``jax_version`` and no
``torch_version``.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops import library  # noqa: F401  (registers the kernels' ops)
from ..utils.profiling import span

_MAGIC = b"AMMCSCR1"
KIND = "ammcnet_chunk_scorer"


def out_windows(frames: int, window_batch: int, clip_len_rgb: int = 5) -> int:
    """Window columns of a chunk's output: the windows of ``frames``
    rounded up to whole window batches."""
    n_windows = frames - clip_len_rgb + 1
    return -(-n_windows // window_batch) * window_batch


class ChunkScorer(nn.Module):
    """Every sliding window of a chunk of equal-length (bucket-padded)
    videos in one call: the counterpart of the JAX package's
    ``make_multi_video_scorer`` (``eval/infer.py:217-284``), kept to what
    the artifact needs.

    ``forward(rgbs, ops)`` takes a tuple of ``n_videos`` (T, h, w, 3) uint8
    videos and one of their (T-1, h, w, 2) flows and returns (n_videos, 4,
    nb * wb) float32, the rows (rgb_psnr, rgb_fea, op_psnr, op_fea) of the
    JAX ``score_chunk``.  Window starts are ``minimum(arange(nb * wb),
    n_windows - 1)`` (the padded tail repeats the last window); the videos
    and window batches unroll in Python, since an exported chunk has fixed
    shapes.  ``model`` is the generator (or the int8 forward) in eval
    mode.  A call is the span ``scorer.forward`` (``utils/profiling.py``),
    which records only while a profiler runs: an export, which runs none,
    traces no profiler op into the artifact."""

    def __init__(self, model: nn.Module, window_batch: int = 192,
                 clip_len_rgb: int = 5, clip_len_op: int = 4,
                 metric: str = "psnr", op_metric: Optional[str] = None,
                 reproduce_op_psnr_bug: bool = False):
        super().__init__()
        from .infer import _make_score_batch

        self.model = model
        self.window_batch = window_batch
        self.clip_len_rgb = clip_len_rgb
        self.score_batch = _make_score_batch(
            model, clip_len_rgb, clip_len_op, 3, 2, metric, op_metric,
            reproduce_op_psnr_bug)

    def forward(self, rgbs: Tuple[torch.Tensor, ...],
                ops: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        with span("scorer.forward"):
            return self._score(rgbs, ops)

    def _score(self, rgbs, ops) -> torch.Tensor:
        n_windows = rgbs[0].shape[0] - self.clip_len_rgb + 1
        wb = self.window_batch
        n_cols = out_windows(rgbs[0].shape[0], wb, self.clip_len_rgb)
        starts = torch.clamp_max(
            torch.arange(n_cols, device=rgbs[0].device), n_windows - 1)
        out = []
        for video_rgb, video_op in zip(rgbs, ops):
            rows = [self.score_batch(video_rgb, video_op, starts[i:i + wb])
                    for i in range(0, n_cols, wb)]
            out.append(torch.cat(rows, dim=1))  # (4, nb * wb)
        return torch.stack(out)


def chunk_example(n_videos: int, frames: int, size: int, device,
                  op_dtype: torch.dtype = torch.bfloat16, seed: int = 0
                  ) -> Tuple[Tuple[torch.Tensor, ...],
                             Tuple[torch.Tensor, ...]]:
    """A seeded chunk of the artifact's shapes (the JAX ``export_model
    --check`` chunk's distributions): uint8 frames uniform in [0, 255),
    flows normal(0, 0.02)."""
    g = torch.Generator().manual_seed(seed)
    rgbs = tuple(torch.randint(0, 255, (frames, size, size, 3), generator=g,
                               dtype=torch.uint8).to(device)
                 for _ in range(n_videos))
    ops = tuple((torch.randn((frames - 1, size, size, 2), generator=g)
                 * 0.02).to(device=device, dtype=op_dtype)
                for _ in range(n_videos))
    return rgbs, ops


def export_scorer(model: nn.Module, *, n_videos: int, frames: int, size: int,
                  window_batch: int = 192,
                  extra_meta: Optional[Dict[str, Any]] = None) -> bytes:
    """Export the chunk scorer over ``model`` as one self-contained
    artifact, on the device ``model``'s parameters and buffers live on.

    The weights are inside the artifact: a serving artifact pins its
    weights.  ``model`` may be the int8 forward
    (``models/quantized.py``), whose convolutions then run as the int8
    kernels' ops in the artifact.  The flows' dtype is ``model.dtype`` (the
    dtype ``score_dataset`` uploads them in), bf16 by default."""
    device = next(model.buffers()).device
    op_dtype = getattr(model, "dtype", torch.bfloat16)
    scorer = ChunkScorer(model, window_batch=window_batch).eval()
    rgbs, ops = chunk_example(n_videos, frames, size, device, op_dtype)
    with torch.no_grad():
        exported = torch.export.export(scorer, (rgbs, ops))
    # the example chunk is no part of the artifact (175 MB at ped2's shape)
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    header = {
        "kind": KIND,
        "n_videos": n_videos, "frames": frames, "size": size,
        "window_batch": window_batch,
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "op_dtype": str(op_dtype).replace("torch.", ""),
        "out_shape": [n_videos, 4, out_windows(frames, window_batch)],
    }
    header.update(extra_meta or {})
    hdr = json.dumps(header).encode()
    return _MAGIC + struct.pack("<Q", len(hdr)) + hdr + buf.getvalue()


def save_scorer(path: str, model: nn.Module, **kw) -> Dict[str, Any]:
    blob = export_scorer(model, **kw)
    with open(path, "wb") as f:
        f.write(blob)
    return read_header(path)


def _check_magic(path: str, magic: bytes) -> None:
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an ammcnet scorer artifact "
                         f"(magic {magic!r})")


def read_header(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        _check_magic(path, f.read(len(_MAGIC)))
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


def load_scorer(path: str, device=None
                ) -> Tuple[nn.Module, Dict[str, Any]]:
    """Load a serving artifact: returns ``(score_chunk, header)``, where
    ``score_chunk(rgbs, ops)`` takes tuples of ``header["n_videos"]`` videos
    on ``device`` (default ``cuda``) of the header's shapes and returns
    (n_videos, 4, nb * wb) float32 records.

    Raises ``ValueError`` on a file without the magic, on a JAX artifact,
    and on a ``device`` whose type the header's ``platforms`` lacks (before
    deserializing)."""
    device = torch.device(device if device is not None else "cuda")
    with open(path, "rb") as f:
        blob = f.read()
    _check_magic(path, blob[:len(_MAGIC)])
    (n,) = struct.unpack("<Q", blob[8:16])
    header, start = json.loads(blob[16:16 + n]), 16 + n
    if "torch_version" not in header and "jax_version" in header:
        raise ValueError(
            f"{path}: a JAX package artifact (jax {header['jax_version']}, "
            "StableHLO): the port cannot run it; export the checkpoint with "
            "the port's runners.export_model")
    plats = [p.lower() for p in header.get("platforms", [])]
    if device.type not in plats:
        raise ValueError(
            f"artifact built for platforms {plats} cannot serve on "
            f"{device.type!r}: re-export it on a {device.type} device")
    exported = torch.export.load(io.BytesIO(blob[start:]))
    return exported.module(), header

