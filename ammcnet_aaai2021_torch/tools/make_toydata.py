"""Synthetic toy dataset generator.

Port of ``ammcnet_aaai2021_tpu/tools/make_toydata.py``: with
``frame_format="jpg"`` (cv2 needed) the same files byte for byte; with
``frame_format="npy"`` (no cv2: the card's machine has none) each frame's
RGB pixel array as ``NNN.npy``, which both the port's file loader and the
JAX package's read (``data/datasets.py``).

The reference's eval layer has a 'toydata' hook (eval_metric.py:50-51,163-179:
json GT ``{video: {length, gt: [[s, e], ...]}}``) but no generator was
released.  This builds a complete miniature dataset in the reference's
directory layout so the full train/test path can be driven end-to-end with
no real surveillance data:

    <root>/toydata/{training,testing}/frames/<video>/NNN.jpg (or .npy)
    <root>/toydata/{training,testing}/flows/<video>/NNN.flo
    <root>/toydata/toydata.json

"Normal" motion is a square gliding at constant velocity; anomalous spans
teleport the square randomly (large unpredictable motion), so a future-frame
predictor trained on normal clips scores them poorly.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..data.flo import write_flo


def _draw_frame(size: int, x: float, y: float, sq: int,
                color: Tuple[int, int, int],
                glyph: str = "square") -> np.ndarray:
    img = np.full((size, size, 3), 32, np.uint8)
    xi, yi = int(x) % (size - sq), int(y) % (size - sq)
    img[yi : yi + sq, xi : xi + sq] = color
    if glyph == "hollow":
        # same bounding box, same color, interior carved back to the
        # background: a SHAPE never seen in training
        t = max(2, sq // 4)
        img[yi + t : yi + sq - t, xi + t : xi + sq - t] = 32
    return img


def make_toydata(
    root: str,
    num_train_videos: int = 2,
    num_test_videos: int = 2,
    frames_per_video: int = 24,
    image_size: int = 64,
    anomaly_span: Tuple[int, int] = (10, 16),
    seed: int = 7,
    hard: bool = False,
    anomaly: str = None,
    frame_format: str = "jpg",
) -> str:
    """Writes the dataset; returns the toydata root dir.

    ``anomaly`` selects what the testing-span anomaly IS (``hard=True`` is
    back-compat for ``anomaly="direction"``):

    - ``"teleport"`` (default): the square jumps to a random position —
      a huge, easy prediction error (AUC saturates >=0.985 after a few
      training steps — PERF.md round-3 recipe tables).
    - ``"direction"``: appearance-normal and SPEED-normal but
      direction-anomalous — the square re-draws its heading every
      anomalous frame (a drunk walk at the same speed).  Prediction error
      is bounded by ~2*speed*sin(dtheta/2) pixels, so frame-level AUC does
      not saturate and discriminates training quality.
    - ``"appearance"``: motion stays PERFECTLY normal (constant velocity,
      bounce) but the glyph changes to a hollow square of the same color —
      the toy analogue of ped2's bikes/cars among pedestrians.  A
      future-frame predictor can copy the novel appearance from its input
      window (prediction stays easy; PSNR barely fires), but the
      bottleneck features sit OFF the training manifold, which is exactly
      the signal the memory-commit channel (fea_comm) claims to carry
      (AAAI title; ``Code/main/eval_metric.py:426`` fusion).  Built to
      isolate that channel in a model WE train, mirroring the released
      ped2 checkpoint's fea-only 0.64 AUC (PERF.md round 4).

    ``frame_format``: ``"jpg"`` (cv2's JPEG of each frame) or ``"npy"``
    (the frame's uint8 RGB array, no cv2).
    """
    if frame_format not in ("jpg", "npy"):
        raise ValueError(f"unknown frame_format {frame_format!r} (jpg | npy)")
    if frame_format == "jpg":
        import cv2
    if anomaly is None:
        anomaly = "direction" if hard else "teleport"
    if anomaly not in ("teleport", "direction", "appearance"):
        raise ValueError(f"unknown anomaly mode {anomaly!r}")
    # direction/appearance modes need bounce motion (a modulo wrap
    # teleports the square across the border during NORMAL frames, which
    # would out-score the subtle anomalies and corrupt AUC); teleport mode
    # keeps the original wrap so its generated bytes (and every existing
    # test) are unchanged
    bounce = anomaly in ("direction", "appearance")
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "toydata")
    gt_json: Dict[str, Dict] = {}

    for split, num_videos in (("training", num_train_videos),
                              ("testing", num_test_videos)):
        for v in range(num_videos):
            name = f"{v + 1:02d}"
            fdir = os.path.join(base, split, "frames", name)
            odir = os.path.join(base, split, "flows", name)
            os.makedirs(fdir, exist_ok=True)
            os.makedirs(odir, exist_ok=True)
            sq = 12 if image_size >= 64 else 4
            x, y = rng.uniform(0, image_size - sq, 2)
            vx, vy = rng.uniform(1.0, 2.5, 2)
            color = tuple(int(c) for c in rng.integers(128, 256, 3))
            positions: List[Tuple[float, float]] = []
            for t in range(frames_per_video):
                anomalous = (split == "testing"
                             and anomaly_span[0] <= t < anomaly_span[1])
                if anomalous and anomaly == "direction":
                    # same speed, random heading each frame: the square
                    # looks normal and moves a normal distance — only the
                    # DIRECTION is unpredictable
                    speed = float(np.hypot(vx, vy))
                    theta = rng.uniform(0, 2 * np.pi)
                    x = x + speed * np.cos(theta)
                    y = y + speed * np.sin(theta)
                elif anomalous and anomaly == "teleport":
                    x, y = rng.uniform(0, image_size - sq, 2)
                else:
                    # normal motion — including appearance-mode anomalies,
                    # whose trajectory stays perfectly predictable
                    x, y = x + vx, y + vy
                if bounce:
                    hi = image_size - sq - 1e-3  # strictly inside: x == hi
                    # exactly would alias to 0 through the modulo below
                    if not (0 <= x <= hi):
                        x = float(np.clip(x, 0, hi))
                        vx = -vx
                    if not (0 <= y <= hi):
                        y = float(np.clip(y, 0, hi))
                        vy = -vy
                positions.append((x % (image_size - sq), y % (image_size - sq)))
                glyph = ("hollow" if anomalous and anomaly == "appearance"
                         else "square")
                frame = _draw_frame(image_size, x, y, sq, color, glyph)
                if frame_format == "npy":
                    np.save(os.path.join(fdir, f"{t:03d}.npy"), frame)
                else:
                    cv2.imwrite(os.path.join(fdir, f"{t:03d}.jpg"),
                                cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            # flows between consecutive frames: constant (vx, vy) on normal
            # steps, the teleport delta on anomalous ones
            for t in range(frames_per_video - 1):
                dx = positions[t + 1][0] - positions[t][0]
                dy = positions[t + 1][1] - positions[t][1]
                flow = np.zeros((image_size, image_size, 2), np.float32)
                flow[..., 0] = dx
                flow[..., 1] = dy
                write_flo(os.path.join(odir, f"{t:03d}.flo"), flow)
            if split == "testing":
                gt_json[name] = {
                    "length": frames_per_video,
                    "gt": [[anomaly_span[0], anomaly_span[1] - 1]],
                }

    with open(os.path.join(base, "toydata.json"), "w") as fh:
        json.dump(gt_json, fh, indent=2)
    return base


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--hard", action="store_true",
                   help="direction-anomalous (non-saturating) anomalies "
                        "instead of teleports (alias for "
                        "--anomaly direction)")
    p.add_argument("--anomaly", default=None,
                   choices=["teleport", "direction", "appearance"],
                   help="what the testing anomaly is; 'appearance' keeps "
                        "motion perfectly normal and swaps the glyph — "
                        "the memory-channel (fea_comm) probe")
    p.add_argument("--train_videos", type=int, default=2)
    p.add_argument("--test_videos", type=int, default=2)
    p.add_argument("--seed", type=int, default=7,
                   help="world seed (trajectories, colors, anomaly draws) — "
                        "vary for world-replication studies (PERF.md)")
    p.add_argument("--frame_format", default="jpg", choices=["jpg", "npy"],
                   help="JPEG frames (cv2) or .npy pixel arrays (no cv2)")
    args = p.parse_args()
    out = make_toydata(args.root, num_train_videos=args.train_videos,
                       num_test_videos=args.test_videos,
                       frames_per_video=args.frames,
                       image_size=args.size, seed=args.seed, hard=args.hard,
                       anomaly=args.anomaly, frame_format=args.frame_format)
    print(f"toydata written to {out}")
