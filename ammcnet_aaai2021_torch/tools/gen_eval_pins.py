"""Generate per-video normalized-score pins from the released golden pickles.

Port of ``ammcnet_aaai2021_tpu/tools/gen_eval_pins.py`` (the port's own
copy, over the port's ``eval/scoring.py``).

Avenue's and ShanghaiTech's headline AUCs (0.866 / 0.737, README.md:54,56)
cannot be asserted offline — their public ground-truth annotation files are
not in this environment and writing annotations from memory would fabricate
the test.  What CAN be asserted offline is everything up to the GT join:
per-video min-max normalization, global normalization, fusion, smoothing.
This tool pins that pipeline per video: for each dataset it records each
video's frame count, the mean and std of its fused+smoothed scores, and an
ORDER-SENSITIVE digest (dot product with a fixed deterministic weight
vector) of the exact values `img_pred_fea_comm_single_auc` would hand to
roc_curve (eval_metric.py:405-427).  Mean/std alone are permutation
invariant — the smoothing step (eval/scoring.py one-step FIR,
eval_metric.py:427) is order sensitive, so a regression that permutes or
time-shifts scores within a video must fail the digest even though the
moments survive.

Run from the repo root on a checkout of the reference (its released
pickles lie under :data:`GOLDEN_LAYOUT` there):

    python -m ammcnet_aaai2021_torch.tools.gen_eval_pins \
        --reference_root <reference checkout> > pins.json
"""

from __future__ import annotations

import json
import os
import pickle
import sys

import numpy as np

GOLDEN_LAYOUT = ("Code/ammcnet_os/model_result_save/{d}/"
                 "img_pred_fea_comm_rgb_auc/save_pickle/{d}")
DATASETS = ("ped2", "avenue", "shanghaitech")


def digest_weights(n: int, video_index: int) -> np.ndarray:
    """Deterministic pseudo-random weights in [-0.5, 0.5): an affine map
    ``i -> (a*i + b) mod p`` with p=100003 prime, so all n <= p weights are
    DISTINCT — swapping any two frames with different scores changes the
    dot product.  Pure integer arithmetic: no dependence on any RNG
    library's stream-stability policy."""
    idx = np.arange(n, dtype=np.uint64)
    p = np.uint64(100003)
    w = (idx * np.uint64(2654435761)
         + np.uint64(video_index) * np.uint64(40503)) % p
    return w.astype(np.float64) / float(p) - 0.5


def per_video_pins(records: dict, lam: tuple) -> dict:
    from ..configs import DECIDABLE_IDX
    from ..eval.scoring import fuse_and_smooth, normalize_records

    img = normalize_records(records["rgb_img_pred_records"], DECIDABLE_IDX)
    fea = normalize_records(records["rgb_fea_comm_records"], DECIDABLE_IDX)
    fused = fuse_and_smooth(img, fea, lam[0], lam[1])
    lengths = [len(a) - DECIDABLE_IDX
               for a in records["rgb_img_pred_records"]]
    assert sum(lengths) == len(fused)
    out, start = [], 0
    for vi, n in enumerate(lengths):
        seg = fused[start:start + n].astype(np.float64)
        out.append({"frames": int(n),
                    "mean": round(float(np.mean(seg)), 12),
                    "std": round(float(np.std(seg)), 12),
                    "digest": round(float(seg @ digest_weights(n, vi)), 10)})
        start += n
    return {"videos": out}


def main(argv=None) -> dict:
    import argparse

    from ..configs import FUSION_LAMBDAS

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reference_root", default="reference",
                   help="checkout of the reference repository")
    args = p.parse_args(argv)
    pins = {}
    for d in DATASETS:
        path = os.path.join(args.reference_root, GOLDEN_LAYOUT.format(d=d))
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"the released golden pickle {path} is absent: this tool "
                "reads the reference's released score pickles")
        with open(path, "rb") as fh:
            records = pickle.load(fh)
        pins[d] = per_video_pins(records, FUSION_LAMBDAS[d])
    json.dump(pins, sys.stdout, indent=1)
    sys.stdout.write("\n")
    return pins


if __name__ == "__main__":
    main()
