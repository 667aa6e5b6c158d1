"""AUC sweep over the score-fusion weight lam_fea_comm.

Port of ``ammcnet_aaai2021_tpu/tools/lam_sweep.py`` (the port's own copy;
it reads the port's score pickles, whose schema is the JAX package's).

Answers the question the reference's own thesis poses (AAAI title,
the reference's ``README.md:1-3``): does the memory-commit channel — the
distance between a window's bottleneck features and the learned codebook of
normal patterns — carry anomaly signal COMPLEMENTARY to prediction PSNR?
The reference fuses ``score = (1-l1)*psnr + l1*(1-fea_comm)``
(``Code/main/eval_metric.py:426``) with per-dataset l1 in 0.01-0.13
(``Code/run_helper/test_helper.py:565-569``), but never reports the
per-channel ablation.  This tool evaluates the SAME score pickle at a grid
of lam_fea_comm values (0 = PSNR-only, 1 = fea_comm-only) so the channel's
contribution is isolated without re-running inference.

Usage:
  python -m ammcnet_aaai2021_torch.tools.lam_sweep \
      --data_dir /tmp/hardtoy2 \
      label1=/path/to/save_pickle/toydata label2=...

Prints one table row per (pickle, lam) and a per-pickle summary of
psnr-only vs fused-best vs fea-only.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..eval.gt import GroundTruthLoader
from ..eval.scoring import img_pred_fea_comm_auc, load_result_pickle

DEFAULT_LAMS = (0.0, 0.01, 0.04, 0.1, 0.13, 0.3, 0.5, 0.7, 1.0)


def sweep_pickle(
    records: Dict,
    gt: Sequence[np.ndarray],
    lams: Sequence[float] = DEFAULT_LAMS,
    lam_smooth: float = 0.55,
) -> List[Tuple[float, float]]:
    """[(lam_fea_comm, auc), ...] over the grid, lam_smooth held fixed."""
    return [(l1, img_pred_fea_comm_auc(records, gt, (l1, lam_smooth)))
            for l1 in lams]


def fea_comm_stats(records: Dict) -> Dict[str, float]:
    """Per-video variability of the commit-distance records — a constant
    fea_comm channel would make every lam>0 row pure noise (the reference's
    batch-replicated records were near-constant within a batch,
    test_helper.py:446)."""
    feas = [np.asarray(r, dtype=np.float64)
            for r in records["rgb_fea_comm_records"]]
    rel_span = [float((f.max() - f.min()) / (abs(f.mean()) + 1e-12))
                for f in feas]
    return {
        "videos": len(feas),
        "mean": float(np.mean([f.mean() for f in feas])),
        "min_rel_span": min(rel_span),
        "max_rel_span": max(rel_span),
    }


def run_sweep(
    items: Sequence[Tuple[str, str]],
    data_dir: str,
    lams: Sequence[float] = DEFAULT_LAMS,
    lam_smooth: Optional[float] = None,
) -> Dict[str, Dict]:
    """items: [(label, pickle_path)].  Returns {label: {lam: auc, ...}}."""
    out: Dict[str, Dict] = {}
    loader = GroundTruthLoader(data_dir)
    for label, path in items:
        records = load_result_pickle(path)
        ls = lam_smooth
        if ls is None:
            from ..configs import FUSION_LAMBDAS

            # same loud policy as run_test.py:246 — an unknown dataset must
            # not silently inherit ped2's smoothing weight
            if records["dataset"] not in FUSION_LAMBDAS:
                raise KeyError(
                    f"no FUSION_LAMBDAS preset for dataset "
                    f"{records['dataset']!r} ({label}); pass --lam_smooth "
                    f"explicitly")
            ls = FUSION_LAMBDAS[records["dataset"]][1]
        lengths = [len(a) for a in records["rgb_img_pred_records"]]
        gt = loader(records["dataset"], video_lengths=lengths)
        rows = sweep_pickle(records, gt, lams, ls)
        aucs = dict(rows)
        best_lam, best_auc = max(rows, key=lambda r: r[1])
        out[label] = {
            "aucs": aucs,
            "psnr_only": aucs.get(0.0),
            "fea_only": aucs.get(1.0),
            "best": (best_lam, best_auc),
            "lam_smooth": ls,
            "fea_stats": fea_comm_stats(records),
        }
    return out


def main(argv=None) -> Dict[str, Dict]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("pickles", nargs="+",
                   help="label=/path/to/save_pickle/<dataset> entries")
    p.add_argument("--data_dir", required=True,
                   help="GT root (the dataset's data_dir)")
    p.add_argument("--lams", default=",".join(str(x) for x in DEFAULT_LAMS))
    p.add_argument("--lam_smooth", type=float, default=None,
                   help="fixed smoothing weight (default: dataset preset)")
    args = p.parse_args(argv)

    items = []
    for entry in args.pickles:
        label, _, path = entry.partition("=")
        items.append((label, path) if path else (entry, entry))
    lams = tuple(float(x) for x in args.lams.split(","))
    results = run_sweep(items, args.data_dir, lams, args.lam_smooth)

    header = "| run | " + " | ".join(f"l1={l1:g}" for l1 in lams) + " |"
    print(header)
    print("|" + "---|" * (len(lams) + 1))
    for label, res in results.items():
        row = " | ".join(f"{res['aucs'][l1]:.4f}" +
                         ("*" if l1 == res["best"][0] else "")
                         for l1 in lams)
        print(f"| {label} | {row} |")
    print()
    for label, res in results.items():
        s = res["fea_stats"]
        print(f"{label}: psnr-only {res['psnr_only']:.4f}  "
              f"fea-only {res['fea_only']:.4f}  "
              f"best {res['best'][1]:.4f} @ l1={res['best'][0]:g}  "
              f"(lam_smooth={res['lam_smooth']:g}; fea rel-span "
              f"{s['min_rel_span']:.3f}-{s['max_rel_span']:.3f} "
              f"over {s['videos']} videos)")
    return results


if __name__ == "__main__":
    main()
