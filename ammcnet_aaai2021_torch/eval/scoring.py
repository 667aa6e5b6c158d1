"""Anomaly-score fusion and frame-level ROC-AUC.

Rebuild of the scoring tail of the reference pipeline
(``Code/main/eval_metric.py:382-454``):

1. per-video min-max normalization of the PSNR records and the memory-commit
   ("fea_comm") records, frames before ``DECIDABLE_IDX`` dropped,
2. global min-max normalization across the concatenated test set,
3. fusion ``score = (1-l1) * psnr + l1 * (1 - fea_comm)``,
4. one-step (non-recursive) temporal smoothing
   ``s'[i] = (1-l2) * s[i-1] + l2 * s[i]`` — the reference's list
   comprehension reads the ORIGINAL (pre-smoothing) scores, i.e. a two-tap
   FIR, not a recursive filter; reproduced exactly here,
5. ROC with ``pos_label=0`` (low score == anomalous) and AUC.

The AUC itself is computed sklearn-free in NumPy (trapezoidal ROC identical
to ``sklearn.metrics.roc_curve`` + ``auc``), so evaluation has no runtime
dependency beyond NumPy; tests cross-check against sklearn.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..configs import DECIDABLE_IDX, FUSION_LAMBDAS
from .gt import GroundTruthLoader


def roc_auc(labels: np.ndarray, scores: np.ndarray, pos_label: int = 0) -> float:
    """Frame-level ROC-AUC, trapezoidal, matching sklearn.roc_curve + auc.

    ``pos_label=0`` mirrors the reference: anomalous frames are labeled 1 in
    gt but the *normal* class (label 0, high score) is treated as positive,
    so a good detector gives AUC close to 1.
    """
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    pos = (labels == pos_label).astype(np.float64)
    neg = 1.0 - pos
    order = np.argsort(-scores, kind="mergesort")
    pos, neg, sorted_scores = pos[order], neg[order], scores[order]
    tp = np.cumsum(pos)
    fp = np.cumsum(neg)
    # Collapse threshold ties: keep the last index of each distinct score.
    distinct = np.nonzero(np.diff(sorted_scores))[0]
    idx = np.r_[distinct, len(sorted_scores) - 1]
    tp, fp = tp[idx], fp[idx]
    tpr = tp / tp[-1] if tp[-1] > 0 else np.zeros_like(tp)
    fpr = fp / fp[-1] if fp[-1] > 0 else np.zeros_like(fp)
    tpr = np.r_[0.0, tpr]
    fpr = np.r_[0.0, fpr]
    return float(np.trapezoid(tpr, fpr))


def normalize_records(records: Sequence[np.ndarray],
                      decidable_idx: int = DECIDABLE_IDX,
                      normalize: bool = True) -> np.ndarray:
    """Per-video then global min-max normalization (eval_metric.py:405-417)."""
    parts = []
    for rec in records:
        d = np.asarray(rec, dtype=np.float64).copy()
        if normalize:
            d -= d.min()
            dmax = d.max()
            if dmax > 0:
                d /= dmax
        parts.append(d[decidable_idx:])
    scores = np.concatenate(parts, axis=0)
    if normalize:
        scores -= scores.min()
        smax = scores.max()
        if smax > 0:
            scores /= smax
    return scores


def fuse_and_smooth(img_scores: np.ndarray, fea_scores: np.ndarray,
                    lam_fea_comm: float, lam_smooth: float) -> np.ndarray:
    """Fusion + one-step smoothing (eval_metric.py:426-427).

    The reference smooths with a list comprehension that reads the *original*
    (pre-smoothing) score list — a non-recursive two-tap FIR
    ``y[i] = (1-l2) * x[i-1] + l2 * x[i]``, ``y[0] = x[0]`` — reproduced
    exactly (and vectorized).
    """
    x = (1.0 - lam_fea_comm) * img_scores + lam_fea_comm * (1.0 - fea_scores)
    if len(x) == 0:
        return x
    y = np.empty_like(x)
    y[0] = x[0]
    if len(x) > 1:
        y[1:] = (1.0 - lam_smooth) * x[:-1] + lam_smooth * x[1:]
    return y


@dataclass
class RecordResult:
    auc: float = -np.inf
    dataset: Optional[str] = None
    loss_file: Optional[str] = None
    lam_fea_comm: Optional[float] = None
    lam_smooth: Optional[float] = None

    def __lt__(self, other: "RecordResult") -> bool:
        return self.auc < other.auc

    def __str__(self) -> str:
        return (
            f"dataset = {self.dataset}, loss file = {self.loss_file}, "
            f"auc = {self.auc}, lam_fea_comm={self.lam_fea_comm}, "
            f"lam_smooth={self.lam_smooth}"
        )


def load_result_pickle(path: str) -> Dict:
    with open(path, "rb") as fh:
        return pickle.load(fh)


def img_pred_fea_comm_auc(
    records: Dict,
    gt: Sequence[np.ndarray],
    lam: Tuple[float, float],
    decidable_idx: int = DECIDABLE_IDX,
) -> float:
    """Fused PSNR + memory-commit AUC for one result dict.

    ``records`` is the result-dict schema of the reference golden pickles
    (test_helper.py:479-488): keys ``rgb_img_pred_records`` and
    ``rgb_fea_comm_records`` hold per-video float arrays.
    """
    rgb_img = records["rgb_img_pred_records"]
    rgb_fea = records["rgb_fea_comm_records"]
    assert len(rgb_img) == len(gt), (
        f"{len(rgb_img)} score videos vs {len(gt)} gt videos"
    )
    labels = np.concatenate([np.asarray(g)[decidable_idx:] for g in gt], axis=0)
    img_scores = normalize_records(rgb_img, decidable_idx)
    fea_scores = normalize_records(rgb_fea, decidable_idx)
    scores = fuse_and_smooth(img_scores, fea_scores, lam[0], lam[1])
    return roc_auc(labels, scores, pos_label=0)


def roc_curve(labels: np.ndarray, scores: np.ndarray, pos_label: int = 0,
              drop_intermediate: bool = False
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) matching sklearn.roc_curve's threshold collapsing.

    ``drop_intermediate=True`` additionally removes collinear points exactly
    like sklearn's default — irrelevant to AUC, but the reference's EER
    (eval_metric.py:331) picks its operating point from the *collapsed*
    curve, so parity requires it there.
    """
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    pos = (labels == pos_label).astype(np.float64)
    neg = 1.0 - pos
    order = np.argsort(-scores, kind="mergesort")
    pos, neg, sorted_scores = pos[order], neg[order], scores[order]
    tp, fp = np.cumsum(pos), np.cumsum(neg)
    distinct = np.nonzero(np.diff(sorted_scores))[0]
    idx = np.r_[distinct, len(sorted_scores) - 1]
    tp, fp = tp[idx], fp[idx]
    if drop_intermediate and len(tp) > 2:
        keep = np.r_[True,
                     np.logical_or(np.diff(fp, 2), np.diff(tp, 2)),
                     True]
        tp, fp = tp[keep], fp[keep]
    tpr = tp / tp[-1] if tp[-1] > 0 else np.zeros_like(tp)
    fpr = fp / fp[-1] if fp[-1] > 0 else np.zeros_like(fp)
    return np.r_[0.0, fpr], np.r_[0.0, tpr]


def precision_recall_auc(labels: np.ndarray, scores: np.ndarray,
                         pos_label: int = 0) -> float:
    """Area under the precision-recall curve (reference eval_metric.py:291-311,
    sklearn precision_recall_curve + trapezoidal auc semantics)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    pos = (labels == pos_label).astype(np.float64)
    order = np.argsort(-scores, kind="mergesort")
    pos, sorted_scores = pos[order], scores[order]
    tp = np.cumsum(pos)
    n_pred = np.arange(1, len(pos) + 1, dtype=np.float64)
    distinct = np.nonzero(np.diff(sorted_scores))[0]
    idx = np.r_[distinct, len(sorted_scores) - 1]
    precision = tp[idx] / n_pred[idx]
    recall = tp[idx] / tp[-1] if tp[-1] > 0 else np.zeros_like(tp[idx])
    # sklearn appends the (recall=0, precision=1) anchor and reverses
    recall = np.r_[recall[::-1], 0.0]
    precision = np.r_[precision[::-1], 1.0]
    return float(abs(np.trapezoid(precision, recall)))


def compute_eer(labels: np.ndarray, scores: np.ndarray,
                pos_label: int = 0) -> float:
    """Equal error rate: fpr at the point where fpr + tpr is closest to 1
    (reference cal_eer, eval_metric.py:314-318, on sklearn's
    drop_intermediate=True curve)."""
    fpr, tpr = roc_curve(labels, scores, pos_label, drop_intermediate=True)
    return float(fpr[np.nanargmin(np.abs(fpr + tpr - 1.0))])


def _result_files(save_file: str) -> list:
    if os.path.isdir(save_file):
        return [os.path.join(save_file, f) for f in sorted(os.listdir(save_file))]
    return [save_file]


def _load_gt_for(records: Dict, data_dir: str,
                 gt: Optional[Sequence[np.ndarray]]) -> Sequence[np.ndarray]:
    if gt is not None:
        return gt
    key = "psnr" if "psnr" in records else "rgb_img_pred_records"
    lengths = [len(a) for a in records[key]]
    return GroundTruthLoader(data_dir)(records["dataset"],
                                       video_lengths=lengths)


def get_scores_labels(
    records: Dict,
    gt: Sequence[np.ndarray],
    decidable_idx: int = DECIDABLE_IDX,
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-stream (scores, labels) pair, per-video min-max normalized
    (reference ``eval_metric.get_scores_labels``, eval_metric.py:268-288).

    Accepts either pickle schema: the legacy ``{'psnr': [...]}`` files the
    reference's eer/pr-auc paths consume, or this framework's four-record
    dicts (the rgb prediction stream is the headline signal in both).
    """
    stream = records["psnr"] if "psnr" in records \
        else records["rgb_img_pred_records"]
    scores = normalize_records(stream, decidable_idx)
    labels = np.concatenate(
        [np.asarray(g)[decidable_idx:] for g in gt], axis=0)
    return scores, labels


def _evaluate_img_pred_fea_comm(save_file, lam, data_dir, gt):
    best = RecordResult()
    for path in _result_files(save_file):
        records = load_result_pickle(path)
        dataset = records["dataset"]
        lam_ds = lam or FUSION_LAMBDAS[dataset]
        auc = img_pred_fea_comm_auc(records, _load_gt_for(records, data_dir, gt),
                                    lam_ds)
        result = RecordResult(auc, dataset, path, lam_ds[0], lam_ds[1])
        if best < result:
            best = result
    return {"optimal_loss": str(best.loss_file), "auc": round(best.auc, 3)}


def _evaluate_precision_recall_auc(save_file, lam, data_dir, gt):
    """Best precision-recall AUC over result files (eval_metric.py:291-312); ``lam`` unused
    (single-stream metric) but accepted for dispatch uniformity."""
    best = RecordResult()
    for path in _result_files(save_file):
        records = load_result_pickle(path)
        scores, labels = get_scores_labels(
            records, _load_gt_for(records, data_dir, gt))
        auc = precision_recall_auc(labels, scores, pos_label=0)
        result = RecordResult(auc, records["dataset"], path)
        if best < result:
            best = result
    return {"optimal_loss": str(best.loss_file), "auc": round(best.auc, 3)}


def _evaluate_eer(save_file, lam, data_dir, gt):
    """LOWEST equal-error-rate over result files (eval_metric.py:321-341,
    note the reference seeds with auc=inf and keeps the minimum)."""
    best = RecordResult(auc=np.inf)
    for path in _result_files(save_file):
        records = load_result_pickle(path)
        scores, labels = get_scores_labels(
            records, _load_gt_for(records, data_dir, gt))
        eer = compute_eer(labels, scores, pos_label=0)
        result = RecordResult(eer, records["dataset"], path)
        if result < best:
            best = result
    return {"optimal_loss": str(best.loss_file), "eer": round(best.auc, 3)}


# reference dispatch map (eval_metric.py:442-446)
EVAL_TYPE_FUNCTIONS = {
    "img_pred_fea_comm_rgb_auc": _evaluate_img_pred_fea_comm,
    "precision_recall_auc": _evaluate_precision_recall_auc,
    "compute_eer": _evaluate_eer,
}


def evaluate(
    save_file: str,
    lam: Optional[Tuple[float, float]] = None,
    data_dir: str = "",
    gt: Optional[Sequence[np.ndarray]] = None,
    eval_type: str = "img_pred_fea_comm_rgb_auc",
) -> Dict[str, object]:
    """Directory/file evaluation entry point mirroring ``eval_metric.evaluate``
    (eval_metric.py:449-454) including its eval-type dispatch.

    Accepts a result pickle or a directory of them, picks the best result,
    and returns ``{"optimal_loss": path, "auc"|"eer": rounded}``.
    """
    if eval_type not in EVAL_TYPE_FUNCTIONS:
        raise ValueError(
            f"there is no type of evaluation {eval_type!r}, please check "
            f"{sorted(EVAL_TYPE_FUNCTIONS)}")
    return EVAL_TYPE_FUNCTIONS[eval_type](save_file, lam, data_dir, gt)
