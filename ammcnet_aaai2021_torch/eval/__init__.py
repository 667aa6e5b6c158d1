from .gt import GroundTruthLoader, ped2_builtin_gt
from .scoring import (
    EVAL_TYPE_FUNCTIONS,
    RecordResult,
    compute_eer,
    evaluate,
    fuse_and_smooth,
    get_scores_labels,
    img_pred_fea_comm_auc,
    normalize_records,
    precision_recall_auc,
    roc_auc,
)

__all__ = [
    "GroundTruthLoader",
    "ped2_builtin_gt",
    "EVAL_TYPE_FUNCTIONS",
    "RecordResult",
    "compute_eer",
    "evaluate",
    "fuse_and_smooth",
    "get_scores_labels",
    "img_pred_fea_comm_auc",
    "normalize_records",
    "precision_recall_auc",
    "roc_auc",
]
