"""Ground-truth loading for frame-level anomaly labels.

Rebuild of the reference ``Code/main/eval_metric.py:41-210``
(``GroundTruthLoader``): UCSD/Avenue/subway-style ``.mat`` files with
1-indexed (start, end) abnormal-event ranges, ShanghaiTech per-video ``.npy``
frame masks, and a toy-data JSON format for synthetic smoke tests.

Additionally ships the standard public UCSD Ped2 test annotation as a
built-in (:func:`ped2_builtin_gt`) so the full scoring pipeline can be
regression-tested without the original dataset files on disk.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# Standard UCSD Ped2 test-set frame-level annotation: 1-indexed inclusive
# (start, end) abnormal ranges for the 12 test clips, as distributed with the
# UCSD Anomaly Detection dataset (and encoded in the reference's ped2.mat).
PED2_EVENTS: List[tuple] = [
    (61, 180), (95, 180), (1, 146), (31, 180), (1, 129), (1, 159),
    (46, 180), (1, 180), (1, 120), (1, 150), (1, 180), (88, 180),
]


def events_to_mask(events: Sequence[tuple], length: int) -> np.ndarray:
    """1-indexed inclusive (start, end) event list -> int8 frame mask."""
    mask = np.zeros((length,), dtype=np.int8)
    for start, end in events:
        mask[start - 1 : end] = 1
    return mask


def ped2_builtin_gt(video_lengths: Sequence[int]) -> List[np.ndarray]:
    if len(video_lengths) != len(PED2_EVENTS):
        raise ValueError(
            f"ped2 has {len(PED2_EVENTS)} test videos, got {len(video_lengths)}"
        )
    return [events_to_mask([ev], n) for ev, n in zip(PED2_EVENTS, video_lengths)]


class GroundTruthLoader:
    """Loads per-video frame-level anomaly masks.

    Parameters mirror the reference loader's file layout under ``data_dir``:
      - ``<data_dir>/<dataset>/<dataset>.mat``: matlab 'gt' array of
        1-indexed (start, end) event pairs per video (ped1/ped2/avenue/...)
      - ``<data_dir>/<dataset>/testing/frames/<video>/``: frame folders whose
        file counts define video lengths
      - ``<data_dir>/shanghaitech/testing/test_frame_mask/*.npy``: masks
      - ``<data_dir>/toydata/toydata.json``: {video: {length, gt: [[s,e],..]}}
    """

    MAT_DATASETS = ("avenue", "ped1", "ped2", "enter", "exit")

    def __init__(self, data_dir: str = "", mapping_json: Optional[str] = None):
        # data_dir falls back to $AMMCNET_GT_DIR so golden-AUC regressions
        # for datasets without builtin annotations (avenue, shanghaitech)
        # activate automatically wherever the public GT files are mounted
        self.data_dir = data_dir or os.environ.get("AMMCNET_GT_DIR", "")
        data_dir = self.data_dir
        self.mapping: Dict[str, str] = {}
        if mapping_json:
            with open(mapping_json) as fh:
                self.mapping = json.load(fh)
        else:
            self.mapping = {
                name: os.path.join(data_dir, name, f"{name}.mat")
                for name in self.MAT_DATASETS
            }

    def __call__(self, dataset: str,
                 video_lengths: Optional[Sequence[int]] = None) -> List[np.ndarray]:
        if dataset == "shanghaitech":
            return self._load_shanghaitech()
        if dataset == "toydata":
            return self._load_toydata()
        return self._load_mat(dataset, video_lengths)

    # -- .mat event-range datasets -------------------------------------------------
    def _load_mat(self, dataset: str,
                  video_lengths: Optional[Sequence[int]]) -> List[np.ndarray]:
        mat_file = self.mapping.get(dataset, "")
        if not os.path.isfile(mat_file):
            if dataset == "ped2" and video_lengths is not None:
                return ped2_builtin_gt(video_lengths)
            raise FileNotFoundError(
                f"ground-truth mat for {dataset!r} not found at {mat_file!r} "
                "and no builtin annotation available; provide the standard "
                f"public '{dataset}.mat' ('gt' cell of 1-indexed (start,end) "
                "event pairs) under <data_dir>/<dataset>/ or set "
                "$AMMCNET_GT_DIR"
            )
        import scipy.io as scio

        abnormal_events = scio.loadmat(mat_file, squeeze_me=True)["gt"]
        if abnormal_events.ndim == 2:
            abnormal_events = abnormal_events.reshape(
                -1, abnormal_events.shape[0], abnormal_events.shape[1]
            )
        num_video = abnormal_events.shape[0]
        if video_lengths is None:
            video_lengths = self._frame_folder_lengths(dataset)
        assert num_video == len(video_lengths), (
            f"gt has {num_video} videos but {len(video_lengths)} lengths given"
        )
        gt = []
        for i in range(num_video):
            sub = abnormal_events[i]
            if sub.ndim == 1:
                sub = sub.reshape((sub.shape[0], -1))
            events = [(int(sub[0, j]), int(sub[1, j])) for j in range(sub.shape[1])]
            gt.append(events_to_mask(events, int(video_lengths[i])))
        return gt

    def _frame_folder_lengths(self, dataset: str) -> List[int]:
        folder = os.path.join(self.data_dir, dataset, "testing", "frames")
        videos = sorted(os.listdir(folder))
        return [len(os.listdir(os.path.join(folder, v))) for v in videos]

    # -- shanghaitech npy masks ----------------------------------------------------
    def _load_shanghaitech(self) -> List[np.ndarray]:
        label_dir = os.path.join(
            self.data_dir, "shanghaitech", "testing", "test_frame_mask"
        )
        if not os.path.isdir(label_dir):
            raise FileNotFoundError(
                f"shanghaitech frame masks not found at {label_dir!r}; "
                "provide the dataset's public per-video 'test_frame_mask' "
                ".npy files there or set $AMMCNET_GT_DIR"
            )
        return [
            np.load(os.path.join(label_dir, f))
            for f in sorted(os.listdir(label_dir))
        ]

    # -- pixel-level masks ----------------------------------------------------------
    def get_pixel_masks_file_list(self, dataset: str):
        """Sorted per-video pixel-mask ``.npy`` paths plus the indices of the
        test videos that have masks — only a subset does in ped1/avenue
        (serves the same role as the reference's mask/video id matching,
        ``Code/main/eval_metric.py:182-210``).

        A mask file must be named ``<video_folder_name>.npy``; unmatched mask
        files are an error (a typo would silently misalign pixel-level eval).
        """
        mask_dir = os.path.join(self.data_dir, dataset, "pixel_masks")
        mask_files = sorted(os.listdir(mask_dir))
        video_folder = os.path.join(self.data_dir, dataset, "testing", "frames")
        video_pos = {name: i for i, name in
                     enumerate(sorted(os.listdir(video_folder)))}
        try:
            video_ids = [video_pos[os.path.splitext(m)[0]] for m in mask_files]
        except KeyError as e:
            raise ValueError(
                f"pixel mask {e.args[0]!r}.npy has no matching test video "
                f"under {video_folder!r}") from None
        return [os.path.join(mask_dir, f) for f in mask_files], video_ids

    # -- toy json ------------------------------------------------------------------
    def _load_toydata(self) -> List[np.ndarray]:
        path = os.path.join(self.data_dir, "toydata", "toydata.json")
        with open(path) as fh:
            gt_dict = json.load(fh)
        gt = []
        for _video, info in gt_dict.items():
            mask = np.zeros((info["length"],), dtype=np.int8)
            for start, end in info["gt"]:
                mask[start : end + 1] = 1  # toy format: 0-indexed inclusive
            gt.append(mask)
        return gt
