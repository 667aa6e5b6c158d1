"""Typed configuration of the scoring path.

The port's own copy of the JAX package's configuration layer, trimmed to
what test-time scoring reads: the generator's architecture
(:class:`NetConfig`), the test data layout (:class:`DataConfig`), the
per-dataset presets and the score-fusion constants.  Loss and optimizer
configs arrive with the training slice.

Static constants follow the reference ``Code/main/params/const_params.py``:
256x256 frames, channel dict {rgb:3, op:2}, history dict {rgb:4, op:3}.
Net hyperparameters follow the released per-dataset net-params pickles
(embed_dim=64, n_embed=256, k=2, in=(12,6), out=(3,2)).  Score-fusion
lambdas per dataset follow ``Code/run_helper/test_helper.py:565-569``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

IMAGE_SIZE: int = 256
CHANNEL: Dict[str, int] = {"rgb": 3, "op": 2}
HISTORY: Dict[str, int] = {"rgb": 4, "op": 3}  # input frames per clip (target excluded)

# Per-dataset score-fusion constants (lam_fea_comm, lam_smooth),
# reference Code/run_helper/test_helper.py:565-569.  toydata has no
# reference value; 0.01 is the argmax of the JAX package's lambda sweep.
FUSION_LAMBDAS: Dict[str, Tuple[float, float]] = {
    "ped2": (0.01, 0.55),
    "avenue": (0.04, 0.65),
    "shanghaitech": (0.13, 0.60),
    "toydata": (0.01, 0.55),
}

# Frames at the start of each video whose scores are undecidable because the
# model needs `HISTORY['rgb']` frames of context (reference eval_metric.py:16-17).
DECIDABLE_IDX: int = 4


@dataclass(frozen=True)
class NetConfig:
    """Architecture of the generator (reference net-params pickles)."""

    net_tag: str = "unet_vq_twostream"
    data_type: str = "rgb_op"
    # (rgb, op) channel counts; single-stream nets use only the first element.
    in_channel: Tuple[int, int] = (12, 6)
    out_channel: Tuple[int, int] = (3, 2)
    embed_dim: int = 64
    n_embed: int = 256
    k: int = 2
    layer_nums: int = 4
    features_root: int = 64
    image_size: int = IMAGE_SIZE
    # Compute dtype for convs; params/codebook stay float32.
    dtype: str = "bfloat16"
    # Route the inference memory lookup through the hand-written CUDA kernel
    # (ops/memory_kernels.py); False takes the plain PyTorch op.
    use_memory_kernel: bool = True


@dataclass(frozen=True)
class DataConfig:
    dataset_name: str = "ped2"
    data_type: str = "rgb_op"
    rgb_root: str = ""
    op_root: str = ""
    gt_root: str = ""
    clip_length_rgb: int = 5  # 4 history + 1 target
    clip_length_op: int = 4  # 3 history + 1 target
    image_size: int = IMAGE_SIZE
    # Reproduce the reference flow-loader channel overwrite
    # (two_stream_dataset.py:94-95: v-channel replaced by u/width) for
    # checkpoint parity.  Set False for the corrected loader.
    reproduce_flow_channel_bug: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    net: NetConfig = field(default_factory=NetConfig)
    data: DataConfig = field(default_factory=DataConfig)
    exp_tag: str = "default"
    save_dir: str = "runs"
    seed: int = 20200525  # reference unet.py:4
    mode: str = "training"


def preset(dataset_name: str, mode: str = "testing", data_dir: str = "",
           **overrides: Any) -> ExperimentConfig:
    """Per-dataset presets mirroring the released net-params pickles."""
    if dataset_name not in FUSION_LAMBDAS:
        raise ValueError(f"unknown dataset {dataset_name!r}")
    data = DataConfig(
        dataset_name=dataset_name,
        rgb_root=f"{data_dir}/{dataset_name}/testing/frames" if data_dir else "",
        op_root=f"{data_dir}/{dataset_name}/testing/flows" if data_dir else "",
        gt_root=data_dir,
    )
    cfg = ExperimentConfig(
        net=NetConfig(), data=data, mode=mode,
        exp_tag=f"unet_vq_twostream-{dataset_name}-rgb_op")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
