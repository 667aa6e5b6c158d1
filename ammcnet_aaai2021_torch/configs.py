"""Typed configuration of the scoring and stage-2 training paths.

The port's own copy of the JAX package's configuration layer
(``ammcnet_aaai2021_tpu/configs.py``), trimmed to what the ported slices
read: the generator's architecture (:class:`NetConfig`), the data layout
(:class:`DataConfig`), the loss weights (:class:`LossConfig`) and optimizer
(:class:`OptimConfig`), the data-parallel layout (:class:`ParallelConfig`),
the per-dataset presets and the score-fusion constants.

Static constants follow the reference ``Code/main/params/const_params.py``:
256x256 frames, channel dict {rgb:3, op:2}, history dict {rgb:4, op:3},
log/summary/checkpoint cadences 10/100/1000, discriminator filters
[128,256,512,512].  Net hyperparameters follow the released per-dataset
net-params pickles (embed_dim=64, n_embed=256, k=2, in=(12,6), out=(3,2)).
Score-fusion lambdas per dataset follow
``Code/run_helper/test_helper.py:565-569``.  A training run writes its
:class:`ExperimentConfig` as JSON beside its checkpoints
(``utils/registry.py``) and a test run reads it back.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

IMAGE_SIZE: int = 256
CHANNEL: Dict[str, int] = {"rgb": 3, "op": 2}
HISTORY: Dict[str, int] = {"rgb": 4, "op": 3}  # input frames per clip (target excluded)
DISC_FILTERS: Tuple[int, ...] = (128, 256, 512, 512)

STEP_LOG: int = 10
STEP_SUMMARY: int = 100
STEP_SAVE_CKPT: int = 1000

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
    # Route the memory lookups through the hand-written CUDA kernels
    # (ops/memory_kernels.py: B1 in inference, B2 in training); False takes
    # the plain PyTorch op.
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
    # Align (video, offset) sampling across rgb/op streams during training.
    # The reference samples them independently (two_stream_dataset.py:466-470),
    # which is almost certainly unintended; False reproduces the reference.
    aligned_two_stream_sampling: bool = True


@dataclass(frozen=True)
class LossConfig:
    """Per-loss_tag weights.  The released tune-ini with the exact training
    lambdas was never published; defaults follow the AAAI-2021 paper and the
    anopred lineage the reference builds on."""

    loss_tag: str = "twostream_vq"
    lam_adv: float = 0.05
    lam_gdl: float = 1.0
    lam_flow: float = 2.0
    lam_lp: float = 1.0
    lam_lp_op: float = 1.0
    lam_latent: float = 0.25
    l_num: int = 2
    alpha_num: int = 1


@dataclass(frozen=True)
class OptimConfig:
    lr_g: float = 2e-4
    lr_d: float = 2e-5
    # MultiStepLR with gamma=0.5 (reference Code/models/optimizer/__init__.py).
    lr_milestones: Tuple[int, ...] = (40000, 60000)
    lr_gamma: float = 0.5
    iterations: int = 80000
    batch_size: int = 4
    # Train only the bridge; the pretrained rgb/op branches get no update
    # (reference fixed_rgb_op_branch, vqvae.py:634-643).
    fix_branches: bool = False
    # Pin the memory codebook to its state before each step (skip the EMA
    # update; encoder/decoder keep training).  An extension: the reference
    # always updates its EMA buffers (unet.py:330-338).
    freeze_codebook: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    """The data-parallel layout (JAX ``configs.py:146-152``): ``data_axis``
    ranks share the batch (-1: every process of the group).  The model fits
    on one card, so ``data`` is the only axis the port lays out
    (``parallel/mesh.py``)."""

    data_axis: int = -1  # -1: all ranks
    mesh_axes: Tuple[str, ...] = ("data",)


@dataclass(frozen=True)
class ExperimentConfig:
    net: NetConfig = field(default_factory=NetConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    exp_tag: str = "default"
    save_dir: str = "runs"
    seed: int = 20200525  # reference unet.py:4
    mode: str = "training"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        """Inverse of :meth:`to_json`, for the JAX package's run configs
        too; keys this config does not know are ignored."""

        def build(tp, d):
            fields = {f.name for f in dataclasses.fields(tp)}
            kwargs = {}
            for key, val in d.items():
                if key not in fields:
                    continue
                if isinstance(val, dict) and key in _SUBCONFIGS:
                    kwargs[key] = build(_SUBCONFIGS[key], val)
                elif isinstance(val, list):
                    kwargs[key] = tuple(val)
                else:
                    kwargs[key] = val
            return tp(**kwargs)

        return build(cls, json.loads(text))


_SUBCONFIGS = {
    "net": NetConfig,
    "data": DataConfig,
    "loss": LossConfig,
    "optim": OptimConfig,
    "parallel": ParallelConfig,
}

# Per-dataset training loss weights.  The reference wires these from a
# per-dataset tune-ini (constant_train.py:277-357) that was never released.
# Its key names and comments are the anopred lineage's, whose published
# training config uses one set of weights for every dataset (lam_lp=1.0,
# lam_gdl=1.0, lam_adv=0.05, lam_flow=2.0, l_num=2, alpha_num=1);
# lam_latent is VQ-VAE's commitment beta=0.25 (unet.py:282-313); lam_lp_op
# mirrors lam_lp.  TRAIN_LAMBDAS holds per-dataset overlays on that base
# (none in the released lineage).
_LINEAGE_LAMBDAS: Dict[str, Any] = dict(
    l_num=2, alpha_num=1, lam_adv=0.05, lam_lp=1.0, lam_gdl=1.0,
    lam_flow=2.0, lam_latent=0.25, lam_lp_op=1.0)
TRAIN_LAMBDAS: Dict[str, Dict[str, Any]] = {
    "ped2": {},
    "avenue": {},
    "shanghaitech": {},
    "toydata": {},
}

# Loss tags whose ini reader takes lam_gdl from the *lam_adv* key — a
# reference defect (constant_train.py:316,336: `const.lam_gdl =
# config_tune.getfloat(const.dataset_name, 'lam_adv')`), which means every
# released vq-tag checkpoint trained with lam_gdl == lam_adv.
GDL_READS_ADV_KEY_TAGS = ("rgb_int_gdl_flow_adv_vq", "twostream_vq")


def train_loss_preset(dataset_name: str, loss_tag: str = "twostream_vq",
                      reproduce_gdl_key_bug: bool = True) -> LossConfig:
    """Per-dataset :class:`LossConfig` mirroring the reference's ini-driven
    wiring (constant_train.py:277-357).  ``reproduce_gdl_key_bug`` keeps the
    as-shipped coupling lam_gdl = lam_adv for the vq loss tags."""
    base: Dict[str, Any] = dict(_LINEAGE_LAMBDAS)
    base.update(TRAIN_LAMBDAS.get(dataset_name, {}))
    if reproduce_gdl_key_bug and loss_tag in GDL_READS_ADV_KEY_TAGS:
        base["lam_gdl"] = base["lam_adv"]
    return LossConfig(loss_tag=loss_tag, **base)


def preset(dataset_name: str, mode: str = "testing", data_dir: str = "",
           loss_tag: str = "twostream_vq", reproduce_gdl_key_bug: bool = True,
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
        loss=train_loss_preset(dataset_name, loss_tag, reproduce_gdl_key_bug),
        exp_tag=f"unet_vq_twostream-{dataset_name}-rgb_op")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
