"""Training entry point of the PyTorch port: stage 2 (two-stream).

Mirrors ``ammcnet_aaai2021_tpu/runners/run_train.py`` (reference
``Code/main/run_train.py`` + ``constant_train.py``): the same flags and
defaults, plus ``--device``.  This slice runs the released stage-2 recipe
with the file-tree (``normal``) backend: joint two-stream training of the
AMMCNet generator, optionally grafting stage-1 branch checkpoints
(``--pretrain``), with the FlowNet2-SD teacher and the PatchGAN
discriminator.  Stage 1 (``--data_type rgb|op``), the ``device`` and
``framepack`` backends, ``--fetch_every_periods`` and
``--async_checkpoints`` raise ``NotImplementedError`` naming their slice.

Usage:
  python -m ammcnet_aaai2021_torch.runners.run_train \\
      --dataset_name ped2 --data_dir /data [--iterations 80000]

``--device cuda`` is the default and fails when no GPU is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Tuple

import torch

from ..train.state import TrainState


def parser_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--data_dir", required=True,
                   help="root: <data_dir>/<dataset>/training/{frames,flows}")
    p.add_argument("--net_tag", default="unet_vq_twostream")
    p.add_argument("--loss_tag", default="twostream_vq")
    p.add_argument("--data_type", default="rgb_op",
                   choices=["rgb", "op", "rgb_op"])
    p.add_argument("--exp_tag", default="")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--iterations", type=int, default=80000)
    p.add_argument("--lr_g", type=float, default=2e-4)
    p.add_argument("--lr_d", type=float, default=2e-5)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--embed_dim", type=int, default=64)
    p.add_argument("--n_embed", type=int, default=256)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--pretrain", action="store_true",
                   help="graft stage-1 branch checkpoints (stage 2)")
    p.add_argument("--rgb_model_path", default="",
                   help="stage-1 rgb branch: a torch .pth state dict or a "
                        "step dir of a port training run")
    p.add_argument("--op_model_path", default="")
    p.add_argument("--flownet_ckpt", default="",
                   help="FlowNet2-SD torch .pth (random init + warning if "
                        "absent; the flow loss is observational either way)")
    p.add_argument("--freeze_codebook", action="store_true",
                   help="pin the memory codebook to its (grafted) state: "
                        "skip the EMA update while encoder/decoder train")
    p.add_argument("--fix_branches", action="store_true",
                   help="freeze rgb/op branches, train bridge only")
    p.add_argument("--save_dir", default="runs")
    p.add_argument("--registry", default="runs/registry.json")
    p.add_argument("--seed", type=int, default=20200525)
    p.add_argument("--step_log", type=int, default=10)
    p.add_argument("--step_summary", type=int, default=100)
    p.add_argument("--step_save", type=int, default=1000)
    p.add_argument("--fetch_every_periods", type=int, default=1,
                   help="batch K log periods of scalars into one fetch "
                        "(not ported yet)")
    p.add_argument("--async_checkpoints", action="store_true",
                   help="write checkpoints on a writer thread (not ported "
                        "yet)")
    p.add_argument("--keep_ckpts", type=int, default=0,
                   help="retention: keep only the newest N full-state "
                        "checkpoints (0 = keep all, reference behavior)")
    p.add_argument("--keep_every", type=int, default=0,
                   help="retention: also keep every checkpoint whose step is "
                        "divisible by K")
    p.add_argument("--num_workers", type=int, default=8,
                   help="decode threads for the file-tree (normal) backend")
    p.add_argument("--cache_gb", type=float, default=2.0,
                   help="decoded-frame LRU cache for the file-tree backend "
                        "(GiB; 0 disables)")
    p.add_argument("--backend", default="normal",
                   choices=["normal", "framepack", "device"],
                   help="training data backend (only normal is ported)")
    p.add_argument("--resume", default="",
                   help="run dir (or exp_tag via registry) to resume from: "
                        "restores the full training state incl. optimizer "
                        "moments and EMA codebook")
    for lam in ("lam_adv", "lam_lp", "lam_gdl", "lam_flow", "lam_latent",
                "lam_lp_op"):
        p.add_argument(f"--{lam}", type=float, default=None)
    p.add_argument("--l_num", type=int, default=None)
    p.add_argument("--alpha_num", type=int, default=None)
    p.add_argument("--fix_gdl_key_bug", action="store_true",
                   help="decouple lam_gdl from lam_adv for vq loss tags "
                        "(the reference ini reader takes lam_gdl from the "
                        "lam_adv key, constant_train.py:316,336)")
    p.add_argument("--aligned_sampling", action="store_true", default=True)
    p.add_argument("--unaligned_sampling", dest="aligned_sampling",
                   action="store_false",
                   help="reproduce the reference's independent rgb/op clip "
                        "sampling (two_stream_dataset.py:466-470)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; 'cuda' fails when no GPU "
                        "is visible, it never carries on on the CPU")
    return p.parse_args(argv)


def _check_slice(args) -> None:
    """Raise for what later slices of the port bring."""
    if args.data_type != "rgb_op" or args.net_tag not in (
            "unet_vq_twostream", "twostream_concat_dire"):
        raise NotImplementedError(
            f"--data_type {args.data_type} / --net_tag {args.net_tag}: "
            "stage-1 (single-stream) training is not ported yet; it comes "
            "with the stage-1 training slice")
    if args.backend != "normal":
        raise NotImplementedError(
            f"--backend {args.backend} is not ported yet; it comes with the "
            "stage-1 training slice (data/resident.py, framepack)")
    if args.fetch_every_periods != 1:
        raise NotImplementedError(
            "--fetch_every_periods is not ported yet; it comes with the "
            "export-and-tools slice")
    if args.async_checkpoints:
        raise NotImplementedError(
            "--async_checkpoints is not ported yet; it comes with the "
            "export-and-tools slice")


def _load_branch(path: str, stream: str) -> Dict[str, torch.Tensor]:
    """A stage-1 branch's state dict: a torch ``.pth`` of a single-stream
    generator, or a step dir of a port training run.  Keys under
    ``<stream>.`` (a two-stream checkpoint) are taken from that stream."""
    from ..tools.weights import load_generator_checkpoint

    sd = load_generator_checkpoint(path)
    prefix = f"{stream}."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    return sd


def main(argv=None) -> Tuple[str, TrainState]:
    """Run training; returns ``(run_dir, final TrainState)``."""
    args = parser_args(argv)
    _check_slice(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (pass --device cpu to train on the CPU)")

    from ..configs import (DataConfig, ExperimentConfig, NetConfig,
                           OptimConfig, train_loss_preset)
    from ..data.datasets import (TwoStreamTrainSampler, VideoIndex,
                                 parallel_batches)
    from ..models import build_model, init_flownet_weights
    from ..ops.metrics import psnr_per_frame
    from ..train.checkpoint import latest_step, restore_checkpoint
    from ..train.loop import train_loop
    from ..train.state import create_train_state, graft_branches
    from ..train.steps import _to_model_range, make_twostream_train_step
    from ..utils.logging_utils import get_logger
    from ..utils.registry import register_run, resolve_run

    size = args.image_size
    net = NetConfig(net_tag=args.net_tag, data_type=args.data_type,
                    embed_dim=args.embed_dim, n_embed=args.n_embed, k=args.k,
                    image_size=size)
    rgb_root = os.path.join(args.data_dir, args.dataset_name, "training",
                            "frames")
    op_root = os.path.join(args.data_dir, args.dataset_name, "training",
                           "flows")
    data = DataConfig(dataset_name=args.dataset_name,
                      data_type=args.data_type, rgb_root=rgb_root,
                      op_root=op_root, image_size=size,
                      aligned_two_stream_sampling=args.aligned_sampling)
    loss_cfg = train_loss_preset(args.dataset_name, args.loss_tag,
                                 reproduce_gdl_key_bug=not args.fix_gdl_key_bug)
    lam_overrides = {
        name: getattr(args, name)
        for name in ("lam_adv", "lam_lp", "lam_gdl", "lam_flow",
                     "lam_latent", "lam_lp_op", "l_num", "alpha_num")
        if getattr(args, name) is not None}
    if lam_overrides:
        loss_cfg = dataclasses.replace(loss_cfg, **lam_overrides)
    optim = OptimConfig(lr_g=args.lr_g, lr_d=args.lr_d,
                        iterations=args.iterations,
                        batch_size=args.batch_size,
                        fix_branches=args.fix_branches,
                        freeze_codebook=args.freeze_codebook)
    cfg = ExperimentConfig(
        net=net, data=data, loss=loss_cfg, optim=optim,
        exp_tag=args.exp_tag
        or f"{args.net_tag}-{args.dataset_name}-{args.data_type}",
        save_dir=args.save_dir, seed=args.seed, mode="training")
    run_dir = register_run(args.registry, cfg)
    logger = get_logger("run_train", os.path.join(run_dir, "log_dir"))
    logger.info("run dir: %s (device %s)", run_dir, device)

    model = build_model(net, mode="training")
    g_mask = ({k: k == "bridge" for k in ("rgb", "op", "bridge")}
              if args.fix_branches else None)
    state = create_train_state(model.generator, model.discriminator, optim,
                               args.seed, g_mask=g_mask, device=device)
    flownet = model.flow_network
    if args.flownet_ckpt:
        raw = torch.load(args.flownet_ckpt, map_location="cpu",
                         weights_only=True)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
        flownet.load_state_dict(raw)
        logger.info("loaded FlowNet2-SD from %s", args.flownet_ckpt)
    else:
        init_flownet_weights(flownet, torch.Generator().manual_seed(
            args.seed + 7))
        logger.warning("no --flownet_ckpt: FlowNet teacher is randomly "
                       "initialized (flow loss is observational)")
    flownet.to(device).eval().requires_grad_(False)

    if args.pretrain:
        if not (args.rgb_model_path and args.op_model_path):
            raise ValueError("--pretrain needs --rgb_model_path and "
                             "--op_model_path")
        graft_branches(state.generator,
                       _load_branch(args.rgb_model_path, "rgb"),
                       _load_branch(args.op_model_path, "op"))
        logger.info("grafted stage-1 branches from %s / %s",
                    args.rgb_model_path, args.op_model_path)

    if args.resume:
        resume_dir = args.resume
        if not os.path.isdir(resume_dir):
            resume_dir = resolve_run(args.registry, args.resume)
        ckpt_dir = os.path.join(resume_dir, "training", "checkpoints")
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        restore_checkpoint(ckpt_dir, state, step=step)
        logger.info("resumed full training state from %s step %d",
                    ckpt_dir, step)

    step_fn = make_twostream_train_step(
        loss_cfg, freeze_codebook=args.freeze_codebook)
    # u8 rgb and frame-packed clips: host assembly is contiguous copies;
    # the step normalizes and interleaves on the device
    sampler = TwoStreamTrainSampler(
        VideoIndex(rgb_root), VideoIndex(op_root), clip_len_rgb=5,
        clip_len_op=4, aligned=args.aligned_sampling, image_size=size,
        reproduce_flow_bug=data.reproduce_flow_channel_bug,
        cache_bytes=int(args.cache_gb * (1 << 30)), normalize_rgb=False,
        packed=True)

    def batches():
        for b in parallel_batches(sampler, args.batch_size,
                                  num_workers=args.num_workers):
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def psnr_fn(state, batch):
        """Train PSNR of an eval-mode forward (the memory lookups go through
        the inference kernel, B1), then back to training mode."""
        gen = state.generator
        rgb = _to_model_range(batch["rgb"])
        op = _to_model_range(batch["op"])
        gen.eval()
        try:
            with torch.no_grad():
                pred = gen(rgb[:, :-3], op[:, :-2])[0]
        finally:
            gen.train()
        return psnr_per_frame(pred, rgb[:, -3:]).mean()

    state = train_loop(state, step_fn, batches(), flownet, args.iterations,
                       run_dir, logger=logger, psnr_fn=psnr_fn,
                       step_log=args.step_log,
                       step_summary=args.step_summary,
                       step_save=args.step_save,
                       keep_ckpts=args.keep_ckpts or None,
                       keep_every=args.keep_every or None)
    logger.info("training done at step %d", state.step)
    return run_dir, state


if __name__ == "__main__":
    main()
