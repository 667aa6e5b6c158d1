"""Training entry point of the PyTorch port: stage 1 and stage 2.

Mirrors ``ammcnet_aaai2021_tpu/runners/run_train.py`` (reference
``Code/main/run_train.py`` + ``constant_train.py``): the same flags and
defaults, plus ``--device``.  It runs the released recipe:

  Stage 1 (rgb):  --net_tag unet_vq_topk_res --loss_tag rgb_int_gdl_flow_adv_vq --data_type rgb
  Stage 1 (op):   --net_tag unet_vq_topk_res --loss_tag op_int_adv_vq --data_type op
  Stage 2:        --net_tag unet_vq_twostream --loss_tag twostream_vq --data_type rgb_op \\
                  [--pretrain --rgb_model_path <stage-1 step dir or .pth> --op_model_path ...]

with the FlowNet2-SD teacher (the ``*flow*`` and two-stream loss tags) and
the PatchGAN discriminator, from one of three data backends: ``normal``
(the frame tree, decoded on host threads), ``device`` (the whole split in
GPU memory, one gather a batch) and ``framepack`` (``frames.fpk`` /
``flows.fpk`` beside the tree; stage 2 only, see :func:`_check_args`).
``--pretrain`` and ``--resume`` also take the JAX package's checkpoints: a
stage-1 branch as a flax ``.msgpack`` or an orbax step dir, a JAX run dir
to continue (its orbax full train state is converted on the way in; an
orbax dir needs tensorstore, else ``tools/jax_checkpoint.py`` converts it on
a host that has it).  ``--fetch_every_periods`` and ``--async_checkpoints``
are the JAX loop's (``train/loop.py``).

Usage:
  python -m ammcnet_aaai2021_torch.runners.run_train \\
      --dataset_name ped2 --data_dir /data [--iterations 80000]

``--device cuda`` is the default and fails when no GPU is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Iterator, Tuple

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
                   help="stage-1 rgb branch: a torch .pth state dict, a step "
                        "dir of a port training run, or the JAX package's "
                        ".msgpack or orbax step dir")
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
                   help="batch K log periods of scalars into one "
                        "device-to-host fetch (values still recorded per "
                        "step_log, written K periods late)")
    p.add_argument("--async_checkpoints", action="store_true",
                   help="write checkpoints on a writer thread, from a "
                        "device copy of the state taken at the step")
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
                   help="training data backend: normal (the frame tree), "
                        "device (the whole split in GPU memory, batches "
                        "gathered on the card) or framepack (frames.fpk / "
                        "flows.fpk beside the tree; stage 2)")
    p.add_argument("--resume", default="",
                   help="run dir (or exp_tag via registry) to resume from: "
                        "restores the full training state incl. optimizer "
                        "moments and EMA codebook (a JAX run's orbax state "
                        "is converted)")
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


# the two-stream generators stage 2 trains
TWO_STREAM_TAGS = ("unet_vq_twostream", "twostream_concat_dire")
# the generators a train step takes: the JAX package's steps unpack the
# released generators' outputs (its train/steps.py:123 and :195)
TRAINABLE_TAGS = ("unet_vq_topk_res",) + TWO_STREAM_TAGS


def _check_args(args) -> None:
    """Raise for what the port does not run: a generator no train step
    takes, a generator that does not fit the stage, and stage 1 on
    framepack."""
    if args.net_tag not in TRAINABLE_TAGS:
        raise ValueError(
            f"--net_tag {args.net_tag}: no training path. The train steps "
            "unpack the released generators' outputs (the JAX package's "
            "train/steps.py:123 and :195), which only "
            f"{', '.join(TRAINABLE_TAGS)} give; the JAX package trains no "
            "other tag either")
    two_stream = args.data_type == "rgb_op"
    if two_stream != (args.net_tag in TWO_STREAM_TAGS):
        raise ValueError(
            f"--net_tag {args.net_tag} with --data_type {args.data_type}: "
            "stage 2 (rgb_op) trains a two-stream generator such as "
            "unet_vq_twostream, stage 1 (rgb, op) a single-stream net such "
            "as unet_vq_topk_res")
    if args.backend == "framepack" and not two_stream:
        # the JAX package's stage-1 path builds its file-tree sampler on the
        # .fpk path (its run_train.py:386-398) and fails there: no stage-1
        # framepack run exists to match
        raise ValueError(
            "--backend framepack trains stage 2 (--data_type rgb_op) only; "
            "stage 1 takes --backend normal or device")
    if args.pretrain and not two_stream:
        raise ValueError("--pretrain grafts stage-1 branches into stage 2 "
                         "(--data_type rgb_op)")


def _load_branch(path: str, stream: str) -> Dict[str, torch.Tensor]:
    """A stage-1 branch's state dict: a torch ``.pth`` of a single-stream
    generator, a step dir of a port training run, or a JAX ``.msgpack`` or
    orbax step dir (``load_generator_checkpoint``).  Keys under
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
    _check_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (pass --device cpu to train on the CPU)")

    from ..configs import (CHANNEL, DataConfig, ExperimentConfig, NetConfig,
                           OptimConfig, train_loss_preset)
    from ..models import build_model, init_flownet_weights
    from ..ops.metrics import psnr_per_frame
    from ..train.checkpoint import latest_step, restore_checkpoint
    from ..train.loop import train_loop
    from ..train.state import create_train_state, graft_branches
    from ..train.steps import (_to_model_range, make_single_stream_train_step,
                               make_twostream_train_step)
    from ..utils.logging_utils import get_logger
    from ..utils.registry import register_run, resolve_run

    size = args.image_size
    two_stream = args.data_type == "rgb_op"
    net = NetConfig(net_tag=args.net_tag, data_type=args.data_type,
                    embed_dim=args.embed_dim, n_embed=args.n_embed, k=args.k,
                    image_size=size)
    ext = ".fpk" if args.backend == "framepack" else ""
    rgb_root = os.path.join(args.data_dir, args.dataset_name, "training",
                            "frames" + ext)
    op_root = os.path.join(args.data_dir, args.dataset_name, "training",
                           "flows" + ext)
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

    # FlowNet2-SD only where a loss term reads it (JAX run_train.py:209)
    uses_flow = "flow" in args.loss_tag or two_stream
    model = build_model(net, mode="training", with_flow=uses_flow)
    # fix_branches masks the two-stream generator's branches (stage 2 only,
    # as in the JAX package)
    g_mask = ({k: k == "bridge" for k in ("rgb", "op", "bridge")}
              if args.fix_branches and two_stream else None)
    state = create_train_state(model.generator, model.discriminator, optim,
                               args.seed, g_mask=g_mask, device=device)
    flownet = model.flow_network
    if flownet is not None:
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

    if two_stream:
        step_fn = make_twostream_train_step(
            loss_cfg, freeze_codebook=args.freeze_codebook)
    else:
        step_fn = make_single_stream_train_step(
            loss_cfg, data_type=args.data_type,
            freeze_codebook=args.freeze_codebook)
    batches = _batches(args, data, device, logger)
    # the channels the generator predicts: the target frame's
    c_rgb, c_op = CHANNEL["rgb"], CHANNEL["op"]
    c = CHANNEL.get(args.data_type)

    def psnr_fn(state, batch):
        """Train PSNR of an eval-mode forward (the memory lookups go through
        the inference kernel, B1), then back to training mode."""
        gen = state.generator
        gen.eval()
        try:
            with torch.no_grad():
                if two_stream:
                    clip = _to_model_range(batch["rgb"])
                    op = _to_model_range(batch["op"])
                    pred = gen(clip[:, :-c_rgb], op[:, :-c_op])[0]
                    target = clip[:, -c_rgb:]
                else:
                    clip = _to_model_range(batch)
                    pred = gen(clip[:, :-c])[0]
                    target = clip[:, -c:]
        finally:
            gen.train()
        return psnr_per_frame(pred, target).mean()

    state = train_loop(state, step_fn, batches, flownet, args.iterations,
                       run_dir, logger=logger, psnr_fn=psnr_fn,
                       step_log=args.step_log,
                       step_summary=args.step_summary,
                       step_save=args.step_save,
                       fetch_every_periods=args.fetch_every_periods,
                       async_checkpoints=args.async_checkpoints,
                       keep_ckpts=args.keep_ckpts or None,
                       keep_every=args.keep_every or None)
    logger.info("training done at step %d", state.step)
    return run_dir, state


def _batches(args, data, device: torch.device, logger) -> Iterator:
    """The training batches of ``args.backend`` on ``device``, as the JAX
    CLI builds them (its run_train.py:260-326, :372-398): u8 rgb and
    frame-packed clips, normalized and interleaved by the step.  Stage 2's
    batches are ``{"rgb", "op"}`` dicts, stage 1's one clip tensor.  The
    file-tree samplers keep the JAX CLI's default seed; the device and
    framepack samplers take ``--seed``, as there."""
    from ..configs import HISTORY
    from ..data.datasets import (ClipLoader, FrameCache,
                                 SingleStreamTrainSampler,
                                 TwoStreamTrainSampler, VideoIndex,
                                 parallel_batches)

    size, b = args.image_size, args.batch_size
    flow_bug = data.reproduce_flow_channel_bug

    def draw(sampler):  # batches already on the device
        while True:
            yield sampler.batch(b)

    def upload(host_batches):
        for batch in host_batches:
            if isinstance(batch, dict):
                yield {k: torch.from_numpy(v).to(device)
                       for k, v in batch.items()}
            else:
                yield torch.from_numpy(batch).to(device)

    if args.data_type == "rgb_op":
        if args.backend == "device":
            from ..data.resident import DeviceResidentTwoStream

            sampler = DeviceResidentTwoStream(
                VideoIndex(data.rgb_root), VideoIndex(data.op_root),
                clip_len_rgb=5, clip_len_op=4, image_size=size,
                aligned=args.aligned_sampling, reproduce_flow_bug=flow_bug,
                seed=args.seed, device=device)
            logger.info("device-resident split: resident_bytes=%d (%.0f MB "
                        "on %s)", sampler.resident_bytes,
                        sampler.resident_bytes / 1e6, device)
            return draw(sampler)
        if args.backend == "framepack":
            from ..data import get_dataset

            sampler = get_dataset(
                "rgb_op", "training", "framepack", rgb_root=data.rgb_root,
                op_root=data.op_root, clip_len_rgb=5, clip_len_op=4,
                image_size=size, seed=args.seed)
            sampler.normalize_rgb = False
            sampler.packed = True

            def framepack_batches():
                # u8 rgb and bf16 flows cross the host link, a third of
                # float32's bytes
                for batch in draw(sampler):
                    yield {"rgb": torch.from_numpy(batch["rgb"]).to(device),
                           "op": torch.from_numpy(batch["op"]).to(
                               torch.bfloat16).to(device)}
            return framepack_batches()
        sampler = TwoStreamTrainSampler(
            VideoIndex(data.rgb_root), VideoIndex(data.op_root),
            clip_len_rgb=5, clip_len_op=4, aligned=args.aligned_sampling,
            image_size=size, reproduce_flow_bug=flow_bug,
            cache_bytes=int(args.cache_gb * (1 << 30)), normalize_rgb=False,
            packed=True)
        return upload(parallel_batches(sampler, b,
                                       num_workers=args.num_workers))

    clip_length = HISTORY[args.data_type] + 1
    root = data.rgb_root if args.data_type == "rgb" else data.op_root
    if args.backend == "device":
        from ..data.resident import DeviceResidentSingleStream

        sampler = DeviceResidentSingleStream(
            VideoIndex(root), args.data_type, clip_length, image_size=size,
            reproduce_flow_bug=flow_bug, seed=args.seed, device=device)
        logger.info("device-resident split: resident_bytes=%d (%.0f MB on "
                    "%s)", sampler.resident_bytes,
                    sampler.resident_bytes / 1e6, device)
        return draw(sampler)
    cache = (FrameCache(int(args.cache_gb * (1 << 30)))
             if args.cache_gb > 0 else None)
    sampler = SingleStreamTrainSampler(
        VideoIndex(root), clip_length,
        ClipLoader(args.data_type, size, flow_bug, cache=cache,
                   normalize_rgb=False, packed=True))
    return upload(parallel_batches(sampler, b, num_workers=args.num_workers))


if __name__ == "__main__":
    main()
