"""Test/evaluation entry point of the PyTorch port.

Mirrors ``ammcnet_aaai2021_tpu/runners/run_test.py`` (reference
``Code/main/run_test.py``): build the generator, load its checkpoint, score
every test sub-video, pickle the per-frame records in the golden schema,
fuse + AUC, and print the reference's output format ("the optimal auc =").
A checkpoint (``--ckptfile``, or ``--exp_tag``'s latest step) may be the
JAX package's too: a flax ``.msgpack``, or an orbax step dir where
tensorstore is installed (``tools/weights.load_generator_checkpoint``).

Multi-host scoring (JAX ``runners/run_test.py:108-114,215-234``): start a
``torch.distributed`` group in every process (``parallel.multihost
.initialize``), then call :func:`main` with the same arguments in each,
each with its own ``--device`` (two ranks on one card both take
``cuda:0``).  The ranks deal the videos round-robin and merge their records
through ``<save_dir>/record_shards``; rank 0 writes the pickle and prints
the AUC, the others return ``{"fps", "rank"}``.

Usage:
  python -m ammcnet_aaai2021_torch.runners.run_test \
      --dataset_name ped2 --data_dir /data --ckptfile generator.pth
"""

from __future__ import annotations

import argparse
import os
import pickle

import torch

# --flownet: the on-the-fly flow networks (models/flownet_sd.py:FlowNet2SD,
# models/flownet2.py:FlowNet2)
FLOWNETS = ("FlowNet2-SD", "FlowNet2")


def parser_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_name", required=True,
                   choices=["ped2", "avenue", "shanghaitech", "toydata"])
    p.add_argument("--data_dir", required=True,
                   help="dataset root: <data_dir>/<dataset>/testing/{frames,flows}")
    p.add_argument("--ckptfile", default="",
                   help="torch .pth state dict of the generator (the "
                        "reference's, or one tools/weights.py wrote), a "
                        "step dir of a port training run, or the JAX "
                        "package's .msgpack or orbax step dir (the latter "
                        "needs tensorstore); random init if omitted (smoke)")
    p.add_argument("--exp_tag", default="",
                   help="resolve run dir + train-time config from the "
                        "registry; scores the run's latest checkpoint unless "
                        "--ckptfile is given")
    p.add_argument("--registry", default="runs/registry.json")
    p.add_argument("--save_dir", default="eval_out")
    p.add_argument("--batch_size", type=int, default=16,
                   help="record granularity (reference DataLoader batch; "
                        "used by --batch_commit and the per-batch scorer)")
    p.add_argument("--window_batch", type=int, default=0,
                   help="windows per forward (0 = auto: 192 for the video "
                        "scorer, batch_size for the per-batch scorer); "
                        "scores are batching-invariant")
    p.add_argument("--eval_type", default="img_pred_fea_comm_rgb_auc",
                   choices=["img_pred_fea_comm_rgb_auc",
                            "precision_recall_auc", "compute_eer"],
                   help="evaluation dispatch (reference "
                        "eval_metric.py:442-454)")
    p.add_argument("--metric", default="psnr",
                   choices=["psnr", "mse", "ssim"],
                   help="per-frame prediction-quality metric "
                        "(reference loss_func_mapp)")
    p.add_argument("--op_metric", default="",
                   choices=["", "psnr", "mse", "ssim", "epe"],
                   help="motion-stream metric override; 'epe' is the "
                        "flow-native endpoint error — op records only")
    p.add_argument("--lam_fea_comm", type=float, default=None)
    p.add_argument("--lam_smooth", type=float, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--batch_commit", action="store_true",
                   help="reference-exact commit scores: one batch-mean "
                        "fea_comm value replicated over each batch_size "
                        "block (test_helper.py:446) instead of per-frame")
    p.add_argument("--reproduce_op_psnr_bug", action="store_true",
                   help="reference-exact op-stream psnr records (the torch "
                        "loop broadcasts the prediction against the 3-field "
                        "input stack, test_helper.py:434-436)")
    p.add_argument("--scorer_mode", default="auto",
                   choices=["auto", "batch", "video"],
                   help="picks the default --window_batch: 'video'/'auto' "
                        "192 windows, 'batch' batch_size")
    p.add_argument("--native_loader", action="store_true",
                   help="JPEG frames and .flo flows through data/native.py: "
                        "frames decoded on the scoring device (libjpeg's "
                        "decode rebuilt in CUDA kernels on a GPU, the C++ "
                        "libjpeg loader on the CPU; the same bytes, within "
                        "1 LSB of cv2), flows by the C++ loader; needs no "
                        "cv2")
    p.add_argument("--fix_flow_bug", action="store_true",
                   help="use the corrected flow-channel loader (default "
                        "reproduces the reference bug for ckpt parity)")
    p.add_argument("--on_the_fly_flow", action="store_true",
                   help="extract optical flow on the device with "
                        "--flownet instead of reading flow files")
    p.add_argument("--flownet", default="FlowNet2-SD",
                   choices=FLOWNETS,
                   help="the --on_the_fly_flow network: FlowNet2-SD (45.4 M "
                        "parameters) or the whole FlowNet 2.0 (162.5 M, "
                        "FlowNetC's correlation on the port's kernel), "
                        "which made the released model's training flows")
    p.add_argument("--flownet_ckpt", default="",
                   help="torch .pth of the --flownet network for "
                        "--on_the_fly_flow, flownet2-pytorch's state-dict "
                        "names (random weights if omitted: smoke only)")
    p.add_argument("--gray_upload", action="store_true",
                   help="with --on_the_fly_flow on a grayscale dataset "
                        "(ped2): upload one u8 channel a frame, broadcast "
                        "to 3 on the device (exact; fails on colour data)")
    p.add_argument("--int8", action="store_true",
                   help="serve the calibrated int8 forward (models/"
                        "quantized.py: every 3x3 and transposed conv int8 "
                        "in the port's kernels, scales calibrated on "
                        "training clips)")
    p.add_argument("--calib_clips", type=int, default=32,
                   help="training clips for --int8 calibration")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on; 'cuda' fails when no GPU "
                        "is visible, it never carries on on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parser_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (pass --device cpu to score on the CPU)")
    from ..parallel import multihost

    rank = multihost.process_index()
    multi = multihost.process_count() > 1
    # align the ranks before any heavy per-rank work (model build, kernel
    # builds); callers should still prefer multihost.initialize()
    multihost.warm_collectives()

    from ..configs import FUSION_LAMBDAS, preset
    from ..eval.gt import GroundTruthLoader
    from ..eval.infer import score_dataset
    from ..eval.scoring import evaluate
    from ..models import build_model, init_weights
    from ..tools.weights import load_generator_checkpoint
    from ..train.checkpoint import latest_step
    from ..utils.logging_utils import get_logger
    from ..utils.registry import load_run_config, resolve_run

    logger = get_logger("run_test", os.path.join(args.save_dir, "log_dir"))
    ckptfile = args.ckptfile
    if args.exp_tag:
        run_dir = resolve_run(args.registry, args.exp_tag)
        cfg = load_run_config(run_dir)
        logger.info("resolved exp_tag %s -> %s", args.exp_tag, run_dir)
        if not ckptfile:
            # the run's latest training checkpoint
            ckpt_dir = os.path.join(run_dir, "training", "checkpoints")
            step = latest_step(ckpt_dir)
            if step is not None:
                ckptfile = os.path.join(ckpt_dir, f"{step:06d}")
    else:
        cfg = preset(args.dataset_name, mode="testing", data_dir=args.data_dir)
    if args.image_size:
        import dataclasses

        cfg = dataclasses.replace(
            cfg, net=dataclasses.replace(cfg.net, image_size=args.image_size),
            data=dataclasses.replace(cfg.data, image_size=args.image_size))

    gen = build_model(cfg.net, mode="testing", per_sample_diff=True).generator
    if ckptfile:
        gen.load_state_dict(load_generator_checkpoint(ckptfile))
        logger.info("loaded checkpoint %s", ckptfile)
    else:
        init_weights(gen, torch.Generator().manual_seed(cfg.seed))
        logger.warning("no checkpoint: scoring with RANDOM weights (smoke run)")
    gen = gen.to(device).eval()

    flow_extractor = None
    if args.on_the_fly_flow:
        from ..eval.infer import make_otf_flow_extractor
        from ..models import flownet2, flownet_sd, init_flownet_weights

        flownet = (flownet2.FlowNet2() if args.flownet == "FlowNet2"
                   else flownet_sd.FlowNet2SD())
        if args.flownet_ckpt:
            raw = torch.load(args.flownet_ckpt, map_location="cpu",
                             weights_only=True)
            if isinstance(raw, dict) and "state_dict" in raw:
                raw = raw["state_dict"]
            flownet.load_state_dict(raw)
            logger.info("loaded %s from %s", args.flownet, args.flownet_ckpt)
        else:
            init_flownet_weights(flownet, torch.Generator().manual_seed(1))
            logger.warning("--on_the_fly_flow without --flownet_ckpt: "
                           "random %s weights (smoke only)", args.flownet)
        flownet.to(device).eval().requires_grad_(False)
        flow_extractor = make_otf_flow_extractor(
            flownet, reproduce_flow_bug=not args.fix_flow_bug,
            gray=args.gray_upload)
    elif args.gray_upload:
        raise SystemExit("--gray_upload requires --on_the_fly_flow (the "
                         "device-side broadcast lives in the extract program)")

    size = cfg.data.image_size
    if args.int8:
        from ..models.quantized import calibrated_int8_from_dataset

        gen, _ = calibrated_int8_from_dataset(
            cfg.net, gen.state_dict(), args.data_dir, args.dataset_name, size,
            calib_batches=max(1, args.calib_clips // 8),
            calib_batch_size=min(8, args.calib_clips),
            use_native_loader=args.native_loader, device=device)
        logger.info("serving int8 (calibrated on %d training clips)",
                    args.calib_clips)

    rgb_root = os.path.join(args.data_dir, args.dataset_name, "testing", "frames")
    op_root = os.path.join(args.data_dir, args.dataset_name, "testing", "flows")
    result, fps = score_dataset(
        gen, rgb_root, op_root, args.dataset_name,
        clip_len_rgb=cfg.data.clip_length_rgb,
        clip_len_op=cfg.data.clip_length_op,
        batch_size=args.batch_size,
        window_batch=args.window_batch or None, image_size=size,
        reproduce_flow_bug=not args.fix_flow_bug, logger=logger,
        metric=args.metric, op_metric=args.op_metric or None,
        batch_commit=args.batch_commit,
        reproduce_op_psnr_bug=args.reproduce_op_psnr_bug,
        scorer_mode=args.scorer_mode, use_native_loader=args.native_loader,
        flow_extractor=flow_extractor,
        shard_dir=(os.path.join(args.save_dir, "record_shards")
                   if multi else None))
    if multi and rank != 0:
        # rank 0 merged the records; this rank only contributed scores
        logger.info("rank %d done (%.3f local fps)", rank, fps)
        return {"fps": fps, "rank": rank}

    pickle_dir = os.path.join(args.save_dir, args.eval_type, "save_pickle")
    os.makedirs(pickle_dir, exist_ok=True)
    pickle_path = os.path.join(pickle_dir, args.dataset_name)
    with open(pickle_path, "wb") as fh:
        pickle.dump(result, fh, pickle.HIGHEST_PROTOCOL)
    logger.info("records pickled to %s", pickle_path)

    # direct lookup (every CLI-accepted dataset has an explicit entry,
    # toydata included) — an unknown name fails loudly instead of silently
    # inheriting ped2's lambdas
    lam = FUSION_LAMBDAS[args.dataset_name]
    if args.lam_fea_comm is not None:
        lam = (args.lam_fea_comm, lam[1])
    if args.lam_smooth is not None:
        lam = (lam[0], args.lam_smooth)
    logger.info("fusion lambdas: lam_fea_comm=%g lam_smooth=%g (%s%s)",
                lam[0], lam[1], args.dataset_name,
                " preset" if args.lam_fea_comm is None
                and args.lam_smooth is None else ", CLI override")
    lengths = [len(a) for a in result["rgb_img_pred_records"]]
    gt = GroundTruthLoader(args.data_dir)(args.dataset_name,
                                          video_lengths=lengths)
    summary = evaluate(pickle_path, lam=lam, gt=gt, eval_type=args.eval_type)
    metric_name = "eer" if "eer" in summary else "auc"
    value = summary[metric_name]
    print("=" * 80)
    print("the optimal loss_file is: ", pickle_path)
    print(f"the optimal {metric_name} = ", value)
    print(f"fusion lambdas: lam_fea_comm={lam[0]:g} lam_smooth={lam[1]:g}")
    print(f"inference fps = {fps:.3f}")
    print("=" * 80)
    return {metric_name: value, "fps": fps, "pickle": pickle_path,
            "flownet_forwards": (flow_extractor.forwards
                                 if flow_extractor else 0)}


if __name__ == "__main__":
    main()
