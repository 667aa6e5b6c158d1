"""Watch-folder evaluator: score new checkpoints as training produces them.

Port of ``ammcnet_aaai2021_tpu/runners/watch_eval.py`` (reference
``Code/main/evaluate.py:164-214``: poll ``checkpoints/`` every 60s and
evaluate ckpts not yet scored): polls a run dir's
``training/checkpoints/<step>/`` (the port's step dirs, and a JAX run's
orbax ones where tensorstore is installed, both through
``tools/weights.load_generator_checkpoint``), scores each new step with
``score_dataset`` on ``--device`` (default ``cuda``; it raises without a
GPU), appends (step, auc, fps), plus the ``--sweep`` columns, to
``watch_results.csv`` in the run dir, and keeps the best.

An existing ``watch_results.csv`` whose header is not the requested
columns (written with the other ``--sweep`` setting) raises
``ValueError``: appending would misalign its rows.

Multi-host: with a ``torch.distributed`` group of more than one process,
every rank runs this with the same arguments; the ranks score their deal
of the videos, and rank 0 merges the records (through
``<run_dir>/record_shards``) and writes the CSV.

Usage:
  python -m ammcnet_aaai2021_torch.runners.watch_eval \\
      --run_dir runs/<run> --dataset_name toydata --data_dir /data \\
      [--poll 60] [--once]
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import time

import torch


def parser_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--poll", type=float, default=60.0)
    p.add_argument("--once", action="store_true",
                   help="evaluate pending checkpoints once and exit")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--sweep", action="store_true",
                   help="also lam-sweep each checkpoint's records and "
                        "record psnr_only/fea_only/best columns")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on; 'cuda' fails when no GPU "
                        "is visible")
    return p.parse_args(argv)


def results_header(sweep: bool) -> list:
    return ["step", "auc", "fps"] + (
        ["psnr_only", "fea_only", "best_lam", "best_auc"] if sweep else [])


def _scored_steps(results_path: str, header: list) -> set:
    """The steps ``results_path`` already holds (it is created with
    ``header`` where absent); ``ValueError`` if its header differs."""
    if not os.path.exists(results_path):
        with open(results_path, "w", newline="") as fh:
            csv.writer(fh).writerow(header)
        return set()
    with open(results_path) as fh:
        reader = csv.DictReader(fh)
        if reader.fieldnames != header:
            raise ValueError(
                f"{results_path} has columns {reader.fieldnames}, this run "
                f"writes {header}: rerun with the --sweep setting that wrote "
                "it, or move it aside")
        return {int(row["step"]) for row in reader}


def main(argv=None):
    args = parser_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (pass --device cpu to score on the CPU)")
    from ..parallel import multihost

    multi = multihost.process_count() > 1
    if multi:
        # align the ranks before per-rank model builds can skew them past
        # the collective context's start-up deadline
        multihost.warm_collectives()
    rank = multihost.process_index()

    from ..configs import FUSION_LAMBDAS
    from ..eval.gt import GroundTruthLoader
    from ..eval.infer import score_dataset
    from ..eval.scoring import img_pred_fea_comm_auc
    from ..models import build_generator
    from ..tools.weights import load_generator_checkpoint
    from ..utils.logging_utils import get_logger
    from ..utils.registry import load_run_config

    cfg = load_run_config(args.run_dir)
    if args.image_size:
        cfg = dataclasses.replace(
            cfg, net=dataclasses.replace(cfg.net, image_size=args.image_size),
            data=dataclasses.replace(cfg.data, image_size=args.image_size))
    logger = get_logger("watch_eval", os.path.join(args.run_dir, "log_dir"))
    ckpt_dir = os.path.join(args.run_dir, "training", "checkpoints")
    results_path = os.path.join(args.run_dir, "watch_results.csv")
    header = results_header(args.sweep)
    seen = _scored_steps(results_path, header) if rank == 0 else set()

    gen = build_generator(cfg.net, per_sample_diff=True)
    size = cfg.data.image_size
    rgb_root = os.path.join(args.data_dir, args.dataset_name,
                            "testing", "frames")
    op_root = os.path.join(args.data_dir, args.dataset_name,
                           "testing", "flows")
    # direct lookup, as run_test: an unknown dataset fails loudly instead
    # of silently inheriting ped2's lambdas
    lam = FUSION_LAMBDAS[args.dataset_name]
    best = (None, -1.0)

    while True:
        steps = sorted(int(d) for d in os.listdir(ckpt_dir)
                       if d.isdigit()) if os.path.isdir(ckpt_dir) else []
        pending = [s for s in steps if s not in seen]
        if multi:
            # every rank scores rank 0's pending steps, in its order
            box = [pending]
            torch.distributed.broadcast_object_list(box, src=0)
            pending = box[0]
        for step in pending:
            gen.load_state_dict(load_generator_checkpoint(
                os.path.join(ckpt_dir, f"{step:06d}")))
            gen.to(device).eval()
            result, fps = score_dataset(
                gen, rgb_root, op_root, args.dataset_name,
                clip_len_rgb=cfg.data.clip_length_rgb,
                clip_len_op=cfg.data.clip_length_op,
                batch_size=args.batch_size, image_size=size,
                reproduce_flow_bug=cfg.data.reproduce_flow_channel_bug,
                logger=logger,
                shard_dir=(os.path.join(args.run_dir, "record_shards")
                           if multi else None))
            seen.add(step)
            if rank != 0:
                continue  # rank 0 merged the records and writes the row
            lengths = [len(a) for a in result["rgb_img_pred_records"]]
            gt = GroundTruthLoader(args.data_dir)(
                args.dataset_name, video_lengths=lengths)
            auc = img_pred_fea_comm_auc(result, gt, lam)
            row = [step, round(auc, 4), round(fps, 2)]
            if args.sweep:
                from ..tools.lam_sweep import DEFAULT_LAMS, sweep_pickle

                rows = dict(sweep_pickle(result, gt, DEFAULT_LAMS, lam[1]))
                best_lam = max(rows, key=rows.get)
                row += [round(rows[0.0], 4), round(rows[1.0], 4),
                        best_lam, round(rows[best_lam], 4)]
                logger.info(
                    "step %d sweep: psnr-only %.4f fea-only %.4f best "
                    "%.4f @ l1=%g", step, rows[0.0], rows[1.0],
                    rows[best_lam], best_lam)
            with open(results_path, "a", newline="") as fh:
                csv.writer(fh).writerow(row)
            if auc > best[1]:
                best = (step, auc)
            logger.info("step %d: auc=%.4f fps=%.1f (best: step %s auc=%.4f)",
                        step, auc, fps, best[0], best[1])
        if args.once:
            break
        time.sleep(args.poll)
    return best


if __name__ == "__main__":
    main()
