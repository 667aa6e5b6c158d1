"""Export a generator checkpoint as a self-contained serving artifact.

Port of ``ammcnet_aaai2021_tpu/runners/export_model.py``.  The
reference's deploy story rebuilds the Python model zoo and loads a torch
``.pth`` per serving process (``Code/run_helper/test_helper.py:503-518``).
This CLI exports the chunk scorer (``eval/export.py``: window assembly,
the two-stream forward with its memory lookups on kernel B1, the
per-frame records) once with ``torch.export``, the weights inside; a
serving process calls ``load_scorer(path)`` and needs no model code and
no checkpoint format, only the port's registered kernels.

``--ckptfile`` takes what ``run_test`` takes: a ``.pth``, a port step
dir, or the JAX package's ``.msgpack`` or orbax step dir (the last needs
tensorstore).  ``--int8`` exports the quantized forward
(``models/quantized.py``: BN-folded per-channel int8 weights, every 3x3
and transposed conv on the int8 kernels) with activation scales
calibrated on training clips of the target dataset.  The artifact is
exported on ``--device`` (default ``cuda``; it raises without a GPU) and
serves on that device type only.  ``--check`` reloads it and compares
it with the live scorer on one seeded chunk (``rtol=1e-3, atol=1e-2``,
the JAX CLI's bound), reporting ``check_max_diff``.

Prints one JSON line: the artifact header plus path, bytes and the
export and load seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch


def parser_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_name", required=True,
                   choices=["ped2", "avenue", "shanghaitech", "toydata"])
    p.add_argument("--data_dir", default="",
                   help="dataset root; required with --int8 (calibration "
                        "clips come from <data_dir>/<dataset>/training)")
    p.add_argument("--ckptfile", default="",
                   help=".pth / port step dir / flax .msgpack / orbax step "
                        "dir of the generator; random init if omitted "
                        "(smoke)")
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--image_size", type=int, default=0)
    p.add_argument("--n_videos", type=int, default=6,
                   help="videos per serving chunk")
    p.add_argument("--frames", type=int, default=192,
                   help="bucket-padded frames per video")
    p.add_argument("--window_batch", type=int, default=192)
    p.add_argument("--int8", action="store_true",
                   help="quantized forward with calibrated activation "
                        "scales (needs --data_dir)")
    p.add_argument("--calib_batches", type=int, default=4,
                   help="calibration batches (of --calib_batch_size "
                        "training clips each) for --int8")
    p.add_argument("--calib_batch_size", type=int, default=8)
    p.add_argument("--platforms", default="",
                   help="the device type the artifact serves on ('cuda' "
                        "or 'cpu'); it must be --device's type (default: "
                        "that type)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and verify it reproduces the "
                        "live scorer on one seeded chunk")
    p.add_argument("--device", default="cuda",
                   help="torch device to export on; 'cuda' fails when no "
                        "GPU is visible")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parser_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (pass --device cpu to export on the CPU)")
    platforms = [p for p in args.platforms.split(",") if p]
    if platforms and platforms != [device.type]:
        raise ValueError(
            f"--platforms {args.platforms}: a torch artifact serves on the "
            f"device type it was exported on; export on --device "
            f"{platforms[0]} for it (this run: {device.type})")

    from ..configs import preset
    from ..eval.export import ChunkScorer, chunk_example, load_scorer, \
        save_scorer
    from ..models import build_model, init_weights
    from ..tools.weights import load_generator_checkpoint
    from ..utils.logging_utils import get_logger

    logger = get_logger("export_model")
    cfg = preset(args.dataset_name, mode="testing", data_dir=args.data_dir)
    if args.image_size:
        cfg = dataclasses.replace(
            cfg, net=dataclasses.replace(cfg.net, image_size=args.image_size),
            data=dataclasses.replace(cfg.data, image_size=args.image_size))
    size = cfg.data.image_size

    gen = build_model(cfg.net, mode="testing", per_sample_diff=True).generator
    if args.ckptfile:
        gen.load_state_dict(load_generator_checkpoint(args.ckptfile))
        logger.info("loaded checkpoint %s", args.ckptfile)
    else:
        init_weights(gen, torch.Generator().manual_seed(cfg.seed))
        logger.warning("no checkpoint: exporting RANDOM weights (smoke)")
    model = gen.to(device).eval()

    meta = {"forward": "bf16" if cfg.net.dtype == "bfloat16"
            else cfg.net.dtype, "dataset": args.dataset_name,
            "ckptfile": os.path.abspath(args.ckptfile) if args.ckptfile
            else ""}
    if args.int8:
        if not args.data_dir:
            raise SystemExit("--int8 needs --data_dir (calibration clips)")
        from ..models.quantized import N_SITES, calibrated_int8_from_dataset

        model, _ = calibrated_int8_from_dataset(
            cfg.net, gen.state_dict(), args.data_dir, args.dataset_name,
            size, args.calib_batches, args.calib_batch_size, device=device)
        meta.update(forward="int8-calibrated",
                    calib_clips=args.calib_batches * args.calib_batch_size)
        logger.info("calibrated %d activation sites on %d clips", N_SITES,
                    meta["calib_clips"])

    t0 = time.perf_counter()
    header = save_scorer(args.out, model, n_videos=args.n_videos,
                         frames=args.frames, size=size,
                         window_batch=args.window_batch, extra_meta=meta)
    result = dict(header, path=os.path.abspath(args.out),
                  bytes=os.path.getsize(args.out),
                  export_s=time.perf_counter() - t0)

    if args.check:
        t0 = time.perf_counter()
        score_chunk, _ = load_scorer(args.out, device=device)
        result["load_s"] = time.perf_counter() - t0
        rgbs, ops = chunk_example(args.n_videos, args.frames, size, device,
                                  getattr(model, "dtype", torch.bfloat16))
        live = ChunkScorer(model, window_batch=args.window_batch).eval()
        with torch.no_grad():
            got = score_chunk(rgbs, ops).float().cpu()
            want = live(rgbs, ops).float().cpu()
        max_diff = float((got - want).abs().max())
        result["check_max_diff"] = max_diff
        # the same program loaded and live: equal up to run-to-run
        # differences of the device's convolutions
        if not torch.allclose(got, want, rtol=1e-3, atol=1e-2):
            raise SystemExit(f"artifact check FAILED: max diff {max_diff}")
        logger.info("artifact check ok (max diff %.3g)", max_diff)

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
