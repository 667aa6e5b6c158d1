"""Device-resident pipeline rate: frames/s with no host transfer.

Port of ``ammcnet_aaai2021_tpu/tools/device_bench.py``.  ``run_test``
measures the whole serving path (decode, upload, score); this tool
measures what the card sustains when the videos already live in its
memory: the chunk scorer (``eval/export.ChunkScorer``: window assembly,
normalization, the two-stream forward with its memory lookups on B1, the
per-frame records), the program the serving artifact runs, on videos
generated on the card from ``--seed`` (no upload).  Each of ``--passes``
passes is timed with CUDA events and synchronized once.

``--int8`` runs the quantized forward (``models/quantized.py``, every 3x3
and transposed conv on the int8 kernels; ``--calibrated``: static scales
from 8 windows of the first video, ``--no_resident``: conv0 -> conv1
hand-offs in bf16), ``--folded`` the folded forward
(``models/folded.py``: both streams' convolutions as one grouped
convolution), ``--otf`` also times FlowNet2-SD on the card (grayscale u8
frames of ``--true_frames`` -> padded (rgb, flows)) chained into the
scorer.

Prints one JSON line ``{"metric": "device_resident_frames_per_sec", ...}``
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch


def parser_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chunk", type=int, default=6, help="videos per chunk")
    p.add_argument("--frames", type=int, default=192,
                   help="bucket-padded frames per video")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--window_batch", type=int, default=192,
                   help="windows per forward; 192 = a whole padded video")
    p.add_argument("--passes", type=int, default=5)
    p.add_argument("--otf", action="store_true",
                   help="also time on-card FlowNet2-SD flow extraction "
                        "chained into the chunk scorer")
    p.add_argument("--true_frames", type=int, default=180,
                   help="true (pre-padding) frames per video in --otf mode")
    p.add_argument("--int8", action="store_true",
                   help="the int8 quantized forward (dynamic activation "
                        "scales unless --calibrated)")
    p.add_argument("--calibrated", action="store_true",
                   help="with --int8: static activation scales calibrated "
                        "on 8 windows of the first video")
    p.add_argument("--no_resident", action="store_true",
                   help="with --int8 --calibrated: conv0 -> conv1 "
                        "activations in bf16 instead of int8")
    p.add_argument("--folded", action="store_true",
                   help="the folded two-stream forward (grouped convs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no GPU is visible")
    return p.parse_args(argv)


def _timed_passes(fn, passes: int, device, hb, what: str) -> list:
    """Seconds of each pass of ``fn``: CUDA events on a GPU (one
    synchronize a pass), the host clock on the CPU."""
    times = []
    for i in range(passes):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t = time.perf_counter()
            fn()
            dt = time.perf_counter() - t
        times.append(dt)
        hb(f"{what} pass {i + 1}/{passes}: {dt:.4f}s")
    return times


def build_forward(gen, cfg, args, videos, device):
    """The model the scorer runs, and its name: the generator, the int8
    forward (calibrated on 8 windows of the first video with
    ``--calibrated``) or the folded forward."""
    if args.int8:
        from ..eval.infer import _stack_windows
        from ..models.quantized import (calibrate_act_scales,
                                        make_quantized_forward,
                                        quantize_twostream_variables)

        kwargs = dict(embed_dim=cfg.embed_dim, n_embed=cfg.n_embed, k=cfg.k,
                      per_sample_diff=True, use_kernel=cfg.use_memory_kernel,
                      resident=not args.no_resident)
        qvars = quantize_twostream_variables(gen.state_dict())
        qfwd = make_quantized_forward(qvars, **kwargs).to(device)
        if not args.calibrated:
            return qfwd, "int8-dynamic"
        rgb_u8, op_v = videos[0]
        idx = torch.arange(8, device=device)
        rgb_w = (_stack_windows(rgb_u8, idx, 5).float() / 255.0 - 0.5) / 0.5
        op_w = _stack_windows(op_v, idx, 4)
        qcal = calibrate_act_scales(qfwd, qvars,
                                    [(rgb_w[:, :12], op_w[:, :6])])
        return (make_quantized_forward(qcal, **kwargs).to(device),
                "int8-calibrated" + ("" if not args.no_resident
                                     else "-no-resident"))
    if args.folded:
        from ..models.folded import make_folded_forward

        fwd = make_folded_forward(
            gen.state_dict(), embed_dim=cfg.embed_dim, n_embed=cfg.n_embed,
            k=cfg.k, dtype=getattr(torch, cfg.dtype),
            use_kernel=cfg.use_memory_kernel, per_sample_diff=True)
        return fwd.to(device), "folded"
    return gen, cfg.dtype


def main(argv=None) -> dict:
    args = parser_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "visible (pass --device cpu)")
    from ..configs import NetConfig
    from ..eval.export import ChunkScorer
    from ..models import build_generator, init_weights
    from ..utils.profiling import card_name

    t0 = time.perf_counter()

    def hb(msg):
        print(f"[device_bench +{time.perf_counter() - t0:6.1f}s] {msg}",
              file=sys.stderr, flush=True)

    cfg = NetConfig()  # released configuration: bf16, B1 for the lookups
    gen = init_weights(build_generator(cfg, per_sample_diff=True),
                       torch.Generator().manual_seed(args.seed))
    gen = gen.to(device).eval()
    g = torch.Generator(device=device).manual_seed(args.seed)
    videos = [(torch.randint(0, 255, (args.frames, args.size, args.size, 3),
                             generator=g, device=device, dtype=torch.uint8),
               (torch.randn((args.frames - 1, args.size, args.size, 2),
                            generator=g, device=device) * 0.02
                ).to(getattr(torch, cfg.dtype)))
              for _ in range(args.chunk)]
    hb(f"{args.chunk} videos generated on {device}")
    model, forward = build_forward(gen, cfg, args, videos, device)
    scorer = ChunkScorer(model, window_batch=args.window_batch).eval()
    rgbs = tuple(r for r, _ in videos)
    ops = tuple(o for _, o in videos)

    def score_pass():
        with torch.no_grad():
            return scorer(rgbs, ops)

    out = score_pass()  # warm: cuDNN's algorithm choice, the allocator
    if not torch.isfinite(out).all():
        raise RuntimeError("device_bench: non-finite scores")
    hb("warm pass done")
    n_windows = args.frames - 5 + 1
    frames_per_pass = args.chunk * args.frames
    times = _timed_passes(score_pass, args.passes, device, hb, "score")
    fps = statistics.median(frames_per_pass / dt for dt in times)
    result = {
        "metric": "device_resident_frames_per_sec",
        "value": fps,
        "unit": "frames/sec/card",
        "windows_per_sec": fps / frames_per_pass * args.chunk * n_windows,
        "pass_s": times,
        "forward": forward,
        "card": card_name(device),
        "config": {"chunk": args.chunk, "frames": args.frames,
                   "size": args.size, "window_batch": args.window_batch,
                   "passes": args.passes},
    }

    if args.otf:
        from ..eval.infer import make_otf_flow_extractor
        from ..models import init_flownet_weights
        from ..models.flownet_sd import FlowNet2SD

        flownet = init_flownet_weights(FlowNet2SD(),
                                       torch.Generator().manual_seed(1))
        flownet.to(device).eval().requires_grad_(False)
        extractor = make_otf_flow_extractor(flownet, pad_to=args.frames,
                                            gray=True)
        raw = [torch.randint(0, 255, (args.true_frames, args.size, args.size,
                                      1), generator=g, device=device,
                             dtype=torch.uint8) for _ in range(args.chunk)]

        def otf_pass():
            pairs = [extractor(r) for r in raw]
            with torch.no_grad():
                return scorer(tuple(r for r, _ in pairs),
                              tuple(o for _, o in pairs))

        otf_pass()
        hb("otf warm pass done")
        otf_times = _timed_passes(otf_pass, args.passes, device, hb, "otf")
        otf_fps = statistics.median(frames_per_pass / dt for dt in otf_times)
        result["otf_frames_per_sec"] = otf_fps
        # the extractor's seconds a pass, by difference
        result["extract_seconds_per_pass"] = (frames_per_pass / otf_fps
                                              - frames_per_pass / fps)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
