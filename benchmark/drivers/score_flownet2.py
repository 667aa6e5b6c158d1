"""Scoring with FlowNet 2.0 as the flow extractor: ``drivers/score.py``'s
closed loop (its ``Loop``, ``Unit`` and ``sample_ids``), one client, one
video at a time, with the flows made on the card by the port's
``models/flownet2.py:FlowNet2`` (``eval/infer.make_otf_flow_extractor``)
and scored by the calibrated int8 forward, as ``run_test --int8
--on_the_fly_flow --flownet FlowNet2 --gray_upload`` serves them.

The configuration's ``flownet`` names the network; FlowNet 2.0's weights
are made from the seed on the reference's modules and served in its
``compute_dtype`` (bf16), to the program and to the reference alike.  The
int8 forward calibrates on the seeded training split's clips, whose flows
the reference FlowNet 2.0 makes in float32 at set-up from the clips'
frames, as a deployment's ``.flo`` files were made offline.

The check, after the window, on a seeded sample of the split's videos as
the window first scored each: the extractor's flows against the reference
FlowNet 2.0's in float32, pair by pair (``flow_gap``, the widest pair's
L2 gap over the reference's norm), and the records against the int8
reference fed the extractor's flows (``score.py``'s rows).  Controls
(``spec.control``): ``"int4"``, the int8 reference at int4 in the
program's place, and ``"fp8_flow"``, the reference FlowNet 2.0 with every
convolution in float8 e4m3 in the extractor's.

``mfu.score`` reads ``window_flops / window_s / peak_flops``; here the two
networks run at two peaks, so ``window_flops`` is the window's time at
peak times the configuration's peak (the int8 one): the generator's FLOPs
at 1,979 TOP/s plus FlowNet 2.0's at 989 TFLOP/s (bf16), each of its
FLOPs counted as ``peak_flops / 989e12`` of one.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import seeding, tracing
from ..counts import flownet2 as flow_counts
from ..counts import int8 as int8_counts
from ..counts import lookup as lookup_counts
from ..counts import model as model_counts
from ..counts.peaks import BF16_FLOPS
from ..harness import (Outcome, Phases, Readings, Spec, checks,
                       float32_exact)
from ..reference import flownet2 as ref_flownet2
from ..reference import model as ref
from ..reference import quantized as ref_quant
from ..reference import score as ref_score
from ..reference.precision import fp8_e4m3
from .score import (RGB_CLIP, ROWS, Loop, Unit, _pair_gaps, _window_gaps,
                    sample_ids)

FLOWNETS = {"FlowNet2": ref_flownet2.FlowNet2}
CALIB_FLOWS = RGB_CLIP - 2  # the op clip's input flows: 3 of its 4


def _reference_flownet(config: dict, state=None, device="meta"):
    fn = config["flownet"]
    try:
        cls = FLOWNETS[fn["net"]]
    except KeyError:
        raise ValueError(f"this driver runs {sorted(FLOWNETS)}, not "
                         f"{fn['net']!r}") from None
    with torch.device(device):
        net = cls(div_flow=fn["div_flow"], rgb_max=fn["rgb_max"]).eval()
    if state is not None:
        seeding.load_state(net, state)
    return net


def _states(config: dict, seed: int, device) -> Dict[str, dict]:
    """The generator's float32 weights (the int8 program quantizes them)
    and FlowNet 2.0's, rounded to its compute type."""
    return {"generator": seeding.make_state(
                model_counts.build_generator(config["net"], True), seed,
                "generator", device),
            "flownet": seeding.as_served(
                seeding.make_state(_reference_flownet(config), seed,
                                   "flownet", device),
                config["flownet"]["compute_dtype"])}


def _calibration(config: dict, seed: int, device, frames: str, flownet):
    """``run_test --int8``'s calibration clips from the seeded training
    split, their flows the reference FlowNet 2.0's on the clips' frames,
    normalized as the ``.flo`` loader normalizes them."""
    split = seeding.TrainSplit(config["train_split"]["lengths"],
                               config["net"]["image_size"], seed, device,
                               frames=frames)
    rng = seeding.numpy_rng(seed, "sample")
    cal = config["calibration"]
    batches = []
    with float32_exact(), torch.no_grad():
        for _ in range(cal["batches"]):
            rgb_u8 = split.gather(split.draw(rng, cal["batch"], set()))["rgb"]
            rgb = rgb_u8.float() / 255.0
            rgb = ((rgb - 0.5) / 0.5).permute(0, 1, 4, 2, 3).flatten(1, 2)
            op = torch.stack([ref_score.otf_flows(flownet, clip,
                                                  CALIB_FLOWS)
                              for clip in rgb_u8])  # (b, 3, h, w, 2)
            op = op.permute(0, 1, 4, 2, 3).flatten(1, 2)
            batches.append((rgb[:, :12].contiguous(), op.contiguous()))
    return batches


def _program(spec: Spec, states, calib):
    """The port's int8 scorer and its FlowNet 2.0 extractor on the run's
    weights."""
    from ammcnet_aaai2021_torch.configs import NetConfig
    from ammcnet_aaai2021_torch.eval.export import ChunkScorer
    from ammcnet_aaai2021_torch.eval.infer import make_otf_flow_extractor
    from ammcnet_aaai2021_torch.models import build_generator
    from ammcnet_aaai2021_torch.models.flownet2 import FlowNet2
    from ammcnet_aaai2021_torch.models.quantized import (
        calibrate_act_scales, make_quantized_forward,
        quantize_twostream_variables)

    net, dev, fn = spec.config["net"], spec.device, spec.config["flownet"]
    cfg = NetConfig(net_tag=net["net_tag"],
                    in_channel=tuple(net["in_channel"]),
                    out_channel=tuple(net["out_channel"]),
                    embed_dim=net["embed_dim"], n_embed=net["n_embed"],
                    k=net["k"], image_size=net["image_size"],
                    dtype=spec.config["compute_dtype"])
    with torch.device(dev):
        gen = build_generator(cfg, per_sample_diff=True)
    seeding.load_state(gen, states["generator"])
    gen.eval()
    kw = dict(embed_dim=net["embed_dim"], n_embed=net["n_embed"], k=net["k"],
              per_sample_diff=True, use_kernel=True)
    qvars = quantize_twostream_variables(gen.state_dict())
    qfwd = make_quantized_forward(qvars, **kw).to(dev)
    qcal = calibrate_act_scales(qfwd, qvars, calib)
    model = make_quantized_forward(qcal, **kw).to(dev)
    del gen, qfwd
    with torch.device(dev):
        flownet = FlowNet2(div_flow=fn["div_flow"], rgb_max=fn["rgb_max"],
                           dtype=getattr(torch, fn["compute_dtype"]))
    seeding.load_state(flownet, states["flownet"])
    flownet.eval().requires_grad_(False)
    extractor = make_otf_flow_extractor(
        flownet, reproduce_flow_bug=fn["reproduce_flow_bug"],
        chunk=spec.mix["flow_chunk"], pad_to=spec.mix["pad_to"],
        gray=spec.mix["channels"] == 1)
    scorer = ChunkScorer(model, window_batch=spec.mix["window_batch"]).eval()
    return scorer, extractor


def check(spec: Spec, units: List[Unit], videos, states, calib, kept
          ) -> Dict[str, float]:
    """The extractor's flows of a seeded sample of the scored videos
    against the reference FlowNet 2.0's (the widest pair's gap), and the
    records against the int8 reference fed those flows (each row's widest
    window gap); the controls as the module's note says."""
    dev, net = spec.device, spec.config["net"]
    by_video: Dict[int, Unit] = {}
    for u in units:
        by_video.setdefault(u.video, u)
    picks = [i for i in sample_ids(videos, spec.seed,
                                   spec.mix["check_videos"])
             if i in by_video]
    chunk = spec.mix["flow_chunk"]
    with float32_exact(), torch.no_grad():
        gen = model_counts.build_generator(net, True, device=dev)
        seeding.load_state(gen, states["generator"])
        gen.eval()

        def quantized(qmax: int):
            q = ref_quant.QuantizedReference(
                states["generator"], ref_quant.memories(gen), qmax)
            q.calibrate(calib)
            return q

        forward = quantized(127)
        control = quantized(7) if spec.control == "int4" else None
        flownet = _reference_flownet(spec.config, states["flownet"], dev)
        per_window, per_pair = [], []
        for vid in picks:
            v = videos[vid]
            t = v["true_frames"]
            rgb = v["rgb"][:t].to(dev)
            if rgb.shape[-1] == 1:
                rgb = rgb.expand(*rgb.shape[:-1], 3)
            flows = kept[vid][:t - 1].float()
            judged = flows
            if spec.control == "fp8_flow":
                ref.set_fake(flownet, fp8_e4m3)
                judged = ref_score.otf_flows(flownet, rgb, t - 1, chunk)
                ref.set_fake(flownet, None)
            per_pair.append(_pair_gaps(judged, ref_score.otf_flows(
                flownet, rgb, t - 1, chunk)))
            n = t - RGB_CLIP + 1
            refr = ref_score.records(forward, rgb, flows, n).cpu().numpy()
            prog = (by_video[vid].records if control is None else
                    ref_score.records(control, rgb, flows, n).cpu().numpy())
            per_window.append(_window_gaps(prog, refr))
    gaps = np.concatenate(per_window, axis=1)
    pairs = np.concatenate(per_pair)
    values = {name: float(gaps[row].max()) for row, name in enumerate(ROWS)}
    values["flow_gap"] = float(pairs.max())
    if spec.diagnose:
        for row, name in enumerate(ROWS):
            values[name + ".median"] = float(np.median(gaps[row]))
        values["flow_gap.median"] = float(np.median(pairs))
    return values


def run(spec: Spec) -> Outcome:
    dev = torch.device(spec.device)
    cuda = dev.type == "cuda"
    cfg, mix = spec.config, spec.mix
    phases = Phases(spec.t_process)
    states = _states(cfg, spec.seed, dev)
    phases.mark("weights")
    frames = mix.get("frames", "uniform")
    calib = _calibration(cfg, spec.seed, dev, frames, _reference_flownet(
        cfg, states["flownet"], dev))
    videos = seeding.make_videos(mix["lengths"], cfg["net"]["image_size"],
                                 mix["channels"], False, mix["bucket"],
                                 spec.seed, dev, pin=cuda, frames=frames)
    phases.mark("data")
    scorer, extractor = _program(spec, states, calib)
    phases.mark("program")
    timers = tracing.Timers(dev)
    loop = Loop(spec, videos, scorer, extractor, timers,
                keep=sample_ids(videos, spec.seed, mix["check_videos"]))
    # warm-up: every padded length the split has, once, and one more
    lengths = sorted({v["rgb"].shape[0] for v in videos})
    warm = [next(i for i, v in enumerate(videos) if v["rgb"].shape[0] == L)
            for L in lengths]
    for vid in warm + warm[:1]:
        loop.order = [vid]
        loop.serve(lambda n: True, timed=False)
    loop.order = []
    if cuda:
        torch.cuda.synchronize(dev)
    phases.mark("warmup")
    t_start = time.perf_counter()
    setup_s = t_start - spec.t_process
    deadline = t_start + spec.seconds
    units = loop.serve(lambda n: time.perf_counter() >= deadline, timed=True)
    window_s = units[-1].t_done - t_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    readings = Readings(kind="score", timings=timers.seconds(),
                        window_s=window_s, peak_flops=cfg["peak_flops"])
    true_windows = sum(videos[u.video]["true_frames"] - RGB_CLIP + 1
                       for u in units)
    net, size = cfg["net"], cfg["net"]["image_size"]
    gen_flops = true_windows * model_counts.generator_forward_flops(
        net["net_tag"], tuple(net["in_channel"]), tuple(net["out_channel"]),
        net["embed_dim"], net["n_embed"], net["k"], size)
    flow_flops = sum(videos[u.video]["true_frames"] - 1 for u in units
                     ) * flow_counts.pair_flops(size)
    readings.window_flops = gen_flops + flow_flops * (cfg["peak_flops"]
                                                      / BF16_FLOPS)
    # the correlation's calls a video: the padded video's pairs in chunks
    n_pairs, chunk = mix["pad_to"] - 1, mix["flow_chunk"]
    calls = [min(chunk, n_pairs - s) for s in range(0, n_pairs, chunk)]
    wb, side = mix["window_batch"], size // 8
    readings.bounds = {
        "b1_call_s": lookup_counts.b1_bound_s(wb * side * side,
                                              net["embed_dim"],
                                              net["n_embed"], net["k"]),
        "correlation_call_s": sum(flow_counts.correlation_bound_s(b, size)
                                  for b in calls) / len(calls),
        # the int8 forward's convolutions, as drivers/score.py bounds them
        "qconv3x3_forward_s": int8_counts.forward_bound_s(wb, False, net,
                                                          size),
        "qconv3x3_calls": int8_counts.calls(net, False, size),
        "qconvT2x2_forward_s": int8_counts.forward_bound_s(wb, True, net,
                                                           size),
        "qconvT2x2_calls": int8_counts.calls(net, True, size)}
    if spec.trace:
        seg = tracing.Segment(dev)
        loop.traced = True
        with seg.run():
            traced = loop.serve(lambda n: n >= mix["trace_videos"],
                                timed=False)
        loop.traced = False
        readings.trace, readings.traced_units = seg.summary, len(traced)
    lat = [u.t_done - u.t_upload for u in units]
    e2e = {"score_fps": true_windows / window_s,
           "video_latency_p90_ms": float(np.percentile(lat, 90)) * 1e3,
           "peak_mem_gib": peak / 2 ** 30,
           "setup_s": setup_s}

    kept = loop.kept
    del scorer, extractor, loop
    if cuda:
        torch.cuda.empty_cache()
    values = check(spec, units, videos, states, calib, kept)
    return Outcome(attempted=len(units), failed=0,
                   checks=checks(values, spec.limits), e2e=e2e,
                   readings=readings, memory_peak_bytes=int(peak),
                   values=values, setup_phases=phases.seconds)
