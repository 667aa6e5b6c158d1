"""Scoring mixes: a split of test videos scored one at a time, closed loop,
one client, through the port's chunk scorer (``eval/export.ChunkScorer``),
with on-the-fly FlowNet2-SD flows (``eval/infer.make_otf_flow_extractor``)
or with given flows, on the bf16 generator or the calibrated int8 forward.

Each video: launch its scoring; queue the upload (and flow extraction) of
the next behind it; fetch its records once.  Videos come in seeded passes
over the split until the window ends.  The correctness check runs the
plain float32 reference (``benchmark/reference``) over a seeded sample of
the split's videos, the longest among them, as the window first scored
each, and compares their records window by window.  With flows made on
the card it checks the two stages apart: the flows the extractor made for
those videos against the reference's FlowNet2-SD, pair by pair, and the
records against the reference's generator fed those same flows (compared
end to end, the bf16 FlowNet2-SD's rounding, which reaches both streams
through the bridge, hides the generator's: PERF.md section 6).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import seeding, tracing
from ..counts import int8 as int8_counts
from ..counts import lookup as lookup_counts
from ..counts import model as model_counts
from ..harness import (Outcome, Phases, Readings, Spec, checks,
                       float32_exact)
from ..reference import model as ref
from ..reference import quantized as ref_quant
from ..reference.precision import fp8_e4m3
from ..reference import score as ref_score

RGB_CLIP, OP_CLIP = 5, 4


class Unit:
    """One scored video."""

    def __init__(self, video: int, t_upload: float):
        self.video, self.t_upload = video, t_upload
        self.t_done = 0.0
        self.records: Optional[np.ndarray] = None


def _states(config: dict, otf: bool, seed: int, device) -> Dict[str, dict]:
    """The run's weights, made from the seed on the reference's modules:
    the generator's, and FlowNet2-SD's where the mix makes its flows.  A
    configuration served in its compute type (not int8, whose program
    quantizes the float32 weights itself) holds weights of that type."""
    states = {"generator": seeding.make_state(
        model_counts.build_generator(config["net"], True), seed, "generator",
        device)}
    if otf:
        with torch.device("meta"):
            flownet = ref.FlowNet2SD()
        states["flownet"] = seeding.make_state(flownet, seed, "flownet",
                                               device)
    if not config.get("int8"):
        states = {k: seeding.as_served(v, config["compute_dtype"])
                  for k, v in states.items()}
    return states


def _calibration(config: dict, seed: int, device, frames: str):
    """The calibration clips ``run_test --int8`` would draw from the
    training split, drawn from the configuration's seeded split (its
    frames of the mix's kind)."""
    split = seeding.TrainSplit(config["train_split"]["lengths"],
                               config["net"]["image_size"], seed, device,
                               frames=frames)
    cal = config["calibration"]
    batches = split.calibration_batches(seeding.numpy_rng(seed, "sample"),
                                        cal["batches"], cal["batch"])
    del split
    return batches


def _program(spec: Spec, states, calib, int8: bool):
    """The port's scorer (and flow extractor) on the run's weights."""
    from ammcnet_aaai2021_torch.configs import NetConfig
    from ammcnet_aaai2021_torch.eval.export import ChunkScorer
    from ammcnet_aaai2021_torch.eval.infer import make_otf_flow_extractor
    from ammcnet_aaai2021_torch.models import build_generator
    from ammcnet_aaai2021_torch.models.flownet_sd import FlowNet2SD

    net, dev = spec.config["net"], spec.device
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
    model = gen
    if int8:
        from ammcnet_aaai2021_torch.models.quantized import (
            calibrate_act_scales, make_quantized_forward,
            quantize_twostream_variables)

        kw = dict(embed_dim=net["embed_dim"], n_embed=net["n_embed"],
                  k=net["k"], per_sample_diff=True, use_kernel=True)
        qvars = quantize_twostream_variables(gen.state_dict())
        qfwd = make_quantized_forward(qvars, **kw).to(dev)
        qcal = calibrate_act_scales(qfwd, qvars, calib)
        model = make_quantized_forward(qcal, **kw).to(dev)
        del gen, qfwd
    extractor = None
    if spec.mix["flows"] == "otf":
        with torch.device(dev):
            flownet = FlowNet2SD()
        seeding.load_state(flownet, states["flownet"])
        flownet.eval().requires_grad_(False)
        extractor = make_otf_flow_extractor(
            flownet, reproduce_flow_bug=True, pad_to=spec.mix["pad_to"],
            gray=spec.mix["channels"] == 1)
    scorer = ChunkScorer(model, window_batch=spec.mix["window_batch"]).eval()
    return scorer, extractor


class Loop:
    """The closed loop over the split."""

    def __init__(self, spec: Spec, videos, scorer, extractor, timers,
                 traced: bool = False, keep=()):
        self.spec, self.videos = spec, videos
        self.scorer, self.extractor = scorer, extractor
        self.timers, self.traced = timers, traced
        self.rng = seeding.numpy_rng(spec.seed, "order")
        self.order: List[int] = []
        # the flows the extractor made for each video in ``keep`` at its
        # first timed scoring (a reference to the tensor: no work)
        self.keep, self.kept = set(keep), {}

    def next_video(self) -> int:
        if not self.order:
            self.order = list(self.rng.permutation(len(self.videos)))
        return int(self.order.pop(0))

    def upload(self, vid: int, timed: bool):
        dev = self.spec.device
        with tracing.span("upload", self.traced):
            v = self.videos[vid]
            rgb = v["rgb"].to(dev, non_blocking=True)
            op = (v["op"].to(dev, non_blocking=True) if v["op"] is not None
                  else None)
        if self.extractor is not None:
            with tracing.span("extract", self.traced):
                if timed:
                    with self.timers.time("flow"):
                        rgb, op = self.extractor(rgb)
                else:
                    rgb, op = self.extractor(rgb)
            if timed and vid in self.keep and vid not in self.kept:
                self.kept[vid] = op
        return rgb, op

    def serve(self, stop, timed: bool) -> List[Unit]:
        """Score videos until ``stop(units_done)`` says not to start
        another; returns the units, each fetched."""
        units: List[Unit] = []
        vid = self.next_video()
        unit = Unit(vid, time.perf_counter())
        cur = self.upload(vid, timed)
        with torch.inference_mode():
            while True:
                with tracing.span("score", self.traced):
                    if timed:
                        with self.timers.time("score"):
                            out = self.scorer((cur[0],), (cur[1],))
                    else:
                        out = self.scorer((cur[0],), (cur[1],))
                nxt = None
                if not stop(len(units) + 1):
                    nvid = self.next_video()
                    nunit = Unit(nvid, time.perf_counter())
                    nxt = self.upload(nvid, timed)
                n = self.videos[unit.video]["true_frames"] - RGB_CLIP + 1
                with tracing.span("fetch", self.traced):
                    unit.records = out[0, :, :n].cpu().numpy()
                unit.t_done = time.perf_counter()
                units.append(unit)
                if nxt is None:
                    return units
                cur, unit = nxt, nunit


ROWS = ("rgb_psnr_gap_db", "rgb_commit_gap", "op_psnr_gap_db",
        "op_commit_gap")


def _window_gaps(prog: np.ndarray, refr: np.ndarray) -> np.ndarray:
    """(4, windows): the PSNR rows' gaps in dB, the commit rows' relative
    to the reference."""
    gaps = np.abs(prog - refr)
    gaps[1::2] /= np.maximum(np.abs(refr[1::2]), 1e-30)
    return gaps


def sample_ids(videos, seed: int, n: int) -> List[int]:
    """A seeded sample of ``n`` distinct videos of the split, one of the
    longest first (a window of the cell's length scores every video)."""
    rng = seeding.numpy_rng(seed, "check")
    longest = max(v["true_frames"] for v in videos)
    first = int(rng.choice([i for i, v in enumerate(videos)
                            if v["true_frames"] == longest]))
    rest = [i for i in range(len(videos)) if i != first]
    return [first] + [int(i) for i in rng.permutation(rest)[:n - 1]]


def _pair_gaps(flows: torch.Tensor, refr: torch.Tensor) -> np.ndarray:
    """Each frame pair's flow gap: the L2 norm of the difference over the
    reference's."""
    diff = torch.linalg.vector_norm((flows - refr).flatten(1), dim=1)
    norm = torch.linalg.vector_norm(refr.flatten(1), dim=1)
    return (diff / norm.clamp_min(1e-30)).cpu().numpy()


def check(spec: Spec, units: List[Unit], videos, states, calib, kept
          ) -> Dict[str, float]:
    """The reference's records of a seeded sample of the scored videos
    against the program's (each row's widest window gap), and with flows
    made on the card the program's flows against the reference's (the
    widest pair's gap).  Controls: ``"int4"`` puts the int4 reference in
    the program's place, ``"fp8_gen"`` the reference's generator with
    every convolution in float8 e4m3, ``"fp8_flow"`` the reference's
    FlowNet2-SD so in the extractor's."""
    dev, net = spec.device, spec.config["net"]
    by_video: Dict[int, Unit] = {}
    for u in units:
        by_video.setdefault(u.video, u)
    picks = [i for i in sample_ids(videos, spec.seed,
                                   spec.mix["check_videos"])
             if i in by_video]
    with float32_exact(), torch.no_grad():
        gen = model_counts.build_generator(net, True, device=dev)
        seeding.load_state(gen, states["generator"])
        gen.eval()

        def quantized(qmax: int):
            q = ref_quant.QuantizedReference(
                states["generator"], ref_quant.memories(gen), qmax)
            q.calibrate(calib)
            return q

        forward = quantized(127) if spec.config.get("int8") else gen
        control = quantized(7) if spec.control == "int4" else None
        flownet = None
        if spec.mix["flows"] == "otf":
            with torch.device(dev):
                flownet = ref.FlowNet2SD()
            seeding.load_state(flownet, states["flownet"])
            flownet.eval()
        per_window, per_pair = [], []
        for vid in picks:
            v = videos[vid]
            t = v["true_frames"]
            rgb = v["rgb"][:t].to(dev)
            if rgb.shape[-1] == 1:
                rgb = rgb.expand(*rgb.shape[:-1], 3)
            if flownet is not None:
                flows = kept[vid][:t - 1].float()
                judged = flows
                if spec.control == "fp8_flow":
                    ref.set_fake(flownet, fp8_e4m3)
                    judged = ref_score.otf_flows(flownet, rgb, t - 1)
                    ref.set_fake(flownet, None)
                per_pair.append(_pair_gaps(judged, ref_score.otf_flows(
                    flownet, rgb, t - 1)))
            else:
                flows = v["op"][:t - 1].to(dev).float()
            n = t - RGB_CLIP + 1
            refr = ref_score.records(forward, rgb, flows, n).cpu().numpy()
            prog = by_video[vid].records
            if control is not None:
                prog = ref_score.records(control, rgb, flows, n).cpu().numpy()
            elif spec.control == "fp8_gen":
                ref.set_fake(gen, fp8_e4m3)
                prog = ref_score.records(gen, rgb, flows, n).cpu().numpy()
                ref.set_fake(gen, None)
            per_window.append(_window_gaps(prog, refr))
    gaps = np.concatenate(per_window, axis=1)
    values = {name: float(gaps[row].max()) for row, name in enumerate(ROWS)}
    if per_pair:
        values["flow_gap"] = float(np.concatenate(per_pair).max())
    if spec.diagnose:
        for row, name in enumerate(ROWS):
            values[name + ".median"] = float(np.median(gaps[row]))
        if per_pair:
            values["flow_gap.median"] = float(np.median(
                np.concatenate(per_pair)))
    return values


def run(spec: Spec) -> Outcome:
    dev = torch.device(spec.device)
    cuda = dev.type == "cuda"
    cfg, mix = spec.config, spec.mix
    int8 = cfg.get("int8", False) or spec.control == "int8"
    phases = Phases(spec.t_process)
    states = _states(cfg, mix["flows"] == "otf", spec.seed, dev)
    phases.mark("weights")
    frames = mix.get("frames", "uniform")
    calib = (_calibration(cfg, spec.seed, dev, frames)
             if int8 or spec.control == "int4" else None)
    videos = seeding.make_videos(mix["lengths"], cfg["net"]["image_size"],
                                 mix["channels"], mix["flows"] == "given",
                                 mix["bucket"], spec.seed, dev, pin=cuda,
                                 frames=frames)
    phases.mark("data")
    scorer, extractor = _program(spec, states, calib, int8)
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
    net = cfg["net"]
    flops = true_windows * model_counts.generator_forward_flops(
        net["net_tag"], tuple(net["in_channel"]), tuple(net["out_channel"]),
        net["embed_dim"], net["n_embed"], net["k"], net["image_size"])
    if extractor is not None:
        flops += sum(videos[u.video]["true_frames"] - 1 for u in units
                     ) * model_counts.flownet_pair_flops(net["image_size"])
    readings.window_flops = flops
    wb, side = mix["window_batch"], net["image_size"] // 8
    readings.bounds = {
        "b1_call_s": lookup_counts.b1_bound_s(wb * side * side,
                                              net["embed_dim"],
                                              net["n_embed"], net["k"])}
    if int8:
        size = net["image_size"]
        readings.bounds.update(
            qconv3x3_forward_s=int8_counts.forward_bound_s(wb, False, net,
                                                           size),
            qconv3x3_calls=int8_counts.calls(net, False, size),
            qconvT2x2_forward_s=int8_counts.forward_bound_s(wb, True, net,
                                                            size),
            qconvT2x2_calls=int8_counts.calls(net, True, size))
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
