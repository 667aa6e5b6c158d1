"""Training mixes: the port's stage-2 step (``train/steps.py:
make_twostream_train_step``) driven by its own loop (``train/loop.py:
train_loop``) on a seeded, device-resident training split, with the
released recipe (Adam, lr_g 2e-4, lr_d 2e-5, the ``twostream_vq`` loss,
the FlowNet2-SD teacher) and ``run_train``'s PSNR forward every
``step_log`` steps.

Set-up builds one training state from the seed and drives it through its
first steps with the window's own step, loop and feed (the first three
batches' rows all differ); the window then continues that same state.  The
step passed to the loop is a thin wrapper that times each call on the host
and, after steps 1 and 3, reads what the correctness check compares: each
memory's cluster sizes after step 1 (B2's counts) and each leaf's change
after three steps.  The check replays those three steps with the plain
float32 reference from the same weights and batches.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .. import seeding, tracing
from ..counts import lookup as lookup_counts
from ..counts import model as model_counts
from ..harness import (Outcome, Phases, Readings, Spec, checks,
                       float32_exact)
from ..reference import model as ref
from ..reference import train as ref_train

COMPARED_STEPS = 3
BETA1 = 0.9
# the port's training step for each kind of generator
# (``counts/model.py:GENERATORS``)
STEPS = {"twostream": "make_twostream_train_step"}
# buffers whose change is compared: BatchNorm's running statistics and
# what B2's counts and sums feed (the codeword itself, ``embed``, is their
# quotient and jumps by ~1e5 for a codeword no row picked, so one near-tie
# pick would decide it)
BUFFERS = ("running_mean", "running_var", "cluster_size", "embed_avg")


def _states(cfg: dict, seed: int, device) -> Dict[str, dict]:
    net = cfg["net"]
    with torch.device("meta"):
        disc = ref.PixelDiscriminator(tuple(cfg["disc_filters"]),
                                      net["out_channel"][0])
        flownet = ref.FlowNet2SD()
    return {"generator": seeding.make_state(
                model_counts.build_generator(net, False), seed, "generator",
                device),
            "discriminator": seeding.make_state(disc, seed, "discriminator",
                                                device),
            "flownet": seeding.make_state(flownet, seed, "flownet", device)}


def _leaves(gen, disc, with_buffers: bool) -> Dict[str, torch.Tensor]:
    out = {f"g.{k}": p for k, p in gen.named_parameters()}
    out.update({f"d.{k}": p for k, p in disc.named_parameters()})
    if with_buffers:
        out.update({f"g.{k}": b for k, b in gen.named_buffers()
                    if k.rsplit(".", 1)[-1] in BUFFERS})
    return out


def _counts(gen) -> Dict[str, torch.Tensor]:
    """Each memory's EMA cluster sizes, a copy on the host: after the first
    step from zero they are 0.01 x the rows each codeword's top-1 pick
    took (B2's counts)."""
    return {k: b.detach().to("cpu", copy=True)
            for k, b in gen.named_buffers() if k.endswith("cluster_size")}


def _initial(states, key: str) -> torch.Tensor:
    side, name = key.split(".", 1)
    return states["generator" if side == "g" else "discriminator"][name]


class Probe:
    """The step the loop calls: the port's step, timed on the host, with
    the first steps' readings taken after it (with ``diagnose``, also the
    losses and the first gradient as Adam got it, from its first
    moment)."""

    def __init__(self, step_fn, states, diagnose: bool = False):
        self.step_fn, self.states, self.diagnose = step_fn, states, diagnose
        self.timing = self.traced = False
        self.enqueue_s: List[float] = []
        self.losses: List[torch.Tensor] = []
        self.grad1: Dict[str, torch.Tensor] = {}
        self.counts1: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, torch.Tensor] = {}

    def __call__(self, state, batch, flownet):
        t0 = time.perf_counter()
        with tracing.span("step", self.traced):
            metrics = self.step_fn(state, batch, flownet)
        if self.timing:
            self.enqueue_s.append(time.perf_counter() - t0)
        if state.step <= COMPARED_STEPS:
            self._read(state, metrics)
        return metrics

    @torch.no_grad()
    def _read(self, state, metrics) -> None:
        gen, disc = state.generator, state.discriminator
        if self.diagnose:
            self.losses.append(torch.stack([metrics["g_loss"].float(),
                                            metrics["d_loss"].float()]))
        if state.step == 1 and self.diagnose:
            for key, p in _leaves(gen, disc, False).items():
                opt = state.g_opt if key.startswith("g.") else state.d_opt
                self.grad1[key] = torch.linalg.vector_norm(
                    opt.state[p]["exp_avg"] / (1 - BETA1))
        if state.step == 1:
            self.counts1 = _counts(gen)
        if state.step == COMPARED_STEPS:
            for key, t in _leaves(gen, disc, True).items():
                self.change[key] = torch.linalg.vector_norm(
                    t.float() - _initial(self.states, key))


def _feed(split, rng, batch: int, first_rows: List, stop):
    """Batches of the split until ``stop()``; the first ``COMPARED_STEPS``
    batches' rows all differ and are kept in ``first_rows``."""
    distinct: set = set()
    while not stop():
        first = len(first_rows) < COMPARED_STEPS
        rows = split.draw(rng, batch, distinct if first else set())
        if first:
            first_rows.append(rows)
        yield split.gather(rows)


def _relative_gaps(prog: Dict[str, float], refr: Dict[str, float],
                   keys) -> float:
    """The worst leaf's gap between the two sides' norms, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    keys = list(keys)
    med = float(np.median([refr[k] for k in keys]))
    return max(abs(prog[k] - refr[k]) / max(refr[k], med) for k in keys)


def reference_readings(states, cfg, batches, fake=None, grad_fake=None
                       ) -> dict:
    """Three reference steps from the run's weights on the run's first
    batches: the losses, the first gradient's norm by leaf, each leaf's
    change after the three.  ``fake``, ``grad_fake``: the lower-precision
    control's quantizers on every convolution (its operands, the gradient
    of its output)."""
    net = cfg["net"]
    dev = batches[0]["rgb"].device
    gen = model_counts.build_generator(net, False, device=dev)
    with torch.device(dev):
        disc = ref.PixelDiscriminator(tuple(cfg["disc_filters"]),
                                      net["out_channel"][0])
        flownet = ref.FlowNet2SD()
    for m, key in ((gen, "generator"), (disc, "discriminator"),
                   (flownet, "flownet")):
        seeding.load_state(m, states[key])
        ref.set_fake(m, fake, grad_fake)
    flownet.eval().requires_grad_(False)
    disc.train()
    g_opt = ref_train.make_adam(gen.parameters(), cfg["optim"]["lr_g"])
    d_opt = ref_train.make_adam(disc.parameters(), cfg["optim"]["lr_d"])
    losses, grad1, counts1 = [], {}, {}
    with float32_exact():
        for i, batch in enumerate(batches):
            g_loss, d_loss, g_grads, d_grads = ref_train.train_step(
                gen, disc, flownet, g_opt, d_opt, batch)
            losses.append([float(g_loss), float(d_loss)])
            if i == 0:
                names = [f"g.{k}" for k, _ in gen.named_parameters()] + [
                    f"d.{k}" for k, _ in disc.named_parameters()]
                grad1 = {k: float(torch.linalg.vector_norm(g)) for k, g in
                         zip(names, list(g_grads) + list(d_grads))}
                counts1 = _counts(gen)
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(
                      t.float() - _initial(states, k)))
                  for k, t in _leaves(gen, disc, True).items()}
    return {"losses": losses, "grad1": grad1, "change": change,
            "counts1": counts1}


def _moved(refr: dict):
    """The leaves whose change is compared: those whose reference gradient
    is at least a thousandth of the median leaf's (the others move by
    round-off alone under Adam), and the buffers."""
    g_ref = refr["grad1"]
    med = float(np.median(list(g_ref.values())))
    return [k for k in refr["change"]
            if k not in g_ref or g_ref[k] >= 1e-3 * med]


def compare(prog: dict, refr: dict) -> Dict[str, float]:
    """The numbers that decide ``correct``: the worst leaf's relative gap
    of the change after the compared steps, and the share of the first
    step's rows whose nearest codeword differs (each moved row counts
    twice in the L1 difference of the cluster sizes)."""
    return {"change_gap": _relative_gaps(prog["change"], refr["change"],
                                         _moved(refr)),
            "pick_gap": max(
                float((prog["counts1"][k] - c).abs().sum() / c.abs().sum())
                for k, c in refr["counts1"].items())}


def diagnostics(prog: dict, refr: dict) -> Dict[str, float]:
    """Readings that decide nothing (``benchmark/control.py`` prints them;
    PERF.md gives why none is compared): the worst relative gap of the
    compared steps' G and D losses, of the first gradient's norm by leaf,
    the first step's losses alone, and the median leaf's gaps."""
    losses = max(abs(p - r) / abs(r) for ps, rs in zip(prog["losses"],
                                                     refr["losses"])
                 for p, r in zip(ps, rs))
    g_ref = refr["grad1"]
    (pg, pd), (rg, rd) = prog["losses"][0], refr["losses"][0]
    return {"loss_gap": losses,
            "grad1_gap": _relative_gaps(prog["grad1"], g_ref, g_ref),
            "g_loss1_gap": abs(pg - rg) / abs(rg),
            "d_loss1_gap": abs(pd - rd) / abs(rd),
            "grad1_gap_median_leaf": float(np.median(
                [abs(prog["grad1"][k] - g_ref[k]) / max(g_ref[k], 1e-30)
                 for k in g_ref])),
            "change_gap_median_leaf": float(np.median(
                [abs(prog["change"][k] - refr["change"][k])
                 / max(refr["change"][k], 1e-30) for k in _moved(refr)]))}


def run(spec: Spec) -> Outcome:
    from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
    from ammcnet_aaai2021_torch.models import build_model
    from ammcnet_aaai2021_torch.ops.metrics import psnr_per_frame
    from ammcnet_aaai2021_torch.train import steps as steps_mod
    from ammcnet_aaai2021_torch.train.loop import train_loop
    from ammcnet_aaai2021_torch.train.optim import make_optimizers
    from ammcnet_aaai2021_torch.train.state import TrainState

    dev = torch.device(spec.device)
    cuda = dev.type == "cuda"
    cfg, mix = spec.config, spec.mix
    net, b = cfg["net"], mix["batch"]
    phases = Phases(spec.t_process)
    states = _states(cfg, spec.seed, dev)
    phases.mark("weights")
    split = seeding.TrainSplit(cfg["train_split"]["lengths"],
                               net["image_size"], spec.seed, dev)
    phases.mark("data")
    ncfg = NetConfig(net_tag=net["net_tag"],
                     in_channel=tuple(net["in_channel"]),
                     out_channel=tuple(net["out_channel"]),
                     embed_dim=net["embed_dim"], n_embed=net["n_embed"],
                     k=net["k"], image_size=net["image_size"],
                     dtype=cfg["compute_dtype"])
    with torch.device(dev):
        model = build_model(ncfg, mode="training", with_flow=True)
    gen, disc, flownet = (model.generator, model.discriminator,
                          model.flow_network)
    for m, key in ((gen, "generator"), (disc, "discriminator"),
                   (flownet, "flownet")):
        seeding.load_state(m, states[key])
    gen.train()
    disc.train()
    flownet.eval().requires_grad_(False)
    optim = OptimConfig(lr_g=cfg["optim"]["lr_g"], lr_d=cfg["optim"]["lr_d"],
                        batch_size=b)
    state = TrainState(0, gen, disc, *make_optimizers(optim, gen, disc))
    make_step = getattr(steps_mod, STEPS[model_counts.step_kind(net)])
    probe = Probe(make_step(LossConfig(loss_tag=cfg["loss_tag"])), states,
                  spec.diagnose)

    def psnr_fn(state, batch):
        # run_train's train PSNR: an eval-mode forward (B1), then back
        g = state.generator
        g.eval()
        try:
            with tracing.span("psnr", probe.traced), torch.no_grad():
                clip = steps_mod._to_model_range(batch["rgb"])
                op = steps_mod._to_model_range(batch["op"])
                pred = g(clip[:, :-3], op[:, :-2])[0]
        finally:
            g.train()
        return psnr_per_frame(pred, clip[:, -3:]).mean()

    phases.mark("program")
    rng = seeding.numpy_rng(spec.seed, "order")
    first_rows: List = []
    run_dir = tempfile.mkdtemp(prefix="bench_train_")

    def loop(until: int, stop):
        train_loop(state, probe, _feed(split, rng, b, first_rows, stop),
                   flownet, until, run_dir, psnr_fn=psnr_fn,
                   step_log=mix["step_log"], step_save=10 ** 9,
                   fetch_every_periods=mix["fetch_every_periods"])
        if cuda:
            torch.cuda.synchronize(dev)

    drawn = iter(range(mix["warmup_steps"]))
    try:
        # exactly the set-up's batches are drawn, so the window's draws
        # follow from the seed alone
        loop(mix["warmup_steps"], lambda: next(drawn, None) is None)
        phases.mark("first_steps")
        t_start = time.perf_counter()
        setup_s = t_start - spec.t_process
        deadline = t_start + spec.seconds
        s0 = state.step
        probe.timing = True
        loop(10 ** 9, lambda: time.perf_counter() >= deadline)
        window_s = time.perf_counter() - t_start
        probe.timing = False
        steps = state.step - s0
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        readings = Readings(kind="train", window_s=window_s,
                            peak_flops=cfg["peak_flops"],
                            timings={"enqueue": probe.enqueue_s})
        readings.window_flops = steps * model_counts.train_step_flops(
            b, net["net_tag"], tuple(net["in_channel"]), tuple(net["out_channel"]),
            net["embed_dim"], net["n_embed"], net["k"], net["image_size"],
            tuple(cfg["disc_filters"]))
        side = net["image_size"] // 8
        readings.bounds = {"b2_call_s": lookup_counts.b2_bound_s(
            b * side * side, net["embed_dim"], net["n_embed"], net["k"])}
        if spec.trace:
            seg = tracing.Segment(dev)
            probe.traced = True
            with seg.run():
                s1 = state.step
                loop(s1 + mix["trace_steps"], lambda: False)
            probe.traced = False
            readings.trace = seg.summary
            readings.traced_units = state.step - s1
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    e2e = {"train_steps_per_s": steps / window_s,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    prog = {"losses": [t.tolist() for t in probe.losses],
            "grad1": {k: float(v) for k, v in probe.grad1.items()},
            "change": {k: float(v) for k, v in probe.change.items()},
            "counts1": probe.counts1}
    batches = [split.gather(rows) for rows in first_rows]
    del state, model, gen, disc, flownet, probe, split
    if cuda:
        torch.cuda.empty_cache()
    refr = reference_readings(states, cfg, batches)
    if spec.control == "fp8":
        # fp8 training: e4m3 operands forward, e5m2 gradients backward
        from ..reference.precision import fp8_e4m3, fp8_e5m2

        prog = reference_readings(states, cfg, batches, fp8_e4m3, fp8_e5m2)
    values = compare(prog, refr)
    notes = []
    if spec.diagnose:
        values.update(diagnostics(prog, refr))
        notes.append(f"losses program {prog['losses']} reference "
                     f"{refr['losses']}")
    for what in ("grad1", "change"):
        if not prog[what]:
            continue
        worst = sorted(refr[what], key=lambda k: -abs(
            prog[what][k] - refr[what][k]) / max(refr[what][k], 1e-30))[:4]
        notes += [f"{what} {k}: program {prog[what][k]!r} reference "
                  f"{refr[what][k]!r}" for k in worst]
    return Outcome(attempted=steps, failed=0,
                   checks=checks(values, spec.limits), e2e=e2e,
                   readings=readings, memory_peak_bytes=int(peak),
                   values=values, setup_phases=phases.seconds, notes=notes)
