"""PyTorch port: the span and counter registry (``utils/profiling.py``) and
the spans and counters at the port's layer boundaries.

* with no profiler running, ``span`` is one shared null context and
  ``count`` records nothing;
* under ``torch.profiler.profile`` on the CPU, the int8 forward (plain
  versions, inside ``ChunkScorer``) and the training loop's two-stream
  steps put each named span in the Chrome trace as a ``user_annotation``,
  nested as ``utils/profiling.py`` lists them; a stage-1 step has the
  phases it runs;
* the int8 input counters: 16 resident, 24 static, 0 dynamic a calibrated
  forward, 0/0/40 an uncalibrated one; the quantize kernel's forms
  (``int8.pack.plain``, ``.cat``, ``.pool``) 12/6/6 and 0/0/0;
* ``setup.ops`` holds the op library's set-up, and ``reset`` keeps it;
* ``torch.export`` of a ``ChunkScorer`` traces no profiler op: its graph is
  the one the forward gives with the spans taken out;
* the benchmark's readers of the port's spans and counters
  (``benchmark/metrics``) return None without a trace, and their numbers
  from a registry filled by hand.

Small sizes: 32x32 frames for the int8 forward, 64x64 (the smallest
FlowNet2-SD takes) for the two-stream step, 16 codewords.
"""

import contextlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from ammcnet_aaai2021_torch.configs import LossConfig, NetConfig, OptimConfig
from ammcnet_aaai2021_torch.eval import export as export_mod
from ammcnet_aaai2021_torch.eval.export import ChunkScorer
from ammcnet_aaai2021_torch.models import (build_generator, build_model,
                                           init_weights)
from ammcnet_aaai2021_torch.models import quantized as pq
from ammcnet_aaai2021_torch.train.loop import train_loop
from ammcnet_aaai2021_torch.train.state import create_train_state
from ammcnet_aaai2021_torch.train.steps import (
    make_single_stream_train_step, make_twostream_train_step)
from ammcnet_aaai2021_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EMBED = 16
PHASES = ("train_step.forward", "train_step.teacher",
          "train_step.discriminator", "train_step.backward",
          "train_step.optimizer")
INPUTS = ("int8.inputs.resident", "int8.inputs.static", "int8.inputs.dynamic")
PACKS = ("int8.pack.plain", "int8.pack.cat", "int8.pack.pool")
# the benchmark's own span names (benchmark/tracing.py and its drivers)
BENCHMARK_SPANS = ("segment", "upload", "extract", "score", "fetch", "step",
                   "psnr", "loop")
PORT_NAMES = (("int8.quantize", "train_step", "train_loop.start",
               "train_loop.data_wait", "train_loop.fetch", "train_loop.stop",
               "scorer.forward", "flow.extract", "setup.ops",
               "conv.layout.nhwc", "conv.layout.nchw")
              + PHASES + INPUTS + PACKS)


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _profiled(tmp_path, fn):
    """Run ``fn`` under a CPU profile; returns its result and the Chrome
    trace's ``user_annotation`` events by name."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out, spans


def _inside(inner, outer) -> bool:
    """Each interval of ``inner`` lies in one of ``outer``."""
    return all(any(a0 <= b0 and b1 <= a1 for a0, a1 in outer)
               for b0, b1 in inner)


def test_span_and_count_record_nothing_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    a, b = profiling.span("int8.quantize"), profiling.span("train_step")
    assert a is b
    with a:
        with b:
            profiling.count("int8.inputs.static", 3)
    with profiling.timed("train_loop.data_wait") as wait:
        pass
    assert wait.seconds >= 0.0
    assert profiling.counts() == {}
    assert set(profiling.summary()) <= {"setup.ops"}


def test_span_names_are_not_the_benchmarks():
    assert not set(PORT_NAMES) & set(BENCHMARK_SPANS)


def test_summary_gives_calls_host_and_self_device_time(tmp_path):
    def run():
        for _ in range(2):
            with profiling.span("train_step"):
                with profiling.span("train_step.forward"):
                    torch.ones(8).sum()
                profiling.count("int8.inputs.static")
    _, spans = _profiled(tmp_path, run)
    s = profiling.summary()
    assert s["train_step"]["calls"] == s["train_step.forward"]["calls"] == 2
    assert s["train_step"]["host_s"] >= s["train_step.forward"]["host_s"] > 0
    assert s["train_step"]["device_s"] is None  # no CUDA on the CPU
    assert profiling.counts() == {"int8.inputs.static": 2}
    assert _inside(spans["train_step.forward"], spans["train_step"])

    # device time from records filled by hand: self time is less the
    # children's
    profiling.reset()
    parent = _record("train_step", 0.1)
    _record("train_step.forward", 0.03, parent)
    _record("train_step.backward", 0.05, parent)
    s = profiling.summary()
    assert s["train_step"]["device_s"] == pytest.approx(0.1)
    assert s["train_step"]["self_device_s"] == pytest.approx(0.02)
    assert s["train_step.forward"]["self_device_s"] == pytest.approx(0.03)
    profiling.reset()
    assert set(profiling.summary()) <= {"setup.ops"}


def test_setup_ops_holds_the_op_librarys_set_up():
    from ammcnet_aaai2021_torch.ops import library  # noqa: F401

    s = profiling.summary()["setup.ops"]
    assert s["calls"] >= 1 and s["host_s"] > 0 and s["device_s"] is None
    profiling.reset()
    assert profiling.summary()["setup.ops"] == s


# ---------------------------------------------------------------------------
# the int8 forward


SIZE = 32


@pytest.fixture(scope="module")
def int8_forwards():
    """The dynamic and the calibrated int8 forward of one seeded generator
    (the memory's plain lookup, the convolutions' plain versions)."""
    gen = init_weights(build_generator(NetConfig(dtype="float32",
                                                 n_embed=N_EMBED),
                                       per_sample_diff=True),
                       torch.Generator().manual_seed(1)).eval()
    qvars = pq.quantize_twostream_variables(gen.state_dict())
    kw = dict(embed_dim=64, n_embed=N_EMBED, k=2, per_sample_diff=True)
    dynamic = pq.make_quantized_forward(qvars, **kw)
    g = torch.Generator().manual_seed(2)
    cal = [(torch.rand(2, 12, SIZE, SIZE, generator=g) * 2 - 1,
            torch.randn(2, 6, SIZE, SIZE, generator=g) * 0.02)]
    qcal = pq.calibrate_act_scales(dynamic, qvars, cal)
    return {"dynamic": dynamic,
            "calibrated": pq.make_quantized_forward(qcal, **kw)}


def _chunk(seed=3, frames=6):
    g = torch.Generator().manual_seed(seed)
    rgb = torch.randint(0, 255, (frames, SIZE, SIZE, 3), generator=g,
                        dtype=torch.uint8)
    op = (torch.randn((frames - 1, SIZE, SIZE, 2), generator=g) * 0.02
          ).to(torch.bfloat16)
    return (rgb,), (op,)


@pytest.mark.parametrize("kind,want", [("calibrated", (16, 24, 0, 12, 6, 6)),
                                       ("dynamic", (0, 0, 40, 0, 0, 0))])
def test_int8_forward_spans_and_input_counters(int8_forwards, tmp_path, kind,
                                               want):
    """One window batch through ``ChunkScorer``: one ``scorer.forward``
    holding the 40 conv inputs' ``int8.quantize`` spans."""
    scorer = ChunkScorer(int8_forwards[kind], window_batch=2).eval()
    rgbs, ops = _chunk()

    def run():
        with torch.inference_mode():
            return scorer(rgbs, ops)
    out, spans = _profiled(tmp_path, run)
    assert tuple(out.shape) == (1, 4, 2)
    assert len(spans["scorer.forward"]) == 1
    assert len(spans["int8.quantize"]) == pq.N_SITES
    assert _inside(spans["int8.quantize"], spans["scorer.forward"])
    got = profiling.counts()
    assert tuple(got.get(name, 0) for name in INPUTS + PACKS) == want
    s = profiling.summary()
    assert s["int8.quantize"]["calls"] == pq.N_SITES
    assert s["scorer.forward"]["calls"] == 1
    assert s["scorer.forward"]["host_s"] > s["int8.quantize"]["host_s"]
    # the spans leave the forward as it was
    with torch.inference_mode():
        np.testing.assert_array_equal(scorer(rgbs, ops).numpy(), out.numpy())


def _no_spans(monkeypatch):
    null = contextlib.nullcontext()
    for mod in (export_mod, pq):
        monkeypatch.setattr(mod, "span", lambda name: null)
    monkeypatch.setattr(pq, "count", lambda name, n=1: None)


def test_export_traces_no_profiler_op(int8_forwards, monkeypatch):
    scorer = ChunkScorer(int8_forwards["calibrated"], window_batch=2).eval()
    rgbs, ops = _chunk()
    with torch.no_grad():
        graph = torch.export.export(scorer, (rgbs, ops)).graph_module
    targets = [str(n.target) for n in graph.graph.nodes
               if n.op == "call_function"]
    assert any("ammcnet.qconv3x3_int8" in t for t in targets)
    assert not [t for t in targets
                if "profiler" in t or "record_function" in t]
    assert profiling.counts() == {} and "int8.quantize" not in \
        profiling.summary()
    _no_spans(monkeypatch)
    with torch.no_grad():
        bare = torch.export.export(scorer, (rgbs, ops)).graph_module
    assert graph.code == bare.code


# ---------------------------------------------------------------------------
# the training step and loop


def _twostream_batch(seed, size=64):
    rng = np.random.default_rng(seed)
    return {"rgb": torch.from_numpy(rng.integers(
                0, 256, (1, 5, size, size, 3), dtype=np.uint8)),
            "op": torch.from_numpy(rng.normal(
                0, 0.5, (1, 4, size, size, 2)).astype(np.float32))}


def test_train_loop_and_step_spans(tmp_path):
    """Two two-stream steps through ``train_loop`` (a fetch a step, and the
    wait for the first): each phase once a step inside its ``train_step``;
    the loop's start, waits, fetches and stop."""
    model = build_model(NetConfig(dtype="float32", n_embed=N_EMBED),
                        "training")
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 3)
    flownet = model.flow_network.eval().requires_grad_(False)
    step = make_twostream_train_step(LossConfig())
    batches = (_twostream_batch(i) for i in range(10))

    def run():
        return train_loop(state, step, batches, flownet, 2,
                          str(tmp_path / "run"), step_log=1)
    _, spans = _profiled(tmp_path, run)
    assert state.step == 2
    s = profiling.summary()
    assert s["train_step"]["calls"] == 2
    for name in PHASES:
        assert s[name]["calls"] == 2, name
        assert _inside(spans[name], spans["train_step"]), name
    assert len(spans["train_step"]) == 2
    by_parent = {(r.name, r.parent.name if r.parent else None)
                 for r in profiling._records}
    assert {(n, "train_step") for n in PHASES} <= by_parent
    assert ("train_step", None) in by_parent
    for name, calls in (("train_loop.start", 1), ("train_loop.stop", 1),
                        ("train_loop.data_wait", 2), ("train_loop.fetch", 3)):
        assert s[name]["calls"] == calls == len(spans[name]), name
    assert not _inside(spans["train_loop.data_wait"], spans["train_step"])


def test_single_stream_step_has_its_phases(tmp_path):
    """A stage-1 op step (no flow term): every phase but the teacher."""
    cfg = NetConfig(net_tag="unet_vq_topk_res", data_type="op",
                    dtype="float32", n_embed=N_EMBED)
    model = build_model(cfg, "training", with_flow=False)
    state = create_train_state(model.generator, model.discriminator,
                               OptimConfig(), 3)
    step = make_single_stream_train_step(LossConfig(loss_tag="op_int_adv_vq"),
                                         data_type="op")
    batch = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.5, (2, 4, SIZE, SIZE, 2)).astype(np.float32))
    _, spans = _profiled(tmp_path, lambda: step(state, batch, None))
    s = profiling.summary()
    assert s["train_step"]["calls"] == 1
    for name in PHASES:
        want = 0 if name == "train_step.teacher" else 1
        assert s.get(name, {"calls": 0})["calls"] == want, name
        assert len(spans.get(name, [])) == want, name


# ---------------------------------------------------------------------------
# the benchmark's readers


READERS = {
    # metric: (kind, what the registry holds, the reading at 4 units)
    "int8_quantize_ms_per_video": ("score", {"int8.quantize": 0.4}, 100.0),
    "int8_resident_share": ("score", {}, 40.0),
    "step_forward_ms": ("train", {"train_step.forward": 0.12}, 30.0),
    "step_teacher_ms": ("train", {"train_step.teacher": 0.028}, 7.0),
    "step_backward_ms": ("train", {"train_step.backward": 0.2}, 50.0),
    "setup_ops_s": ("train", {}, None),
}


def _record(name, device_s, parent=None):
    """A span's record, as a profiled span on the card leaves it."""
    rec = profiling._Span(name)
    rec.parent, rec.t0, rec.t1, rec.device_s = parent, 0, 1000, device_s
    profiling._records.append(rec)
    return rec


def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("metric", sorted(READERS))
def test_benchmark_readers_of_the_ports_spans(metric):
    from benchmark.harness import Readings

    kind, device_s, want = READERS[metric]
    read = _reader(metric)
    assert read(Readings(kind=kind)) is None  # no trace
    parent = _record("train_step", 0.5) if kind == "train" else None
    for name, seconds in device_s.items():
        _record(name, seconds, parent)
    profiling._counts.update({"int8.inputs.resident": 16,
                              "int8.inputs.static": 24})
    got = read(Readings(kind=kind, trace=object(), traced_units=4))
    if metric == "setup_ops_s":
        want = profiling.summary().get("setup.ops", {}).get("host_s")
    assert got == pytest.approx(want)
