"""The FlowNet 2.0 cell (``score.ped2.int8.flownet2``): its reference
imports nothing of the port, its counts, the files the harness finds by
its names, and its driver on the CPU at a tiny size (64x64 frames, every
width as published) with both controls reading above the program."""

import copy
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.counts import flownet2 as counts

CELL = "score.ped2.int8.flownet2"
DOC = harness.manifest()


def test_reference_loads_no_port_module():
    code = ("import sys\n"
            "import benchmark.reference.flownet2, benchmark.counts.flownet2\n"
            "print(sorted(m for m in sys.modules if m.startswith('ammcnet')"
            " or m.split('.')[0] in ('jax', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=harness.MANIFEST.parent, text=True,
                         capture_output=True, check=True)
    assert out.stdout.strip() == "[]"


def test_counts():
    assert counts.pair_flops(256) == pytest.approx(66.08e9, rel=1e-3)
    assert counts.correlation_bytes(16) == (2 * 16 * 256 * 32 * 32 * 2
                                            + 16 * 441 * 32 * 32 * 2)
    assert counts.correlation_flops(16) == 2 * 441 * 256 * 32 * 32 * 16
    # bytes-bound: about 0.58 us a pair
    assert counts.correlation_bound_s(16) == pytest.approx(
        counts.correlation_bytes(16) / 3.35e12)
    assert counts.correlation_bound_s(1) == pytest.approx(0.583e-6, rel=1e-2)


def test_manifest_finds_the_cell_by_name():
    cell = harness.find(DOC["workloads"], CELL, "workload")
    assert cell["chips"] == 1
    spec = harness.load_spec(CELL, 1, 1.0, False, "cpu", 0.0, DOC)
    assert spec.mix["driver"] == "score_flownet2"
    assert harness.driver("score_flownet2").run
    assert spec.config["flownet"]["net"] == "FlowNet2"
    assert set(spec.limits) == {"flow_gap", "rgb_psnr_gap_db",
                                "rgb_commit_gap", "op_psnr_gap_db",
                                "op_commit_gap"}
    names = [m["name"] for m in DOC["per_layer"]
             if harness.applies(m, CELL)]
    assert {"roofline.correlation", "flownet2_warp_share",
            "flow_ms_per_video", "mfu.score", "roofline.qconv3x3",
            "roofline.qconvT2x2", "int8_quantize_ms_per_video",
            "int8_resident_share"} <= set(names)
    for name in names:
        assert callable(harness.metric_reader(name))


def _tiny(control=None, seed=7):
    spec = harness.load_spec(CELL, seed, 0.5, False, torch.device("cpu"),
                             time.perf_counter())
    spec.config = copy.deepcopy(spec.config)
    spec.config["net"]["image_size"] = 64
    spec.config["train_split"]["lengths"] = [12, 10, 11]
    spec.config["calibration"] = {"batches": 1, "batch": 2}
    spec.mix.update(lengths=[12, 9], bucket=8, window_batch=8,
                    check_videos=2, trace_videos=1, pad_to=16)
    spec.control = control
    return spec


@pytest.fixture(scope="module")
def sound():
    torch.manual_seed(0)
    return harness.driver("score_flownet2").run(_tiny())


def test_driver_completes_on_cpu(sound):
    assert sound.correct and sound.attempted > 0 and sound.failed == 0
    assert set(sound.checks) == set(_tiny().limits)
    assert sound.e2e["score_fps"] > 0 and sound.e2e["setup_s"] > 0
    # the bounds the rooflines of the correlation and the int8 convolutions
    # read
    assert set(sound.readings.bounds) == {
        "b1_call_s", "correlation_call_s", "qconv3x3_forward_s",
        "qconv3x3_calls", "qconvT2x2_forward_s", "qconvT2x2_calls"}


@pytest.mark.parametrize("control, number", [("fp8_flow", "flow_gap"),
                                             ("int4", "rgb_psnr_gap_db")])
def test_control_reads_above_the_program(sound, control, number):
    out = harness.driver("score_flownet2").run(_tiny(control))
    assert out.values[number] >= 3 * sound.values[number]
    assert not out.correct
