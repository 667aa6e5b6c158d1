"""Each driver runs on the CPU at a tiny size (64x64 frames, every width as
published), and the correctness check catches the planted faults and the
lower-precision controls there; a run on the card through the command
line is marked ``cuda``."""

import json
import subprocess
import sys

import pytest

from benchmark import faults, harness

SCORE = ("score.ped2.bf16.otf", "score.ped2.int8")
TRAIN = "train.stage2.bf16.b16"


def _run(spec):
    return harness.driver(spec.mix["driver"]).run(spec)


@pytest.mark.parametrize("workload", SCORE + (TRAIN,))
def test_driver_completes_on_cpu(tiny, workload):
    out = _run(tiny(workload))
    # at 64x64 a training step's 128 latents a memory make one near-tie
    # pick a large share of pick_gap, so only the scoring cells are held
    # to their limits here
    assert out.correct or workload == TRAIN
    assert out.attempted > 0 and out.failed == 0
    assert set(out.checks) == set(tiny(workload).limits)
    assert all(v >= 0 for v, _ in out.checks.values())
    assert out.e2e["setup_s"] > 0
    kind = "score_fps" if workload in SCORE else "train_steps_per_s"
    assert out.e2e[kind] > 0


@pytest.mark.parametrize("workload", SCORE)
def test_altered_record_is_caught(tiny, workload):
    sound = _run(tiny(workload))
    with faults.planted("alter_record"):
        out = _run(tiny(workload))
    assert sound.correct and not out.correct


def test_unchanged_state_is_caught(tiny):
    with faults.planted("state_unchanged"):
        out = _run(tiny(TRAIN))
    assert not out.correct
    assert out.values["change_gap"] == pytest.approx(1.0)


def test_half_batch_is_caught(tiny):
    sound = _run(tiny(TRAIN)).values
    with faults.planted("half_batch"):
        out = _run(tiny(TRAIN))
    assert not out.correct
    assert out.values["change_gap"] >= 3 * sound["change_gap"]


@pytest.mark.parametrize("workload, control, number", [
    ("score.ped2.bf16.otf", "fp8_gen", "op_commit_gap"),
    ("score.ped2.bf16.otf", "fp8_flow", "flow_gap"),
    ("score.ped2.int8", "int4", "rgb_psnr_gap_db"),
    (TRAIN, "fp8", "pick_gap"),
])
def test_control_reads_above_the_program(tiny, workload, control, number):
    sound = _run(tiny(workload)).values[number]
    out = _run(tiny(workload, control=control))
    assert out.values[number] >= 3 * sound
    assert not out.correct


def test_cli_refuses_without_a_card_or_runs_on_one():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "score.ped2.bf16.otf", "--seed", "1", "--seconds", "1"],
        cwd=harness.MANIFEST.parent, capture_output=True, text=True,
        timeout=1200)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: test_cli_on_the_card covers it")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cli_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "score.ped2.bf16.otf", "--seed", "2147483659", "--seconds", "2",
         "--trace", "1"],
        cwd=harness.MANIFEST.parent, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert list(result)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
