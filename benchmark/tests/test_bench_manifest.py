"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by a name in it."""

import json
import math
import re
from pathlib import Path

import pytest

from benchmark import harness

DOC = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in DOC["workloads"]]
REPO = harness.MANIFEST.parent


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert harness.MANIFEST.stat().st_size <= 64 * 1024
    assert 1 <= len(DOC["command"]) <= 32
    assert all(_line(w) for w in DOC["command"])
    assert DOC["paths"] == ["benchmark"]
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51


def test_names_units_and_keys():
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        names.append(m["name"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_cells_metrics_and_budget():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = {(w["config"], w["traffic"]) for w in DOC["workloads"]}
    assert len(pairs) == len(DOC["workloads"])
    assert {w["config"] for w in DOC["workloads"]} == {
        c["name"] for c in DOC["configs"]}
    four = sum(w["chips"] == 4 for w in DOC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for cell in CELLS:
        reported = [n for n, m in e2e.items() if harness.applies(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in DOC["per_layer"] if harness.applies(m, cell)]
        assert layers
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], cell)
    # a full check of 24 cells (2 + 14 runs a cell, each run_seconds + 60 s,
    # 180 s a cell to compile, 1200 s spare) fits in 12 hours
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = harness.find(DOC["workloads"], cell, "workload")
    cfg = harness.find(DOC["configs"], w["config"], "configuration")
    assert Path(REPO / cfg["file"]).is_file()
    assert cfg["file"].startswith("benchmark/")
    spec = harness.load_spec(cell, 1, 1.0, False, "cpu", 0.0, DOC)
    assert harness.driver(spec.mix["driver"]).run
    assert spec.limits and all(math.isfinite(v) for v in spec.limits.values())
    for m in DOC["per_layer"]:
        if harness.applies(m, cell):
            assert callable(harness.metric_reader(m["name"]))


def test_layers_are_named_in_perf_md():
    perf = (REPO / "PERF.md").read_text()
    for m in DOC["per_layer"]:
        assert m["layer"] in perf, m["layer"]


def test_configs_hold_what_is_run():
    for c in DOC["configs"]:
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert body["net"]["embed_dim"] == 64 and body["net"]["n_embed"] == 256
