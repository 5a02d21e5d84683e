"""BENCHMARK.json's form (keys, names, units, sources, bounds), and every name
it gives found in the benchmark's folder."""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])


@pytest.mark.parametrize("name", [x["name"] for x in SPEC["configs"] + SPEC["workloads"]
                                  + METRICS]
                         + [w["traffic"] for w in SPEC["workloads"]]
                         + [k for c in SPEC["configs"] for k in c["reduced"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                "host_clock")
    if metric in SPEC["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert 0 < len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_unique_names_and_setup_metric():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    assert [m["bound"] for m in SPEC["end_to_end"] if m["name"] == "setup_s"] == [0.25]


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_found_and_used(conf):
    path = REPO / conf["file"]
    assert path.is_file() and path.is_relative_to(BENCH)
    held = json.loads(path.read_text())
    assert held["name"] == conf["name"] and held["reduced"] == conf["reduced"] == []
    assert held["source"] == conf["source"]
    assert (REPO / held["reference"]).is_file()
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])
    assert 0 < len(conf["why"]) <= 200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_found(cell):
    from benchmark.run import cell as find

    assert cell["chips"] == 1 and 0 < len(cell["why"]) <= 200
    c = find(cell["name"])
    assert set(c["cell"]["limits"]) <= {"loss_gap", "grad_gap", "update_gap",
                                        "grad_gap_median", "update_gap_median"}
    assert c["traffic"]["kind"] in ("corpus", "resident")
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s", "train_frames_per_s"}
    assert c["per_layer"]


def test_presets_as_the_port_gives_them():
    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME
    from kokoro_tpu_torch.config import get_default_config, get_high_performance_config

    for name, (model, train) in (("kokoro-ruslan-hp", get_high_performance_config()),
                                 ("kokoro-ruslan-long", get_default_config(**LONG_REGIME))):
        held = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        assert held["model"] == json.loads(json.dumps(dataclasses.asdict(model)))
        want = json.loads(json.dumps(dataclasses.asdict(train)))
        assert {k: want[k] for k in held["training"]} == held["training"]
        assert held["model"]["hidden_dim"] == 512 and held["model"]["n_heads"] == 8
