"""The benchmark's files: every configuration, cell, traffic mix and
metric reader loads and is found by the name ``BENCHMARK.json`` gives it,
and every name and unit keeps to the allowed characters."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import arch, harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = ("hidden_size", "intermediate_size", "moe_intermediate_size",
          "head_dim", "num_attention_heads", "num_key_value_heads",
          "num_experts_per_tok", "vocab_size")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    path = ROOT / conf["file"]
    assert path.is_file() and path.parts[-3] == "perfbench"
    data = json.loads(path.read_text())
    assert data == arch.load_config(conf["name"])
    assert data["source"] == conf["source"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    for key in conf["reduced"]:
        assert NAME.match(key) and key not in WIDTHS
        assert data[key] == data["reduced"][key]["run"]
    dm = arch.dims(data)
    assert dm["n_layers"] >= 1 and dm["d_model"] > 0


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    loaded = harness.load_cell(cell["name"])
    assert loaded["config"] == cell["config"]
    assert loaded["traffic"] == cell["traffic"]
    assert loaded["why"] == cell["why"]
    assert loaded["limits"] and set(loaded["limits"]) <= set(harness.CHECKS)
    assert harness.checked_steps(loaded["traffic_file"]) >= 3
    e2e, layer = harness.cell_metrics(SPEC, cell["name"])
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(metric):
    mod = harness.load_metric(metric["name"])
    assert mod.LAYER == metric["layer"]
    assert mod.UNIT == metric["unit"]
    assert mod.MOVES == metric["moves"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert metric["moves"] in e2e
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_every_file_of_a_name_is_used():
    cells = {w["name"] for w in SPEC["workloads"]}
    traffic = {w["traffic"] for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    metrics = {m["name"] for m in SPEC["per_layer"]}
    here = ROOT / "perfbench"
    assert {p.stem for p in (here / "workloads").glob("*.json")} == cells
    assert {p.stem for p in (here / "traffic").glob("*.json")} == traffic
    assert {p.stem for p in (here / "configs").glob("*.json")} == configs
    assert {p.stem for p in (here / "metrics").glob("*.py")
            if not p.stem.startswith("_")} == metrics
    assert configs == {w["config"] for w in SPEC["workloads"]}


def test_e2e_metrics_named_by_the_harness():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert e2e <= {"tokens_per_s", "step_ms_p90", "peak_mem_gib", "setup_s"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
