"""BENCHMARK.json against the contract's shape, and every file it names
found by name: configurations, traffic mixes and their kinds, cell files
with a limit for every number compared, per-layer readers."""
import re

import pytest

from portbench import harness

BENCH = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
LIMITS = {"generate": {"enc_x_rms_A", "enc_h_gap", "kk_mismatch", "step_gap", "decode_mismatch"},
          "train": {"loss_gap", "grad_gap", "update_gap"}}
EXACT = {"kk_mismatch", "decode_mismatch"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and TEXT.match(c["source"]) and TEXT.match(c["why"])
        body = harness.read_json(harness.ROOT / c["file"])
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"] == []
        assert (harness.ROOT / body["weights"]).exists()
        assert {"model", "assumed", "deployment"} <= set(body)


def test_workloads_find_their_files():
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and TEXT.match(w["why"])
        spec = harness.load_spec(w["name"], 1, 1.0, False)
        assert harness.kind_module(spec.traffic["kind"]).run
        assert set(spec.cell["limits"]) == LIMITS[spec.traffic["kind"]]
        assert all(spec.cell["limits"][k] == 0 for k in EXACT & set(spec.cell["limits"]))
        used.add(w["config"])
    assert used == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_end_to_end():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_readers(metric):
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert metric["moves"] in e2e and set(metric["workloads"]) <= cells
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert TEXT.match(metric["layer"])
    reader = harness.metric_reader(metric["name"])
    empty = dict(pockets=[], profile=None, peak=None, steps=0, data_wait_s=0.0, forward_flops=[], window_s=0.0)
    assert reader.read(empty) is None


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        layers = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layers
