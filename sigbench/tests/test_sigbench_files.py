"""Every file a cell is made of loads, and BENCHMARK.json agrees with them."""

import json
import re

import pytest

from sigbench import entries, harness, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["sigbench"]
    assert BENCH["command"] == ["python3", "sigbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert NAME.match(entry["name"])
    assert entry["file"] == f"sigbench/configs/{entry['name']}.json"
    cfg = spec.load_json(spec.repo_root() / entry["file"])
    assert cfg["source"] == entry["source"]
    assert all(NAME.match(k) and k in cfg for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    assert cfg["dyadic_order"] == 0 and cfg["tf32"] is False
    assert cfg["x_shape"][2] == cfg["y_shape"][2]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_files(entry):
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    cell = spec.load_cell(entry["name"])
    assert cell.chips == cell.config.get("ranks", 1) and cell.chips in (1, 4)
    called = entries.load(cell.traffic["entry"])
    for part in ("SETTINGS", "call", "control", "reference", "counts"):
        assert hasattr(called, part), part
    harness.check_config(called, cell.config)
    assert cell.workload["sample"] >= 1
    wanted = {"value_err"} | ({"grad_err"} if cell.traffic["grad"] else set())
    assert set(cell.workload["limits"]) == wanted
    assert "control" in cell.workload["faults"]
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert 0 < len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_config_outside_the_entry_is_refused():
    cell = spec.load_cell("gram.mmd2-train")
    called = entries.load(cell.traffic["entry"])
    with pytest.raises(ValueError, match="static_kernel"):
        harness.check_config(called, dict(cell.config, static_kernel="rbf"))
    with pytest.raises(ValueError, match="keywords"):
        called.reference(None, cell.config, dict(cell.traffic, kwargs={"unbiased": False}))


def test_pairs_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"])
    assert hasattr(spec.load_reader(metric["name"]), "read")
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert metric["layer"] and "\n" not in metric["layer"]
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}
