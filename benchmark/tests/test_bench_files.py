"""BENCHMARK.json and the benchmark's data files: every entry parses, its
names keep to the allowed characters, and every name it uses has its
file."""

import importlib
import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(kind, name):
    with open(os.path.join(BENCH, kind, f"{name}.json")) as f:
        return json.load(f)


def test_top_level_keys():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    assert len(s["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("entry", spec()["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"].startswith("benchmark/configs/")
    cfg = load("configs", entry["name"])
    assert os.path.join(ROOT, entry["file"]) == os.path.join(
        BENCH, "configs", entry["name"] + ".json")
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg
    assert os.path.exists(os.path.join(BENCH, "scenes",
                                       cfg["scene"] + ".py"))
    for text in (entry["why"], entry["source"]):
        assert 1 <= len(text) <= 200 and "\n" not in text


@pytest.mark.parametrize("entry", spec()["workloads"],
                         ids=lambda e: e["name"])
def test_cell(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(entry[key])
    assert entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200
    cell = load("workloads", entry["name"])
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    traffic = load("traffic", entry["traffic"])
    assert os.path.exists(os.path.join(BENCH, "modes",
                                       traffic["mode"] + ".py"))
    mode = importlib.import_module(f"benchmark.modes.{traffic['mode']}")
    assert set(traffic) <= {"mode", "why"} | set(mode.TRAFFIC_KEYS)


def metrics():
    s = spec()
    return [("end_to_end", e) for e in s["end_to_end"]] + \
        [("per_layer", e) for e in s["per_layer"]]


@pytest.mark.parametrize("kind,entry", metrics(),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_metric(kind, entry):
    s = spec()
    cells = {w["name"] for w in s["workloads"]}
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(BENCH, "metrics",
                                       entry["name"] + ".py"))
    assert set(entry.get("workloads", [])) <= cells
    if kind == "end_to_end":
        assert set(entry) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        assert set(entry) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
        assert entry["moves"] in {e["name"] for e in s["end_to_end"]}
        assert 1 <= len(entry["layer"]) <= 200


def test_every_cell_reports_enough():
    s = spec()
    for w in s["workloads"]:
        applies = lambda e: w["name"] in e.get("workloads", [w["name"]])
        e2e = {e["name"] for e in s["end_to_end"] if applies(e)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(applies(e) for e in s["per_layer"])


def test_names_unique():
    s = spec()
    names = [e["name"] for e in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    for key in ("configs", "workloads"):
        names = [e["name"] for e in s[key]]
        assert len(names) == len(set(names))
