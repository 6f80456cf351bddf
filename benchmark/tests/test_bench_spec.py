"""BENCHMARK.json and the files it names: present, loadable, within the
contract's names, units and sizes."""

import json
import os
import re

import pytest
from conftest import ROOT

from benchlib import spec

BENCH = spec.benchmark()
NAME, UNIT = spec.NAME, spec.UNIT
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["reduced"] == []
    for text in (entry["source"], entry["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    data = spec.load_json(os.path.join(ROOT, entry["file"]))
    assert data["name"] == entry["name"] and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] and data["assumed"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_file(name):
    (entry,) = [w for w in BENCH["workloads"] if w["name"] == name]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(entry["traffic"]) and entry["chips"] == 1
    assert len(entry["why"]) <= 200
    cell = spec.cell(name)
    assert cell.workload["config"] == entry["config"] == cell.config["name"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    judge_mod = __import__(f"reference.{cell.workload['check']}", fromlist=["NUMBERS"])
    assert set(cell.workload["limits"]) == set(judge_mod.NUMBERS)
    assert all(v > 0 for v in cell.workload["limits"].values())


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
        for cell in metric["workloads"]:
            assert metric["moves"] in {m["name"] for m in spec.cell(cell).end_to_end}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
    assert callable(spec.reader(metric["name"]))


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_files_under_paths_are_named_from_names():
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            if "__pycache__" not in rel:
                assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", rel), rel


def test_every_file_json_loads():
    for sub in ("configs", "workloads"):
        d = os.path.join(ROOT, "benchmark", sub)
        for f in os.listdir(d):
            with open(os.path.join(d, f)) as fh:
                json.load(fh)
