"""What a run measures, found by name: ``BENCHMARK.json`` at the root of the
checkout lists the metrics, configurations and cells; each configuration
is ``benchmark/configs/<name>.json``, each cell ``benchmark/workloads/
<name>.json``, each metric a reader ``benchmark/metrics/<name>.py`` with a
function ``read(run)`` that returns a number or None (nothing to read:
the metric is left out of the line).  Adding a cell, a configuration or a
metric adds files and entries and edits none."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration's file
    workload: dict      # the cell's file
    end_to_end: list    # BENCHMARK.json's entries of the metrics it reports
    per_layer: list

    @property
    def argv_flags(self) -> list:
        return [*self.config["flags"], *self.workload["flags"]]


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the metric's
    ``workloads``, or the metric has none and (a per-layer metric) the
    end-to-end metric it moves is the cell's."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, root: str = ROOT, bench: dict | None = None) -> Cell:
    bench = bench or benchmark(root)
    (entry,) = [w for w in bench["workloads"] if w["name"] == name]
    bench_dir = os.path.join(root, "benchmark")
    config = load_json(os.path.join(bench_dir, "configs", f"{entry['config']}.json"))
    workload = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, entry["chips"], config, workload, e2e, per_layer)


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def check(name: str):
    """The ``judge`` function of ``benchmark/reference/<name>.py``."""
    return importlib.import_module(f"reference.{name}").judge
