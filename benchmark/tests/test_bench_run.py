"""A run's contract on a machine without a card, and its result line's
shape from a tiny run on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH_DIR, ROOT, tiny_cell

import run


def test_no_card_exits_nonzero_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "c4.em", "--seed",
                          str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bare_benchmark_directory_exits_nonzero(tmp_path):
    """A checkout holding only BENCHMARK.json and benchmark/ has no
    program to measure."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "c4.em", "--seed",
                          "3", "--seconds", "1", "--trace", "1"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    cell = tiny_cell("c4.em")
    line = run.bench_run(cell, 2 ** 33 + 1, 0.5, trace, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= (3 if trace else 1)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    # the CPU has no device trace: those metrics are left out, never 0
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    assert {"cli_rest_s.refine", "em_windows_per_s"} <= set(line["metrics"]) or not trace
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.workload["limits"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_job_seeds_are_31_bits_and_differ():
    seeds = {run.job_seed(2 ** 40 + 17, j) for j in range(-1, 200)}
    assert len(seeds) == 201 and all(0 <= s < 2 ** 31 for s in seeds)
