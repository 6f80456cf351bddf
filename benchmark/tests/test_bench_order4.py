"""``c3.em_k4``'s comparison on the CPU at a tiny size, as
``test_bench_reference.py`` holds ``c4.em``'s: the port's runs pass it, the
control (the plain reference in bfloat16 in the program's place) fails it,
and so does a run broken underneath by each fault, at K = 4."""

import copy

import pytest
from test_bench_reference import altered_model, loose_stop, over, state_unchanged

import readings
import run
from benchlib import spec

CELL = "c3.em_k4"
TINY_ARGS = {"n_seqs": 400, "seq_len": 60}


def tiny():
    cell = spec.cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["args"].update(TINY_ARGS)
    return cell


def test_cell_runs_order4():
    flags = tiny().argv_flags
    assert flags[flags.index("-k") + 1] == "4" and flags[flags.index("-K") + 1] == "2"


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_port_passes(seed):
    line = run.bench_run(tiny(), seed, 0.1, False, "cpu")
    assert line["correct"] is True, line["checks"]


def test_control_fails(tmp_path):
    cell = tiny()
    (rec,) = readings.readings(cell, [], [5], "cpu", str(tmp_path))
    assert over(rec["numbers"], cell.workload["limits"]), rec


@pytest.mark.parametrize("fault", [state_unchanged, altered_model, loose_stop],
                         ids=lambda f: f.__name__)
def test_fault_fails(fault, monkeypatch):
    fault(monkeypatch)
    line = run.bench_run(tiny(), 9, 0.1, False, "cpu")
    assert line["correct"] is False, line["checks"]
