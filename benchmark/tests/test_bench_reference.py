"""The comparison that decides ``correct``, on the CPU at each cell's tiny
size: the port's own runs pass it, the control (the plain reference in
bfloat16 in the program's place) fails it, and so does a run whose timed
path is broken underneath by each fault the cell can have."""

import pytest
import torch
from conftest import tiny_cell

import readings
import run
from bammmotif2_tpu_torch.refinement import multi

CELLS = ["c4.em"]


def over(line_or_numbers: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if line_or_numbers[k] > lim]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_port_passes(name, seed):
    line = run.bench_run(tiny_cell(name), seed, 0.1, False, "cpu")
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, tmp_path):
    cell = tiny_cell(name)
    (rec,) = readings.readings(cell, [], [5], "cpu", str(tmp_path))
    assert over(rec["numbers"], cell.workload["limits"]), rec


def state_unchanged(monkeypatch):
    """Each EM step hands back the model it was given."""
    real = multi.batched_step

    def step(v, q, *a, **k):
        _v2, q2, ll, vd = real(v, q, *a, **k)
        return tuple(x.clone() for x in v), q2, ll, vd

    monkeypatch.setattr(multi, "batched_step", step)


def half_rows_em(monkeypatch):
    """The E+M pass reads the first half of the rows and doubles its sums."""
    real = multi.data_pass

    def data_pass(path, s_flat, data, q, mesh=None):
        n = data["lens"].shape[0] // 2
        half = {**data, "cidx": data["cidx"][:, :n].contiguous(), "lens": data["lens"][:n]}
        C, ll = real(path, s_flat, half, q, mesh)
        return C * 2, ll * 2

    monkeypatch.setattr(multi, "data_pass", data_pass)


def altered_model(monkeypatch):
    """One conditional of the first seed's model is off by 0.01 at each
    step."""
    real = multi.batched_step

    def step(*a, **k):
        v2, q2, ll, vd = real(*a, **k)
        v2[0][0, 0, 0] += 0.01
        return v2, q2, ll, vd

    monkeypatch.setattr(multi, "batched_step", step)


def loose_stop(monkeypatch):
    """EM's stop test takes 100 times the epsilon the command line states."""
    from bammmotif2_tpu_torch import cli

    monkeypatch.setattr(cli, "params_from_args", cli.params_from_args)
    readings.loose_stop(cli)


FAULTS = [("c4.em", state_unchanged), ("c4.em", half_rows_em), ("c4.em", altered_model),
          ("c4.em", loose_stop)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_fault_fails(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run.bench_run(tiny_cell(name), 9, 0.1, False, "cpu")
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_card(name, card):
    """A short run of each cell at its full size on the card."""
    from benchlib import spec

    line = run.bench_run(spec.cell(name), 1234, 2.0, False, card)
    assert line["correct"] is True, line["checks"]
    assert torch.cuda.get_device_name(card) == line["device"]["kind"]
