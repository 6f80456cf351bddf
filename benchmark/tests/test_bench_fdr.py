"""The comparison of ``--EM --FDR`` jobs (``reference/check_fdr.py``) on the
CPU at a tiny size, in the cell ``c4.em_fdr`` would be (``FDR_CELL``: not
in BENCHMARK.json, whose bound its runs on the card spread too widely to
hold): the port's runs pass it, the control (the plain evaluation in
bfloat16 in the program's place, ``readings_fdr.py``) fails it, and so do
runs whose negatives come from another seed or whose first fold's scores
are off; the plain sampler draws the program's negatives bit for bit."""

import copy
import os

import numpy as np
import pytest
import torch
from test_bench_reference import over

import readings_fdr
import run
from benchlib import spec
from bammmotif2_tpu_torch.evaluation import fdr
from reference import threefry

# c4_denovo's --EM --FDR jobs under the limits read on the card (PERF.md §7)
FDR_CELL = {"name": "c4.em_fdr", "config": "c4_denovo", "flags": ["--EM", "--optimizeQ", "--FDR"],
            "pool": 4, "check": "check_fdr", "check_jobs": 1,
            "limits": {"stats_score": 0.01, "stats_rank": 2500.0, "avrec_abs": 0.001,
                       "stop_dll": 20.0}}
TINY_ARGS = {"n_seqs": 250, "seq_len": 50}


def tiny():
    config = copy.deepcopy(spec.load_json(os.path.join(spec.BENCH_DIR, "configs",
                                                       "c4_denovo.json")))
    config["args"].update(TINY_ARGS)
    return spec.Cell(FDR_CELL["name"], 1, config, FDR_CELL, [], [])


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_port_passes(seed):
    line = run.bench_run(tiny(), seed, 0.1, False, "cpu")
    assert line["correct"] is True, line["checks"]


def test_control_fails(tmp_path):
    cell = tiny()
    (rec,) = readings_fdr.readings.readings(cell, [], [5], "cpu", str(tmp_path))
    assert over(rec["numbers"], cell.workload["limits"]), rec


def shifted_negatives(monkeypatch):
    """Each fold's negatives come from the next fold's key."""
    monkeypatch.setattr(fdr, "threefry", fdr.threefry)
    readings_fdr.shifted_negatives(None)


def first_fold_off(monkeypatch):
    """The first fold's scores of its rows are 0.05 too high."""
    real = fdr._run_tail

    def run_tail(tail, v, fold):
        real(tail, v, fold)
        if fold == 0:
            tail.state["pos_z"].add_(0.05)
            tail.state["pos_m"].add_(0.05)

    monkeypatch.setattr(fdr, "_run_tail", run_tail)


@pytest.mark.parametrize("fault", [shifted_negatives, first_fold_off], ids=lambda f: f.__name__)
def test_fault_fails(fault, monkeypatch):
    fault(monkeypatch)
    line = run.bench_run(tiny(), 9, 0.1, False, "cpu")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("s_order", [0, 2])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_sampler_draws_the_programs_negatives(s_order, seed):
    from bammmotif2_tpu_torch.generator import seqgen
    from bammmotif2_tpu_torch.ops import threefry as port_threefry

    rng = np.random.default_rng(s_order)
    trans = [torch.tensor((p / p.sum(1, keepdims=True)).ravel(), dtype=torch.float32)
             for p in (rng.random((4 ** m, 4)) for m in range(s_order + 1))]
    lens = torch.tensor(rng.integers(20, 90, 200), dtype=torch.int32)
    got = seqgen._sample_markov_batch(port_threefry.prng_key(seed), tuple(trans), lens, L=90,
                                      s_order=s_order, A=4).long()
    want = threefry.markov_codes(threefry.prng_key(seed), trans, lens.long(), 90)
    valid = torch.arange(90)[None, :] < lens.long()[:, None]
    assert torch.equal(got[valid], want[valid]) and bool((want[~valid] == threefry.PAD).all())
