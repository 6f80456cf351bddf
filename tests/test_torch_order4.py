"""Order-4 BaMMs (``-k 4 -K 2``, BASELINE config 3) through the CLI's --EM
path, judged by the benchmark's plain reference (``benchmark/reference/
check_em.py``: float64 PyTorch EM, importing nothing of the port) under
the limits of the benchmark's cell ``c3.em_k4``.

The inputs are ``benchmark/benchlib/traffic.py``'s planted sets at a small
size, with seeds at W = 8, 10 and 12.  On the CPU the CLI takes the
kernels' plain versions; the ``cuda`` test runs the card's kernels, where
the W = 8 group keeps the fused update's count table in shared memory and
the W = 10 and 12 groups in device memory (``cuda_update.table_in_smem``).
This module imports no JAX.
"""

from __future__ import annotations

import importlib
import json
import os
import sys

import pytest
import torch

from bammmotif2_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
CELL = "c3.em_k4"


def bench_module(name: str):
    """A module of the benchmark (``benchlib.traffic``, ``reference.
    check_em``), imported from ``benchmark/``."""
    if BENCH not in sys.path:
        sys.path.append(BENCH)
    return importlib.import_module(name)


def load(sub: str, name: str) -> dict:
    with open(os.path.join(BENCH, sub, f"{name}.json")) as fh:
        return json.load(fh)


def order4_job(tmp_path, entropy: int, n_seqs: int, seq_len: int, device) -> tuple:
    """One --EM --optimizeQ job of the cell's flags on a planted set of
    ``n_seqs`` rows (5 seeds: groups of 2, 2 and 1 at W = 8, 10, 12) on
    ``device``: (the check's numbers, the em.group spans' attrs by W, the
    run's counters)."""
    traffic, check_em = bench_module("benchlib.traffic"), bench_module("reference.check_em")
    workload = load("workloads", CELL)
    config = load("configs", workload["config"])
    inp = traffic.config4_problem(str(tmp_path), entropy, n_seqs=n_seqs, seq_len=seq_len,
                                  motifs=tuple(config["args"]["motifs"]), n_seeds=5, tag="k4")
    outdir = str(tmp_path / "out")
    argv = [outdir, inp.fasta, "--PWMFile", inp.meme, "--jsonl", "--seed", str(entropy),
            *config["flags"], *workload["flags"]]
    assert cli.main(argv, device=device) == 0
    nums = check_em.judge({"codes": inp.codes, "meme": inp.meme, "argv": argv,
                           "outdir": outdir}, device)
    with open(os.path.join(outdir, "k4.metrics.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    groups = {e["attrs"]["W"]: e["attrs"] for e in events
              if e["event"] == "span" and e["name"] == "em.group"}
    (counts,) = [e["counts"] for e in events if e["event"] == "counts"]
    return nums, groups, counts, workload["limits"]


@pytest.mark.parametrize("entropy", [3, 2 ** 31 + 5])
def test_order4_em_within_the_cells_limits(tmp_path, entropy):
    """On the CPU, at 300 rows of 60 bp: every number of the check under the
    cell's limit, the three groups at K = 4 (R1 = 1,365)."""
    nums, groups, counts, limits = order4_job(tmp_path, entropy, 300, 60, "cpu")
    assert all(nums[k] <= lim for k, lim in limits.items()), nums
    assert sorted(groups) == [8, 10, 12]
    assert all(g["K"] == 4 and g["R1"] == 1365 for g in groups.values()), groups
    assert [groups[W]["M"] for W in (8, 10, 12)] == [2, 2, 1]
    assert counts["em.seed_passes"] == sum(sum(g["iterations"]) for g in groups.values())


@pytest.fixture
def cuda_device():
    import shutil

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    try:
        from bammmotif2_tpu_torch.ops import _build

        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc: {e} (PATH nvcc: {shutil.which('nvcc')})")
    return torch.device("cuda")


@pytest.mark.cuda
def test_order4_em_on_the_card_both_update_tables(tmp_path, cuda_device):
    """On the card, at 2,000 rows of 200 bp, loops graphed and fused: every
    number under the cell's limit; the W = 8 group's update keeps its table
    in shared memory, W = 10 and 12 in device memory; B1 counts in 64-bit
    fixed point with the LUT in shared memory."""
    nums, groups, counts, limits = order4_job(tmp_path, 11, 2_000, 200, cuda_device)
    assert all(nums[k] <= lim for k, lim in limits.items()), nums
    assert {W: g["update_table"] for W, g in groups.items()} == {
        8: "smem", 10: "device", 12: "device"}
    assert all(g["counts"] == "fixed" and g["smem_lut"] for g in groups.values()), groups
    assert counts["em.update_fused"] == 3, counts
