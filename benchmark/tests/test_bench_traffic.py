"""The frozen copies against what they were copied from: the generators
give chip_smoke.py's files for the same numpy seed, the bounds
chip_smoke.py's on the cells' shapes."""

import filecmp
import importlib.util
import os

import numpy as np
import pytest
import torch
from conftest import ROOT

from benchlib import roofline, traffic


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("bench_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config4_problem_matches(smoke, tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    fasta, meme = smoke.config4_problem(str(a))
    got = traffic.config4_problem(str(b), 0)
    assert filecmp.cmp(fasta, got.fasta, shallow=False)
    assert filecmp.cmp(meme, got.meme, shallow=False)


def test_pool_inputs_differ_and_repeat(tmp_path):
    cfg = {"generator": "config4_problem", "args": {"n_seqs": 50, "seq_len": 40}}
    x = traffic.make_input(cfg, str(tmp_path), [2 ** 40 + 3, 0], "x")
    y = traffic.make_input(cfg, str(tmp_path), [2 ** 40 + 3, 1], "y")
    z = traffic.make_input(cfg, str(tmp_path), [2 ** 40 + 3, 0], "z")
    assert np.array_equal(x.codes, z.codes) and not np.array_equal(x.codes, y.codes)


def cidx(S, N, L):
    return torch.zeros((S, N, L), dtype=torch.int32), torch.full((N,), L, dtype=torch.int32)


@pytest.mark.parametrize("N,W,M", [(10_000, 8, 4), (10_000, 10, 3), (10_000, 12, 3), (10_000, 12, 1)])
def test_em_bound_matches(smoke, N, W, M):
    codes, lens = cidx(2, N, 200)
    want = smoke.em_bound(codes, lens, 85, W, M)
    got = roofline.em_bound(2, N, 200, [200] * N, 85, W, M)
    assert got["bound_ms"] == pytest.approx(want["bound_ms"], rel=1e-12)
    assert (got["bytes"], got["ops"]) == (want["bytes"], want["ops"])
