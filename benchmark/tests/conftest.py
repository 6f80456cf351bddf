"""CPU tests of the benchmark (``python -m pytest benchmark/tests -q``);
those marked ``cuda`` run on a card and skip elsewhere."""

import copy
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips with its reason otherwise)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# each cell at a size the CPU runs in seconds: rows and length
TINY = {
    "c4.em": {"args": {"n_seqs": 400, "seq_len": 60}},
}


def tiny_cell(name: str):
    """BENCHMARK.json's cell ``name`` at its TINY size."""
    from benchlib import spec

    cell = spec.cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["args"].update(TINY[name]["args"])
    return cell
