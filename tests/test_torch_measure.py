"""The port's measurement helpers, on the CPU: chip_smoke.py's bound for
counts from r against a brute-force count, the rank tests of
bammmotif2_tpu_torch/tools/ab.py on synthetic process rates, and the source
edits of bammmotif2_tpu_torch/tools/kernel_variants.py."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from bammmotif2_tpu_torch.tools import ab, kernel_variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("bamm_chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("M,W", [(1, 12), (3, 8), (2, 30)])
def test_counts_bound_counts_r_at_starts_and_live_code_sectors(M, W):
    """Bytes: r at every window start, the 32-byte code sectors that the
    non-zero r at window starts touch (each once), the count tables; r past
    the last start is not read.  Operations: W adds a non-zero r."""
    cs = _chip_smoke()
    rng = np.random.default_rng(M * 100 + W)
    S, N, L, R1 = 2, 30, 50, 85
    n_win = L - W + 1
    codes = torch.as_tensor(rng.integers(0, R1, (S, N, L)), dtype=torch.int32)
    r = torch.zeros(M, S, N, L)
    for m in range(M):
        for n in range(N):
            if rng.random() < 0.7:
                r[m, rng.integers(S), n, rng.integers(n_win)] = 1.0
    r[0, 0, 0, L - 1] = 1.0  # past the last window start
    sectors, live = set(), 0
    for m, s, n, i in zip(*np.nonzero(r[..., :n_win].numpy())):
        live += 1
        first = ((s * N + n) * L + i) * 4
        sectors.update(range(first // 32, (first + 4 * W - 1) // 32 + 1))
    b = cs.counts_bound(r, codes, R1, W)
    assert b["bytes"] == M * S * N * n_win * 4 + 32 * len(sectors) + M * R1 * W * 4
    assert b["ops"] == live * W


@pytest.mark.parametrize("shift,distinct", [(40.0, True), (0.0, False)])
def test_cgs_ab_summary_rank_tests(shift, distinct):
    """Twelve alternating rounds: a shifted change is told apart by both
    tests; equal rates are not, and the order within a round is not."""
    rng = np.random.default_rng(0)
    procs = []
    for rnd in range(12):
        order = ("base", "change") if rnd % 2 == 0 else ("change", "base")
        for pos, tree in enumerate(order):
            off = shift if tree == "change" else 0.0
            procs.append({"tree": tree, "round": rnd, "position": pos,
                          "metrics": {"sweeps_per_s_cuda": 150.0 + off + rng.normal(0, 5),
                                      "sweeps_per_s_plain": 130.0 + rng.normal(0, 5)}})
    out = ab.summary(procs)
    cuda = out["sweeps_per_s_cuda"]
    assert len(cuda["base"]) == len(cuda["change"]) == 12
    assert (cuda["mannwhitney_p_change_vs_base"] < 0.01) == distinct
    assert (cuda["wilcoxon_p_paired_rounds"] < 0.01) == distinct
    assert (cuda["median_paired_change_minus_base"] > 20) == distinct
    assert out["sweeps_per_s_plain"]["mannwhitney_p_change_vs_base"] > 0.01


def test_ab_summary_leaves_out_processes_not_measured():
    """A device time that device_ms could not read ("not measured") is left
    out of its metric's tests and counted; its round drops out of the paired
    test, and a metric with no value on one side gets null tests."""
    procs = []
    for rnd in range(4):
        order = ("base", "change") if rnd % 2 == 0 else ("change", "base")
        for pos, tree in enumerate(order):
            lost = tree == "change" and rnd == 1
            procs.append({"tree": tree, "round": rnd, "position": pos, "metrics": {
                "device_ms": "not measured" if lost else 0.1 + rnd * 0.01 + (tree == "change"),
                "never": "not measured" if tree == "base" else 1.0}})
    out = ab.summary(procs)
    dev = out["device_ms"]
    assert dev["not_measured"] == 1 and len(dev["base"]) == 4 and len(dev["change"]) == 3
    assert dev["median_paired_change_minus_base"] == pytest.approx(1.0)
    assert dev["mannwhitney_p_change_vs_base"] < 0.1
    never = out["never"]
    assert never["not_measured"] == 4 and never["median_base"] is None
    assert never["mannwhitney_p_change_vs_base"] is None and never["wilcoxon_p_paired_rounds"] is None


@pytest.mark.parametrize("design", sorted(kernel_variants.DESIGNS))
def test_kernel_variant_edits_apply_to_this_source(design):
    """Every variant's edits apply exactly once to this checkout's kernel
    source (its headers but common.cuh written into it), and each variant
    but ``as_is`` changes it."""
    source, _kernel, variants = kernel_variants.DESIGNS[design]
    csrc = os.path.join(ROOT, "bammmotif2_tpu_torch", "csrc")
    with open(os.path.join(csrc, f"{source}.cu")) as fh:
        src = kernel_variants.inline_headers(fh.read(), csrc)
    for name, edits in variants.items():
        out = kernel_variants.variant_source(src, edits)
        assert (out == src) == (name == "as_is"), name
