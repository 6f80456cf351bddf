"""The CUDA kernels against their plain PyTorch versions, on the card.

``cuda`` lane: every test here needs a CUDA device and ``nvcc`` and skips
with its reason otherwise (the decision is made in a fixture, never at
import).  Run on a GPU machine with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

``chip_smoke.py`` runs the same checks (``KERNEL_CASES`` / ``check_kernel``
for the E+M kernel, ``SCORE_CASES`` / ``check_scores`` for the window-score
kernel) at the main path's shapes.  This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.models import seeds as seeds_mod
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import log_odds_lut
from bammmotif2_tpu_torch.ops import cuda_em, cuda_scores, encode
from bammmotif2_tpu_torch.ops.escore import NEG_INF

# Counts agree to |dC| <= C_ATOL + C_RTOL*|C| and ll to LL_RTOL: the
# kernel's float atomics add in an order that varies from run to run, and
# it forms log Z_n with an online (max, sum exp) pair where the plain
# version takes the max first.  The plain version's counts are summed in
# float64 (escore.mstep_counts); the same check against the plain version
# evaluated wholly in float64 is reported beside it.
C_ATOL, C_RTOL, LL_RTOL = 1e-4, 1e-5, 1e-5

# name -> geometry; "bench" is bench.py's problem (10k x 200 bp, W=12, K=2)
KERNEL_CASES = {
    "bench_M1": dict(N=10_000, L=200, W=12, K=2, M=1, S=2),
    "bench_M3": dict(N=10_000, L=200, W=12, K=2, M=3, S=2),
    "K4_M2": dict(N=2_000, L=200, W=12, K=4, M=2, S=2),
    "K5_global_atomics": dict(N=2_000, L=200, W=12, K=5, M=2, S=2),
    "ss": dict(N=2_000, L=200, W=12, K=2, M=1, S=1),
    "A5_small": dict(N=300, L=60, W=8, K=3, M=2, S=1, A=5),
    "short_and_empty_rows": dict(N=500, L=60, W=10, K=2, M=3, S=2, ragged=True),
}


# Window scores agree to |ds| <= SC_ATOL + SC_RTOL*|s| on valid windows (the
# kernel adds j = 0..W-1 in the plain version's order and forms no FMA, so
# it is expected to be bit-equal; the bound is the parity bar of the JAX
# suite's kernel tests), with an identical mask and exactly NEG_INF on
# invalid windows.
SC_ATOL, SC_RTOL = 1e-5, 1e-6

# name -> geometry; "10k" is bench.py's set size at BASELINE config 5's width
SCORE_CASES = {
    "10k_M1": dict(N=10_000, L=200, W=12, K=2, M=1, S=2),
    "10k_M10": dict(N=10_000, L=200, W=12, K=2, M=10, S=2),
    "K4_smem_lut": dict(N=2_000, L=200, W=12, K=4, M=2, S=2),
    "K5_global_lut": dict(N=2_000, L=200, W=12, K=5, M=2, S=2),
    "ss": dict(N=2_000, L=200, W=12, K=2, M=1, S=1),
    "A5": dict(N=300, L=60, W=8, K=3, M=2, S=2, A=5),
    "W8": dict(N=2_000, L=200, W=8, K=2, M=3, S=2),
    "W30": dict(N=2_000, L=200, W=30, K=2, M=3, S=2),
    "short_and_empty_rows": dict(N=500, L=60, W=10, K=2, M=3, S=2, ragged=True),
    "long_rows_tiled": dict(N=40, L=9_000, W=12, K=2, M=2, S=2, ragged=True),
}


def kernel_inputs(N, L, W, K, M, S, A=4, ragged=False, seed=0, device="cpu"):
    """Planted-motif inputs for em_counts_multi: (s_flat, cidx, lens, q).

    Random codes with a planted motif in 80% of rows and 1% ambiguous
    bases; ``ragged`` draws lengths in [0, L] so rows of length 0 and
    shorter than W occur.  Seed 0's LUT is the planted PWM's log-odds,
    the others perturb it (zero sentinel row kept).
    """
    rng = np.random.default_rng(seed)
    alphabet = Alphabet.from_type("STANDARD" if A == 4 else "METHYLC")
    codes = rng.integers(0, A, (N, L)).astype(np.int8)
    planted = rng.integers(0, A, W)
    pos = rng.integers(0, L - W + 1, N)
    for n in np.nonzero(rng.random(N) < 0.8)[0]:
        codes[n, pos[n] : pos[n] + W] = planted
    codes[rng.random((N, L)) < 0.01] = -1
    lens = np.full(N, L, np.int32)
    if ragged:
        lens = rng.integers(0, L + 1, N).astype(np.int32)
        lens[:3] = [0, W - 1, W]
        codes[np.arange(L)[None, :] >= lens[:, None]] = -2
    sset = SequenceSet(codes, lens, [f"s{i}" for i in range(N)], alphabet)
    bg = BackgroundModel.from_sequence_set(sset, order=min(2, K), ss=S == 1)
    pwm = np.full((W, A), 0.3 / (A - 1))
    pwm[np.arange(W), planted] = 0.7
    motif = seeds_mod.motif_from_pwm(pwm, K, sset.base_frequencies(), alphabet=alphabet)
    v = tuple(torch.tensor(vk, dtype=torch.float32) for vk in motif.v)
    base = log_odds_lut(v, torch.tensor(bg.conditional_flat(K), dtype=torch.float32)).numpy()
    luts = np.stack([
        base if m == 0 else base * rng.uniform(0.6, 1.4) + rng.normal(0, 0.05, base.shape)
        for m in range(M)
    ]).astype(np.float32)
    luts[:, -1, :] = 0.0
    cidx, lens_t = encode.strand_indices(sset, K, ss=S == 1, device=device)
    s_flat = torch.tensor(luts, device=device)
    q = torch.tensor(rng.uniform(0.3, 0.95, M), dtype=torch.float32, device=device)
    return s_flat, cidx, lens_t, q


def check_kernel(case: dict, device) -> dict:
    """Kernel vs plain on the same CUDA tensors; raises AssertionError on
    a mismatch.  Returns the errors."""
    s_flat, cidx, lens, q = kernel_inputs(**case, device=device)
    launches = cuda_em.em_counts_multi.launches
    C, ll = cuda_em.em_counts_multi(s_flat, cidx, lens, q)
    torch.cuda.synchronize(device)
    assert cuda_em.em_counts_multi.launches == launches + 1
    C_ref, ll_ref = cuda_em.em_counts_multi_ref(s_flat, cidx, lens, q)
    C64, _ = cuda_em.em_counts_multi_ref(s_flat.double(), cidx, lens, q.double())
    dC = (C - C_ref).abs()
    bound = C_ATOL + C_RTOL * C_ref.abs()
    ll_rel = ((ll - ll_ref).abs() / ll_ref.abs()).max().item()
    out = {
        "max_abs_err": dC.max().item(),
        "max_err_over_bound": (dC / bound).max().item(),
        "ll_max_rel_err": ll_rel,
        "max_abs_err_vs_f64": (C.double() - C64).abs().max().item(),
        "plain_max_abs_err_vs_f64": (C_ref.double() - C64).abs().max().item(),
        "sentinel_mass": C[:, -1, 0].sum().item(),
    }
    assert bool(torch.isfinite(C).all()) and bool(torch.isfinite(ll).all()), out
    assert bool((dC <= bound).all()), out
    assert ll_rel <= LL_RTOL, out
    return out


def check_scores(case: dict, device) -> dict:
    """Window-score kernel vs plain on the same CUDA tensors; raises
    AssertionError on a mismatch.  Returns the errors."""
    s_flat, cidx, lens, _q = kernel_inputs(**case, device=device)
    launches = cuda_scores.window_scores_multi.launches
    sc, mk = cuda_scores.window_scores_multi(s_flat, cidx, lens)
    torch.cuda.synchronize(device)
    assert cuda_scores.window_scores_multi.launches == launches + 1
    sc_ref, mk_ref = cuda_scores.window_scores_multi_ref(s_flat, cidx, lens)
    assert sc.shape == sc_ref.shape and sc.dtype == torch.float32
    assert torch.equal(mk, mk_ref), "mask differs"
    valid = mk_ref[None, None].expand_as(sc_ref)
    d = (sc - sc_ref).abs()[valid]
    bound = SC_ATOL + SC_RTOL * sc_ref.abs()[valid]
    out = {
        "max_abs_err": d.max().item() if d.numel() else 0.0,
        "max_err_over_bound": (d / bound).max().item() if d.numel() else 0.0,
        "bitwise_equal": float(torch.equal(sc, sc_ref)),
        "valid_windows": float(valid.sum().item()),
    }
    assert bool((sc[~valid] == NEG_INF).all()), out
    assert bool((d <= bound).all()), out
    return out


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
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_matches_plain(cuda_device, name):
    check_kernel(KERNEL_CASES[name], cuda_device)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    s_flat, cidx, lens, q = kernel_inputs(N=20, L=30, W=6, K=1, M=1, S=2, device=cuda_device)
    with pytest.raises(TypeError):
        cuda_em.em_counts_multi(s_flat.double(), cidx, lens, q)
    with pytest.raises(ValueError):
        cuda_em.em_counts_multi(s_flat, cidx, lens.cpu(), q)
    with pytest.raises(ValueError):
        cuda_em.em_counts_multi(s_flat, cidx[:, :, ::2], lens, q)
    with pytest.raises(ValueError):
        cuda_em.em_counts_multi(s_flat, cidx, lens, q.repeat(2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCORE_CASES))
def test_scores_kernel_matches_plain(cuda_device, name):
    check_scores(SCORE_CASES[name], cuda_device)


@pytest.mark.cuda
def test_scores_wrapper_rejects_bad_inputs(cuda_device):
    s_flat, cidx, lens, _q = kernel_inputs(N=20, L=30, W=6, K=1, M=2, S=2, device=cuda_device)
    with pytest.raises(TypeError):
        cuda_scores.window_scores_multi(s_flat.double(), cidx, lens)
    with pytest.raises(ValueError):
        cuda_scores.window_scores_multi(s_flat, cidx, lens.cpu())
    with pytest.raises(ValueError):
        cuda_scores.window_scores_multi(s_flat, cidx[:, :, ::2], lens)
    with pytest.raises(ValueError):
        cuda_scores.window_scores_multi(s_flat, cidx, lens[:-1])
    with pytest.raises(ValueError):
        cuda_scores.window_scores_multi(s_flat, cidx[:, :, :5], lens)
