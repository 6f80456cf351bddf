"""The CUDA kernels against their plain PyTorch versions, on the card.

``cuda`` lane: every test here needs a CUDA device and ``nvcc`` and skips
with its reason otherwise (the decision is made in a fixture, never at
import).  Run on a GPU machine with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

``chip_smoke.py`` runs the same checks (``KERNEL_CASES`` / ``check_kernel``
for the E+M kernel, ``SCORE_CASES`` / ``check_scores`` for the window-score
kernel, ``COUNTS_CASES`` / ``check_counts`` for the counts-from-r kernel,
``FLAT_CASES`` / ``check_flat`` for the three kernels on base-(A+1) codes,
``check_counts_calls`` for the two counts-from-r wrappers' one-kernel
calls, their workspace and CUDA-graph capture) at the main path's shapes.
This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.models import seeds as seeds_mod
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import log_odds_lut
from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em, cuda_flat, cuda_scores, encode
from bammmotif2_tpu_torch.ops.escore import NEG_INF, window_mask
from bammmotif2_tpu_torch.refinement.gibbs import occupancy

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
    # rows longer than a warp's buffer: a block per row, in tiles of one strand
    "long_rows": dict(N=40, L=9_000, W=12, K=2, M=2, S=2, ragged=True),
    "W8": dict(N=2_000, L=200, W=8, K=2, M=3, S=2),
    "W30": dict(N=2_000, L=200, W=30, K=2, M=3, S=2),
    # every lane of a warp on one count address
    "homopolymer_M2": dict(N=2_000, L=200, W=12, K=2, M=2, S=2, homopolymer=True),
    "K4_M4": dict(N=2_000, L=200, W=12, K=4, M=4, S=2),  # FDR's group
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
    # rows of 50 windows: runs of four cross row ends, vector stores misalign
    "unaligned": dict(N=333, L=61, W=12, K=2, M=3, S=2),
    "homopolymer": dict(N=2_000, L=200, W=12, K=2, M=2, S=2, homopolymer=True),
    # a width with no kernel of its own: the sliding loop over the shared LUT
    "W11_any_width": dict(N=2_000, L=200, W=11, K=2, M=2, S=2),
}


# Counts from r agree to |dC| <= CR_ATOL + CR_RTOL*|C|: the kernel sums in
# f32 per block and f64 globally, the plain version wholly in f64, and both
# round once.  For 0/1 r every partial is an integer and C must be equal.
CR_ATOL, CR_RTOL = 1e-5, 1e-6

# name -> geometry and r: "01" is the Gibbs sampler's occupancy (at most one
# window per (m, n)), "frac" a posterior (fractional, <= 1 per (m, n)),
# "unmasked" fractional with mass on invalid windows too
COUNTS_CASES = {
    "bench_M1_01": dict(N=10_000, L=200, W=12, K=2, M=1, S=2, r="01"),
    "bench_M10_01": dict(N=10_000, L=200, W=12, K=2, M=10, S=2, r="01"),
    "bench_M1_frac": dict(N=10_000, L=200, W=12, K=2, M=1, S=2, r="frac"),
    "bench_M10_frac": dict(N=10_000, L=200, W=12, K=2, M=10, S=2, r="frac"),
    "K0_frac": dict(N=2_000, L=200, W=8, K=0, M=3, S=2, r="frac"),
    "K1_01": dict(N=2_000, L=200, W=12, K=1, M=3, S=2, r="01"),
    "K3_frac": dict(N=2_000, L=200, W=12, K=3, M=2, S=2, r="frac"),
    "K4_smem_01": dict(N=2_000, L=200, W=12, K=4, M=2, S=2, r="01"),
    "K5_global_01": dict(N=2_000, L=200, W=12, K=5, M=2, S=2, r="01"),
    "K5_global_frac": dict(N=2_000, L=200, W=12, K=5, M=2, S=2, r="frac"),
    "ss": dict(N=2_000, L=200, W=12, K=2, M=1, S=1, r="01"),
    "A5": dict(N=300, L=60, W=8, K=3, M=2, S=2, A=5, r="frac"),
    "W8": dict(N=2_000, L=200, W=8, K=2, M=3, S=2, r="01"),
    "W30": dict(N=2_000, L=200, W=30, K=2, M=3, S=2, r="frac"),
    "short_and_empty_rows": dict(N=500, L=60, W=10, K=2, M=3, S=2, ragged=True, r="frac"),
    "mass_on_invalid_windows": dict(N=500, L=60, W=10, K=2, M=2, S=2, ragged=True, r="unmasked"),
    "long_rows": dict(N=40, L=9_000, W=12, K=2, M=2, S=2, ragged=True, r="01"),
    # planes of 333 x 61 floats: seeds 1 and 2 start off a 16-byte boundary
    "misaligned_L61_S1_01": dict(N=333, L=61, W=12, K=2, M=3, S=1, r="01"),
    "misaligned_L61_S1_frac": dict(N=333, L=61, W=12, K=2, M=3, S=1, r="frac"),
}


def counts_inputs(N, L, W, K, M, S, r, A=4, ragged=False, seed=0, device="cpu"):
    """(r [M, S, N, L], cidx, R, W) for counts_from_r_multi on kernel_inputs'
    sequences; r is zero past each row's window frontier unless
    ``r == "unmasked"``."""
    s_flat, cidx, lens, _q = kernel_inputs(N, L, W, K, 1, S, A=A, ragged=ragged, seed=seed,
                                           device=device)
    R = s_flat.shape[1] - 1
    n_win = L - W + 1
    mask = window_mask(lens, n_win, W)  # [N, n_win]
    g = torch.Generator(device=device).manual_seed(seed)
    occupied = torch.rand((M, N), generator=g, device=device) < 0.8
    if r == "01":
        pick = torch.rand((M, S, N, n_win), generator=g, device=device)
        pick = torch.where(mask[None, None], pick, -1.0).permute(0, 2, 1, 3).reshape(M, N, S * n_win)
        z = torch.where(occupied & mask.any(dim=1)[None], pick.argmax(dim=-1) + 1, 0)
        return occupancy(z, S, L, n_win), cidx, R, W
    w = torch.rand((M, S, N, n_win), generator=g, device=device)
    if r == "frac":
        w = torch.where(mask[None, None], w, 0.0)
    w = w / w.sum(dim=(1, 3), keepdim=True).clamp(min=1e-30)
    w = w * torch.rand((M, 1, N, 1), generator=g, device=device) * occupied[:, None, :, None]
    return torch.nn.functional.pad(w, (0, L - n_win)).contiguous(), cidx, R, W


def check_counts(case: dict, device) -> dict:
    """Counts-from-r kernel vs plain on the same CUDA tensors; raises
    AssertionError on a mismatch.  Returns the errors."""
    r, cidx, R, W = counts_inputs(**case, device=device)
    launches = cuda_counts.counts_from_r_multi.launches
    C = cuda_counts.counts_from_r_multi(r, cidx, R, W)
    torch.cuda.synchronize(device)
    assert cuda_counts.counts_from_r_multi.launches == launches + 1
    C_ref = cuda_counts.counts_from_r_multi_ref(r, cidx, R, W)
    assert C.shape == C_ref.shape == (r.shape[0], R + 1, W) and C.dtype == torch.float32
    d = (C - C_ref).abs()
    bound = CR_ATOL + CR_RTOL * C_ref.abs()
    out = {
        "max_abs_err": d.max().item(),
        "max_err_over_bound": (d / bound).max().item(),
        "bitwise_equal": float(torch.equal(C, C_ref)),
        "max_count": C_ref.abs().max().item(),
        "sentinel_mass": C_ref[:, -1].sum().item(),
    }
    assert bool(torch.isfinite(C).all()), out
    assert bool((d <= bound).all()), out
    if case["r"] == "01":
        assert torch.equal(C, C_ref), out
    return out


def planted_set(N, L, W, A, ragged, rng, homopolymer=False) -> tuple:
    """(sset, planted codes): random codes with a planted motif in 80% of
    rows and 1% ambiguous bases; ``ragged`` draws lengths in [0, L] so rows
    of length 0 and shorter than W occur; ``homopolymer`` makes row n one
    base (n mod A) throughout, with no motif and no ambiguous base."""
    alphabet = Alphabet.from_type("STANDARD" if A == 4 else "METHYLC")
    codes = rng.integers(0, A, (N, L)).astype(np.int8)
    planted = rng.integers(0, A, W)
    pos = rng.integers(0, L - W + 1, N)
    for n in np.nonzero(rng.random(N) < 0.8)[0]:
        codes[n, pos[n] : pos[n] + W] = planted
    codes[rng.random((N, L)) < 0.01] = -1
    if homopolymer:
        codes[:] = (np.arange(N) % A)[:, None]
    lens = np.full(N, L, np.int32)
    if ragged:
        lens = rng.integers(0, L + 1, N).astype(np.int32)
        lens[:3] = [0, W - 1, W]
        codes[np.arange(L)[None, :] >= lens[:, None]] = -2
    return SequenceSet(codes, lens, [f"s{i}" for i in range(N)], alphabet), planted


def kernel_inputs(N, L, W, K, M, S, A=4, ragged=False, seed=0, device="cpu",
                  homopolymer=False):
    """Planted-motif inputs for em_counts_multi: (s_flat, cidx, lens, q).

    The sequences of ``planted_set``.  Seed 0's LUT is the planted PWM's
    log-odds, the others perturb it (zero sentinel row kept).
    """
    rng = np.random.default_rng(seed)
    sset, planted = planted_set(N, L, W, A, ragged, rng, homopolymer)
    alphabet = sset.alphabet
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


# Flat-layout kernels (ops/cuda_flat.py) against their plain versions on the
# same CUDA tensors: window scores bit-equal (the kernel adds j = 0..W-1 in
# the plain version's order with __fadd_rn, and s5[qidx] == s_flat[cidx]),
# E+M by the E+M kernel's bar (C_ATOL, C_RTOL, LL_RTOL), counts from 0/1 r
# equal and from fractional r by CR_ATOL, CR_RTOL.  ``combined`` cases also
# hold them against the combined-layout kernels on the same sequences:
# scores bit-equal to B2, 0/1 counts equal to B3, E+M within B1's bar.
FLAT_CASES = {
    "bench_K2": dict(N=10_000, L=200, W=12, K=2, S=2, combined=True),
    "bench_K4": dict(N=10_000, L=200, W=12, K=4, S=2, combined=True),
    "K0": dict(N=2_000, L=200, W=8, K=0, S=2),
    "K1": dict(N=2_000, L=200, W=12, K=1, S=2),
    "K3": dict(N=2_000, L=200, W=12, K=3, S=2),
    "K4_W30_global": dict(N=2_000, L=200, W=30, K=4, S=2),
    "K5_global": dict(N=2_000, L=200, W=12, K=5, S=2, combined=True),
    "ss": dict(N=2_000, L=200, W=12, K=2, S=1),
    "A5": dict(N=300, L=60, W=8, K=3, S=2, A=5),
    "A5_K5_W30_global": dict(N=300, L=60, W=30, K=5, S=2, A=5),
    "W8": dict(N=2_000, L=200, W=8, K=2, S=2),
    "W30": dict(N=2_000, L=200, W=30, K=2, S=2),
    "short_and_empty_rows": dict(N=500, L=60, W=10, K=2, S=2, ragged=True),
    "long_rows": dict(N=40, L=9_000, W=12, K=2, S=2, ragged=True),
    # the counts kernel reads map5 (62.5 KB) through L1, counts to global f64
    "K5_map_through_L1": dict(N=2_000, L=200, W=12, K=5, S=2, ragged=True),
    "misaligned_L61_S1": dict(N=333, L=61, W=12, K=2, S=1),
}

FLAT_KERNELS = ("flat_em_counts", "flat_window_scores", "flat_counts_from_r")


def flat_inputs(N, L, W, K, S, A=4, ragged=False, seed=0, device="cpu", combined=False):
    """The flat passes' inputs on kernel_inputs' sequences (M=1): a dict of
    s_flat [R+1, W], cidx, qidx (encode.strand_base5_indices), lens, q [1],
    map5, and r [S, N, L] drawn as counts_inputs does, "01" and "frac"."""
    s_flat, cidx, lens, q = kernel_inputs(N, L, W, K, 1, S, A=A, ragged=ragged, seed=seed,
                                          device=device)
    sset, _planted = planted_set(N, L, W, A, ragged, np.random.default_rng(seed))
    r = {kind: counts_inputs(N, L, W, K, 1, S, kind, A=A, ragged=ragged, seed=seed,
                             device=device)[0][0].contiguous() for kind in ("01", "frac")}
    return dict(s_flat=s_flat[0].contiguous(), s_multi=s_flat, cidx=cidx, lens=lens, q=q,
                qidx=encode.strand_base5_indices(sset, K, S == 1, device),
                map5=torch.as_tensor(encode.map_base5_to_combined(A, K), device=device),
                r=r, A=A, K=K, W=W, R=s_flat.shape[1] - 1)


def check_flat(case: dict, device) -> dict:
    """The three flat kernels vs their plain versions (and, for ``combined``
    cases, vs the combined-layout kernels) on the same CUDA tensors; raises
    AssertionError on a mismatch.  Returns the errors by kernel."""
    x = flat_inputs(**case, device=device)
    kw = dict(A=x["A"], K=x["K"], W=x["W"])
    R = x["R"]
    before = (cuda_flat.em_counts.launches, cuda_flat.window_scores.launches,
              cuda_flat.counts_from_r.launches)
    sc, mk = cuda_flat.window_scores(x["s_flat"], x["qidx"], x["lens"], x["map5"], **kw)
    C, ll = cuda_flat.em_counts(x["s_flat"], x["qidx"], x["lens"], x["q"], x["map5"], R=R, **kw)
    Cr = {k: cuda_flat.counts_from_r(r, x["qidx"], x["map5"], R=R, **kw) for k, r in x["r"].items()}
    torch.cuda.synchronize(device)
    assert (cuda_flat.em_counts.launches, cuda_flat.window_scores.launches,
            cuda_flat.counts_from_r.launches) == (before[0] + 1, before[1] + 1, before[2] + 2)

    sc_ref, mk_ref = cuda_flat.window_scores_ref(x["s_flat"], x["qidx"], x["lens"], x["map5"], **kw)
    assert torch.equal(mk, mk_ref), "mask differs"
    assert torch.equal(sc, sc_ref), (sc - sc_ref).abs().max().item()
    C_ref, ll_ref = cuda_flat.em_counts_ref(x["s_flat"], x["qidx"], x["lens"], x["q"], x["map5"],
                                            R=R, **kw)
    dC = (C - C_ref).abs()
    ll_rel = abs(ll.item() - ll_ref.item()) / abs(ll_ref.item())
    out = {"flat_window_scores": {"max_abs_err": 0.0, "valid_windows": float(mk.sum().item())},
           "flat_em_counts": {"max_abs_err": dC.max().item(),
                              "max_err_over_bound": (dC / (C_ATOL + C_RTOL * C_ref.abs())).max().item(),
                              "ll_rel_err": ll_rel, "sentinel_mass": C[-1, 0].item()}}
    assert bool(torch.isfinite(C).all()) and bool(torch.isfinite(ll)), out
    assert bool((dC <= C_ATOL + C_RTOL * C_ref.abs()).all()) and ll_rel <= LL_RTOL, out
    errs = {}
    for k, r in x["r"].items():
        ref = cuda_flat.counts_from_r_ref(r, x["qidx"], x["map5"], R=R, **kw)
        d = (Cr[k] - ref).abs()
        errs[k] = d.max().item()
        assert bool((d <= CR_ATOL + CR_RTOL * ref.abs()).all()), (k, errs)
        if k == "01":
            assert torch.equal(Cr[k], ref), (k, errs)
    out["flat_counts_from_r"] = {"max_abs_err": max(errs.values()), "max_abs_err_01": errs["01"],
                                 "max_abs_err_frac": errs["frac"]}
    if case.get("combined"):
        b2, b2_mk = cuda_scores.window_scores(x["s_flat"], x["cidx"], x["lens"])
        b3 = cuda_counts.counts_from_r(x["r"]["01"], x["cidx"], R, x["W"])
        b1, b1_ll = cuda_em.em_counts_multi(x["s_multi"], x["cidx"], x["lens"], x["q"])
        torch.cuda.synchronize(device)
        d1 = (C - b1[0]).abs()
        b1_rel = abs(ll.item() - b1_ll[0].item()) / abs(b1_ll[0].item())
        out["vs_combined"] = {"scores_bit_equal_B2": float(torch.equal(sc, b2) and torch.equal(mk, b2_mk)),
                              "counts01_equal_B3": float(torch.equal(Cr["01"], b3)),
                              "em_max_abs_err_vs_B1": d1.max().item(), "em_ll_rel_err_vs_B1": b1_rel}
        assert out["vs_combined"]["scores_bit_equal_B2"] == 1.0, out
        assert out["vs_combined"]["counts01_equal_B3"] == 1.0, out
        assert bool((d1 <= C_ATOL + C_RTOL * b1[0].abs()).all()) and b1_rel <= LL_RTOL, out
    return out


def one_kernel_a_call(fn, kernel: str) -> list:
    """Every device operation of three calls of ``fn`` after a warm-up
    (torch.profiler); asserts that each call enqueued exactly one, the
    kernel ``kernel``.  Returns their names."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 3 and all(f"::{kernel}" in n for n in names), names
    return names


def offset_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_counts_calls(device) -> dict:
    """The one-launch counts-from-r wrappers (cuda_counts.counts_from_r_multi,
    cuda_flat.counts_from_r) across calls: each call one kernel and no other
    device operation; calls in a row and at two shapes interleaved on one
    stream, whose workspace must clean itself and grow; r starting off a
    16-byte boundary; a call on a side stream; a CUDA graph of one call,
    captured, then replayed on two r.  0/1 counts must equal the plain
    version's, fractional ones lie within CR_ATOL, CR_RTOL.  Raises
    AssertionError on a mismatch; returns the worst error."""
    worst = [0.0]

    def same(C, ref, exact):
        d = (C - ref).abs()
        worst[0] = max(worst[0], d.max().item() if d.numel() else 0.0)
        assert bool((d <= CR_ATOL + CR_RTOL * ref.abs()).all()), d.max().item()
        if exact:
            assert torch.equal(C, ref), d.max().item()

    small = counts_inputs(N=500, L=60, W=10, K=2, M=3, S=2, r="frac", device=device)
    big = counts_inputs(N=800, L=120, W=12, K=4, M=4, S=2, r="01", device=device)
    flat = flat_inputs(N=400, L=80, W=8, K=3, S=2, device=device)
    fkw = dict(A=4, K=3, W=8, R=flat["R"])

    def b3(args):
        return cuda_counts.counts_from_r_multi(*args), cuda_counts.counts_from_r_multi_ref(*args)

    def b4c(r):
        return (cuda_flat.counts_from_r(r, flat["qidx"], flat["map5"], **fkw),
                cuda_flat.counts_from_r_ref(r, flat["qidx"], flat["map5"], **fkw))

    # in a row, then two shapes and both wrappers interleaved on one stream
    for args, exact in ((small, False), (small, False), (big, True), (small, False), (big, True)):
        same(*b3(args), exact)
        same(*b4c(flat["r"]["01"]), True)
        same(*b4c(flat["r"]["frac"]), False)
    # planes off a 16-byte boundary (head and tail of the streaming read)
    same(*b3((offset_copy(big[0]), *big[1:])), True)
    same(*b4c(offset_copy(flat["r"]["01"])), True)
    # a side stream: its own workspace
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        C, ref = b3(big)
        Cf, reff = b4c(flat["r"]["01"])
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    same(C, ref, True)
    same(Cf, reff, True)
    # one kernel and no other device operation a call
    names = {"B3": one_kernel_a_call(lambda: cuda_counts.counts_from_r_multi(*big), "counts_kernel"),
             "B4c": one_kernel_a_call(lambda: cuda_flat.counts_from_r(
                 flat["r"]["01"], flat["qidx"], flat["map5"], **fkw), "flat_counts_kernel")}
    # a CUDA graph of one call each, replayed on the captured r, then on new r
    r_b3, r_flat = big[0].clone(), flat["r"]["01"].clone()
    other = counts_inputs(N=800, L=120, W=12, K=4, M=4, S=2, r="01", seed=1, device=device)[0]
    other_flat = counts_inputs(N=400, L=80, W=8, K=3, M=1, S=2, r="01", seed=1,
                               device=device)[0][0]
    cap = torch.cuda.Stream(device)
    cap.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(cap):  # warm-up: the capture stream's workspace
        cuda_counts.counts_from_r_multi(r_b3, *big[1:])
        cuda_flat.counts_from_r(r_flat, flat["qidx"], flat["map5"], **fkw)
    torch.cuda.current_stream(device).wait_stream(cap)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=cap):
        C = cuda_counts.counts_from_r_multi(r_b3, *big[1:])
        Cf = cuda_flat.counts_from_r(r_flat, flat["qidx"], flat["map5"], **fkw)
    for new_r, new_flat in ((r_b3.clone(), r_flat.clone()), (other, other_flat)):
        r_b3.copy_(new_r)
        r_flat.copy_(new_flat)
        graph.replay()
        torch.cuda.synchronize(device)
        same(C, cuda_counts.counts_from_r_multi_ref(r_b3, *big[1:]), True)
        same(Cf, cuda_flat.counts_from_r_ref(r_flat, flat["qidx"], flat["map5"], **fkw), True)
    return {"max_abs_err": worst[0], "profiled_kernels": names}


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(COUNTS_CASES))
def test_counts_kernel_matches_plain(cuda_device, name):
    check_counts(COUNTS_CASES[name], cuda_device)


@pytest.mark.cuda
def test_counts_calls_one_kernel_workspace_and_graph(cuda_device):
    check_counts_calls(cuda_device)


@pytest.mark.cuda
def test_counts_wrapper_rejects_bad_inputs(cuda_device):
    r, cidx, R, W = counts_inputs(N=20, L=30, W=6, K=1, M=2, S=2, r="frac", device=cuda_device)
    with pytest.raises(TypeError):
        cuda_counts.counts_from_r_multi(r.double(), cidx, R, W)
    with pytest.raises(ValueError):
        cuda_counts.counts_from_r_multi(r, cidx.cpu(), R, W)
    with pytest.raises(ValueError):
        cuda_counts.counts_from_r_multi(r[:, :, :, ::2], cidx, R, W)
    with pytest.raises(ValueError):
        cuda_counts.counts_from_r_multi(r[:, :, :-1].contiguous(), cidx, R, W)
    with pytest.raises(ValueError):
        cuda_counts.counts_from_r_multi(r, cidx, R, 31)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLAT_CASES))
def test_flat_kernels_match_plain(cuda_device, name):
    check_flat(FLAT_CASES[name], cuda_device)


@pytest.mark.cuda
def test_flat_wrappers_reject_bad_inputs(cuda_device):
    x = flat_inputs(N=20, L=30, W=6, K=1, S=2, device=cuda_device)
    kw = dict(A=4, K=1, W=6)
    with pytest.raises(TypeError):
        cuda_flat.window_scores(x["s_flat"], x["qidx"].long(), x["lens"], x["map5"], **kw)
    with pytest.raises(ValueError):
        cuda_flat.window_scores(x["s_flat"], x["qidx"], x["lens"].cpu(), x["map5"], **kw)
    with pytest.raises(ValueError):
        cuda_flat.em_counts(x["s_flat"], x["qidx"], x["lens"], x["q"], x["map5"][:-1], R=x["R"],
                            A=4, K=1, W=6)
    with pytest.raises(ValueError):
        cuda_flat.em_counts(x["s_flat"], x["qidx"][:, :, ::2], x["lens"], x["q"], x["map5"],
                            R=x["R"], **kw)
    with pytest.raises(ValueError):
        cuda_flat.counts_from_r(x["r"]["01"][:, :-1].contiguous(), x["qidx"], x["map5"], R=x["R"], **kw)
    with pytest.raises(ValueError):
        cuda_flat.counts_from_r(x["r"]["01"], x["qidx"], x["map5"], R=x["R"], A=4, K=1, W=31)
