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
calls, their workspace and CUDA-graph capture, ``check_flat_calls`` for
what a flat E+M or window-score call enqueues, ``check_condition`` for the
loops' stop-test kernel, ``check_loops`` for the EM loop and the CGS
sweeps each as one WHILE-node graph) at the main path's shapes; the CGS
draw kernels' checks are in tests/test_torch_draws.py.
``check_traced_fdr`` runs an FDR job under torch.profiler against the same
job untraced, and ``check_cupti_store`` a WHILE-node loop under it, each
in a process of its own (``python tests/test_torch_cuda.py KIND CASE
TMP``): CUPTI keeps a bounded store of records of the operations run
inside WHILE nodes, for the life of a process (CUPTI_LOOP_RECORDS).
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
from bammmotif2_tpu_torch.ops import (
    cuda_counts, cuda_em, cuda_flat, cuda_scores, cuda_while, encode,
)
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
    # seed stacks (cuda_em.launch_plan, seed_launches): the grid split over
    # 16, 32 and 33 seeds at K=0 and K=2, one launch each
    **{f"{'bench' if K == 2 else 'K0'}_M{M}": dict(N=10_000, L=200, W=12, K=K, M=M, S=2)
       for K in (0, 2) for M in (16, 32, 33)},
    # float counts, LUT through L1: a launch a seed (one launch of the stack
    # left each seed 1/33 of the grid and missed the bar)
    "K4_W20_M33_float_counts": dict(N=10_000, L=200, W=20, K=4, M=33, S=2),
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
    # seed stacks (cuda_scores.launch_plan): balanced chunks of seeds a block
    **{f"{'10k' if K == 2 else '10k_K0'}_M{M}": dict(N=10_000, L=200, W=12, K=K, M=M, S=2)
       for K in (0, 2) for M in (16, 32, 33)},
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
    # seed stacks: one launch, a seed's blocks beside the others' on grid y
    **{f"{'bench' if K == 2 else 'K0'}_M{M}_01": dict(N=10_000, L=200, W=12, K=K, M=M, S=2,
                                                       r="01")
       for K in (0, 2) for M in (16, 32, 33)},
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
    M, R1, W = s_flat.shape
    plan = cuda_em.launch_plan(M, R1, W, cidx.shape[0], cidx.shape[2])
    assert cuda_em.em_counts_multi.launches == launches + len(cuda_em.seed_launches(plan, M))
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


# B1's pass dealt to the seeds still active (``cuda_em.em_pass``'s
# ``activity``): c4.em's W=8 and W=12 groups (10k x 200 bp, K=2, M=4), and a
# float-count plan (K=4, W=20), which launches each seed on its own
ACTIVITY_CASES = {
    "c4_W8_M4": dict(N=10_000, L=200, W=8, K=2, M=4, S=2),
    "c4_W12_M4": dict(N=10_000, L=200, W=12, K=2, M=4, S=2),
    "K4_W20_M4_float_counts": dict(N=10_000, L=200, W=20, K=4, M=4, S=2),
}


def check_activity(case: dict, device) -> dict:
    """B1's pass with the EM loop's activity (running, vds, eps) against
    the pass without it, for every set of active seeds, from all M down to
    one with the frozen ones at every position (a frozen seed's v_diff
    under epsilon, or NaN), and for the loop stopped: each active seed's Cd
    within the E+M bar of the full pass's and its ll (its logz row's sum)
    within LL_RTOL; each frozen seed's Cd left zero and its logz row
    untouched (a sentinel); the launches of the full pass (a float-count
    plan's launch of a frozen seed returns at once).  Raises AssertionError
    on a mismatch; returns the errors."""
    import itertools

    s_flat, cidx, lens, q = kernel_inputs(**case, device=device)
    M, R1, W = s_flat.shape
    N = cidx.shape[1]
    plan = cuda_em.launch_plan(M, R1, W, cidx.shape[0], cidx.shape[2])
    per_call = len(cuda_em.seed_launches(plan, M))
    Cd_ref = torch.zeros((M, R1, W), dtype=torch.float64, device=device)
    logz_ref = torch.empty((M, N), device=device)
    cuda_em.em_pass(s_flat, cidx, lens, q, Cd_ref, logz_ref)
    ll_ref = logz_ref.double().sum(dim=1)
    bound = C_ATOL + C_RTOL * Cd_ref.abs()
    eps, sentinel = torch.tensor(1e-3, device=device), 12345.0
    frozen_vd = torch.tensor([1e-4, float("nan")], device=device)[
        torch.arange(M, device=device) % 2]
    sets = [(a, True) for n in range(M, 0, -1) for a in itertools.combinations(range(M), n)]
    running = torch.tensor(True, device=device)
    for bad in ((running, eps.reshape(1), eps), (running.int(), frozen_vd, eps),
                (running, frozen_vd.cpu(), eps)):
        with pytest.raises(ValueError):
            cuda_em.em_pass(s_flat, cidx, lens, q, Cd_ref.clone(), logz_ref.clone(),
                            activity=bad)
    out = {"plan": plan._asdict(), "launches_a_call": per_call, "cases": 0,
           "max_err_over_bound": 0.0, "ll_max_rel_err": 0.0, "logz_bit_equal": True}
    for active, running in sets + [(tuple(range(M)), False)]:
        on = torch.zeros(M, dtype=torch.bool, device=device)
        on[list(active)] = True
        vds = torch.where(on, torch.tensor(0.5, device=device), frozen_vd)
        on &= running
        Cd = torch.zeros_like(Cd_ref)
        logz = torch.full((M, N), sentinel, device=device)
        launches = cuda_em.em_counts_multi.launches
        cuda_em.em_pass(s_flat, cidx, lens, q, Cd, logz,
                        activity=(torch.tensor(running, device=device), vds, eps))
        torch.cuda.synchronize(device)
        tag = {"active": active, "running": running}
        assert cuda_em.em_counts_multi.launches - launches == per_call, tag
        assert not bool(Cd[~on].any()) and bool((logz[~on] == sentinel).all()), tag
        if bool(on.any()):
            err = ((Cd[on] - Cd_ref[on]).abs() / bound[on]).max().item()
            ll_rel = ((logz[on].double().sum(dim=1) - ll_ref[on]).abs()
                      / ll_ref[on].abs()).max().item()
            out["max_err_over_bound"] = max(out["max_err_over_bound"], err)
            out["ll_max_rel_err"] = max(out["ll_max_rel_err"], ll_rel)
            out["logz_bit_equal"] &= torch.equal(logz[on], logz_ref[on])
            assert err <= 1 and ll_rel <= LL_RTOL, {**tag, **out}
        out["cases"] += 1
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
# The flat kernels run B1's, B2's and B3's plans for one seed (ops/
# cuda_flat.py's em_plan, scores_plan, counts_plan).  The E+M kernel reads
# map5 through L1, the scores kernel stages it where that costs an SM no
# resident block, the counts kernel beside its counts where both fit.  The
# comments name the branches a case reaches beyond the common one (a warp a
# sequence, LUT and counts in shared memory, the scores' map staged).
FLAT_CASES = {
    "bench_K2": dict(N=10_000, L=200, W=12, K=2, S=2, combined=True),
    # counts from r: map5 through L1 (beside K=4's counts it passes SMEM_TARGET)
    "bench_K4": dict(N=10_000, L=200, W=12, K=4, S=2, combined=True),
    "K0": dict(N=2_000, L=200, W=8, K=0, S=2),
    "K1": dict(N=2_000, L=200, W=12, K=1, S=2),
    "K3": dict(N=2_000, L=200, W=12, K=3, S=2),
    # E+M: float shared counts ([R1, W] is 164 KB as float and does not fit
    # as fixed point), the LUT through L1
    "K4_W30_float_counts": dict(N=2_000, L=200, W=30, K=4, S=2),
    # E+M: f64 global counts; every LUT through L1; scores: map5 through L1
    # (staged, its 62.5 KB would halve the blocks an SM)
    "K5_global": dict(N=2_000, L=200, W=12, K=5, S=2, combined=True),
    "ss": dict(N=2_000, L=200, W=12, K=2, S=1),
    "A5": dict(N=300, L=60, W=8, K=3, S=2, A=5),
    "A5_K5_W30_global": dict(N=300, L=60, W=30, K=5, S=2, A=5),
    "W8": dict(N=2_000, L=200, W=8, K=2, S=2),
    "W30": dict(N=2_000, L=200, W=30, K=2, S=2),
    "short_and_empty_rows": dict(N=500, L=60, W=10, K=2, S=2, ragged=True),
    # E+M: a block a sequence, in tiles of one strand
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


def device_op_names(fn, calls: int = 3, attempts: int = 4) -> list:
    """The names of every device operation of ``calls`` calls of ``fn``
    after a warm-up (torch.profiler).  A profiler window sometimes drops
    device events (PERF.md §7), which reads as a call that enqueued less:
    a window in which some operation did not occur a whole multiple of
    ``calls`` times is taken again, ``attempts`` windows in all, and the
    last one is returned if none was whole."""
    from collections import Counter

    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names and all(n % calls == 0 for n in Counter(names).values()):
            break
    return names


def one_kernel_a_call(fn, kernel: str) -> list:
    """Every device operation of three calls of ``fn`` after a warm-up;
    asserts that each call enqueued exactly one, the kernel ``kernel``.
    Returns their names."""
    names = device_op_names(fn)
    assert len(names) == 3 and all(f"::{kernel}" in n for n in names), names
    return names


def check_flat_calls(device) -> dict:
    """What one flat E+M call and one flat window-score call enqueue (three
    calls each, torch.profiler): the scores call its kernel and nothing
    else; the E+M call no more operations than ``cuda_em.em_counts_multi``
    at M=1, only fills, its kernel and the combined pass's rounding and ll
    kernels: no gather of the LUT, no fold of the counts.  Raises
    AssertionError otherwise; returns the names of one call's operations."""
    x = flat_inputs(N=2_000, L=200, W=12, K=2, S=2, device=device)
    kw = dict(A=4, K=2, W=12)
    scores = one_kernel_a_call(lambda: cuda_flat.window_scores(
        x["s_flat"], x["qidx"], x["lens"], x["map5"], **kw), "flat_scores_kernel")
    em = device_op_names(lambda: cuda_flat.em_counts(
        x["s_flat"], x["qidx"], x["lens"], x["q"], x["map5"], R=x["R"], **kw))
    b1 = device_op_names(lambda: cuda_em.em_counts_multi(x["s_multi"], x["cidx"], x["lens"], x["q"]))
    allowed = ("::flat_em_kernel<", "::round_counts_kernel(", "::ll_reduce_kernel(", "FillFunctor")
    assert len(em) <= len(b1) and all(any(a in n for a in allowed) for n in em), (em, b1)
    assert sum("::flat_em_kernel<" in n for n in em) == 3, em
    return {"flat_window_scores": scores[:1], "flat_em_counts": em[: len(em) // 3],
            "em_counts_multi_ops": len(b1) // 3}


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
    16-byte boundary; a call on a side stream; a CUDA graph of one call
    each (one of a 33-seed stack among them), captured, then replayed on two
    r.  0/1 counts must equal the plain
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
    stack = counts_inputs(N=800, L=120, W=12, K=0, M=33, S=2, r="01", device=device)
    flat = flat_inputs(N=400, L=80, W=8, K=3, S=2, device=device)
    fkw = dict(A=4, K=3, W=8, R=flat["R"])

    def b3(args):
        return cuda_counts.counts_from_r_multi(*args), cuda_counts.counts_from_r_multi_ref(*args)

    def b4c(r):
        return (cuda_flat.counts_from_r(r, flat["qidx"], flat["map5"], **fkw),
                cuda_flat.counts_from_r_ref(r, flat["qidx"], flat["map5"], **fkw))

    # in a row, then two shapes and both wrappers interleaved on one stream
    for args, exact in ((small, False), (small, False), (big, True), (small, False), (big, True),
                        (stack, True), (small, False)):
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
    r_b3, r_flat, r_stack = big[0].clone(), flat["r"]["01"].clone(), stack[0].clone()
    other = counts_inputs(N=800, L=120, W=12, K=4, M=4, S=2, r="01", seed=1, device=device)[0]
    other_flat = counts_inputs(N=400, L=80, W=8, K=3, M=1, S=2, r="01", seed=1,
                               device=device)[0][0]
    cap = torch.cuda.Stream(device)
    cap.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(cap):  # warm-up: the capture stream's workspace
        cuda_counts.counts_from_r_multi(r_b3, *big[1:])
        cuda_counts.counts_from_r_multi(r_stack, *stack[1:])
        cuda_flat.counts_from_r(r_flat, flat["qidx"], flat["map5"], **fkw)
    torch.cuda.current_stream(device).wait_stream(cap)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=cap):
        C = cuda_counts.counts_from_r_multi(r_b3, *big[1:])
        Cs = cuda_counts.counts_from_r_multi(r_stack, *stack[1:])
        Cf = cuda_flat.counts_from_r(r_flat, flat["qidx"], flat["map5"], **fkw)
    other_stack = counts_inputs(N=800, L=120, W=12, K=0, M=33, S=2, r="01", seed=1,
                                device=device)[0]
    for new_r, new_flat, new_stack in ((r_b3.clone(), r_flat.clone(), r_stack.clone()),
                                       (other, other_flat, other_stack)):
        r_b3.copy_(new_r)
        r_flat.copy_(new_flat)
        r_stack.copy_(new_stack)
        graph.replay()
        torch.cuda.synchronize(device)
        same(C, cuda_counts.counts_from_r_multi_ref(r_b3, *big[1:]), True)
        same(Cs, cuda_counts.counts_from_r_multi_ref(r_stack, *stack[1:]), True)
        same(Cf, cuda_flat.counts_from_r_ref(r_flat, flat["qidx"], flat["map5"], **fkw), True)
    return {"max_abs_err": worst[0], "profiled_kernels": names}


# Graphed EM against the eager loop: the same iterations, models within
# LOOP_V_ATOL (tests/torch_outputs.py's PROB_TOL): B1's float64 atomics add
# in an order that varies from run to run, so two eager runs differ alike.
LOOP_V_ATOL = 1e-4
LOOP_ITERS, LOOP_SWEEPS = 40, 12


def loop_inputs(N, L, W, K, M, seed=0, device="cpu") -> tuple:
    """``planted_set``'s sequences with M seeds (the planted PWM, then
    softer ones): (data of ``refinement.em.prepare_data``, v [M, ...],
    alphas [M, K+1, W], f_bg [A])."""
    from bammmotif2_tpu_torch.refinement.em import prepare_data

    rng = np.random.default_rng(seed)
    sset, planted = planted_set(N, L, W, 4, False, rng)
    bg = BackgroundModel.from_sequence_set(sset, order=min(2, K))
    motifs = []
    soft = 0.1 if M <= 4 else 0.6 / M  # the planted base's weight stays above the others'
    for m in range(M):
        pwm = np.full((W, 4), (0.3 + soft * m) / 3)
        pwm[np.arange(W), planted] = 0.7 - soft * m
        motifs.append(seeds_mod.motif_from_pwm(pwm, K, sset.base_frequencies()))
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)  # noqa: E731
    v = tuple(f32(np.stack([mo.v[k] for mo in motifs])) for k in range(K + 1))
    return (prepare_data(sset, bg, K, False, device), v,
            f32(np.stack([mo.alphas for mo in motifs])), f32(motifs[0].f_bg))


def check_condition(device) -> dict:
    """The EM loop's stop-test kernel (``cuda_while.condition``) against its
    plain version (``condition_ref``, ``multi._running``) on edge inputs at
    M = 1, 2, 16, 33 and 300 (more seeds than the block's threads): the
    test holding, the cap reached, every seed frozen, v_diff equal to
    epsilon, a NaN v_diff, a NaN epsilon, infinities.  Equal booleans, one
    launch a call.  Returns {"cases", "mismatches", "launches"}."""
    rng = np.random.default_rng(0)
    nan, inf = float("nan"), float("inf")
    cases = []
    for M in (1, 2, 16, 33, 300):
        its = rng.integers(0, 50, M)
        vds = rng.uniform(0.01, 1.0, M)
        cap, eps = 60, 1e-3
        at_cap = its.copy()
        at_cap[M // 2] = cap
        edge = vds * 1e-3  # max(vds) == eps: the test holds
        edge[M - 1] = eps
        one_nan = vds.copy()
        one_nan[M // 2] = nan
        mixed = np.full(M, 1e-4)
        mixed[0] = inf
        cases += [(its, vds, cap, eps), (at_cap, vds, cap, eps), (its, vds * 1e-3, cap, eps),
                  (its, np.minimum(vds, eps), cap, eps), (its, edge, cap, eps),
                  (its, one_nan, cap, eps), (its, vds, cap, nan), (its, mixed, cap, eps),
                  (its, np.full(M, -inf), cap, -inf), (its, vds, 0, eps),
                  (its, np.full(M, inf), cap, eps)]
    bad, before = 0, cuda_while.condition.launches
    for its, vds, cap, eps in cases:
        t = (torch.as_tensor(its, dtype=torch.int32, device=device),
             torch.as_tensor(vds, dtype=torch.float32, device=device),
             torch.tensor(cap, dtype=torch.int32, device=device),
             torch.tensor(eps, dtype=torch.float32, device=device))
        running = torch.tensor(not bool(cuda_while.condition_ref(*t)), device=device)
        cuda_while.condition(*t, running)
        bad += int(bool(running) != bool(cuda_while.condition_ref(*t)))
    torch.cuda.synchronize(device)
    out = {"cases": len(cases), "mismatches": bad,
           "launches": cuda_while.condition.launches - before}
    assert bad == 0 and out["launches"] == len(cases), out
    return out


def check_loops(device) -> dict:
    """The device-resident loops (refinement/graphs.py) on the card, at
    bench's geometry (10k x 200 bp, W=12, K=2) with M=2:

    - CGS, graphed against eager, on the kernel and plain paths, for a
      first capture, for a cached loop graph launched with other chains,
      and at 1 and 2 sweeps (burn-in at n - 1; at 1 the loop graph runs
      its body zero times): the same results bit for bit; the graphed run
      one launch of its WHILE-node graph with no host read; B2 and B3
      (kernel path) and the two draw kernels (both paths) launched once a
      sweep by the counters (``graphs.settle``);
    - EM at a fixed budget (epsilon 0), graphed against eager on both
      paths: the same iterations, models within LOOP_V_ATOL; B1 launched
      once an iteration (``graphs.settle``); the graphed loop, one launch
      of its WHILE-node graph, makes no host read, and the eager loop one
      a chunk of multi.SYNC_EVERY iterations (counted under
      torch.cuda.set_sync_debug_mode("warn")), at SYNC_EVERY 8 and 4;
    - EM graphed against eager on the kernel path: converged (epsilon
      1e-3, four seeds freezing at different iterations on 2,000 rows);
      stopped by its warm-up iteration (a fresh capture at a cap of 1, and
      with every seed frozen by it), whose loop graph runs its body zero
      times; a cached graph launched with another cap, another start and
      another ll0 (a --checkpointEvery chunk): the same iterations, models
      within LOOP_V_ATOL, B1 and the stop-test kernel counted once an
      iteration, no host read;
    - a body that synchronises inside the capture raises CaptureError
      naming its line, after one eager iteration and no more;
    - at a chunked seed stack (CHUNKED_LOOP: 33 seeds, K=0, which the E+M
      and window-score plans split into balanced chunks of several seeds a
      block), EM and CGS graphed against eager on the kernel path, as
      above, each wrapper counted by its launches a call.
    - under an active trace, the cache's counters and capture spans
      (``check_loop_trace``).

    Raises AssertionError on a mismatch; returns what it measured."""
    from bammmotif2_tpu_torch.refinement import gibbs, graphs

    data, v0, alphas, f_bg = loop_inputs(10_000, 200, 12, 2, 2, device=device)
    M = alphas.shape[0]
    q0 = torch.full((M,), 0.9, device=device)
    out: dict = {"cgs": {}, "em": {}}

    def cgs(path, seed, use, n_iters, burn_in):
        res, reads, n = cgs_loop(data, alphas, f_bg, v0, q0, path, use, seed, n_iters, burn_in)
        return [*res[0], *res[1:5], *res[5]], reads, n

    def while_launches():  # summed over the cached CGS loops of every shape
        return sum(c.get("while_launches", 0) for c in graphs.stats()
                   if c["name"] == "CGS sweep loop")

    for path in ("cuda", "plain"):
        # seed 1: the cached loop graph, other chains; 1 and 2 sweeps: new keys
        for seed, n_iters, burn_in in ((0, LOOP_SWEEPS, 3), (1, LOOP_SWEEPS, 3), (2, 1, 0),
                                       (3, 2, 1)):
            e, _, _ = cgs(path, seed, False, n_iters, burn_in)
            before = while_launches()
            g, reads, n = cgs(path, seed, True, n_iters, burn_in)
            loops = while_launches() - before
            same = all(torch.equal(a, b) for a, b in zip(e, g))
            out["cgs"][f"{path}_{seed}_n{n_iters}"] = {"bit_equal": same, "launches": n,
                                                       "host_reads": reads, "loop_graphs": loops}
            assert same, (path, seed, n_iters)
            want = n_iters if path == "cuda" else 0
            assert n == {"b2": want, "b3": want, "cgs_z": n_iters, "cgs_beta": n_iters}, n
            assert reads == 0 and loops == 1, (reads, loops)
    out["cgs_bodies"] = loop_bodies()

    eps = torch.zeros((), device=device)

    for path in ("cuda", "plain"):
        for sync in (8, 4, 4):  # the second at 4: a cached graph
            (ve, _q, _l, _d, its_e, _h), reads_e, _n = em_loop(data, alphas, f_bg, v0, q0, eps,
                                                               LOOP_ITERS, path, False, sync)
            (vg, _q, _l, _d, its_g, _h), reads_g, n = em_loop(data, alphas, f_bg, v0, q0, eps,
                                                              LOOP_ITERS, path, True, sync)
            dv = max((a - b).abs().max().item() for a, b in zip(ve, vg))
            want = -(-LOOP_ITERS // sync) - 1
            out["em"][f"{path}_sync{sync}"] = {"its": its_g.tolist(), "max_abs_dv": dv,
                                               "host_reads": [reads_e, reads_g], "launches": n}
            assert its_e.tolist() == its_g.tolist() == [LOOP_ITERS] * M
            assert dv <= LOOP_V_ATOL, dv
            assert reads_e == want and reads_g == 0, (reads_e, reads_g, want)
            assert n["b1"] == (LOOP_ITERS if path == "cuda" else 0), n
            assert n["condition"] == LOOP_ITERS, n
    out["em_bodies"] = loop_bodies()
    out["em_device_loop"] = check_device_loop_cases(device)

    state = {"q": torch.zeros(2, device=device)}

    def syncing_body(s):
        s["q"].add_(1)
        if s["q"].sum().item() < 0:  # a host read: illegal under capture
            s["q"].zero_()

    loop = graphs.Loop("sync test loop", ("sync test",), state, {}, syncing_body)
    try:
        loop.run(3)
    except graphs.CaptureError as err:
        message = str(err)
    else:
        raise AssertionError("a body that syncs inside the capture did not raise")
    assert "sync test loop" in message and "s[\"q\"].sum().item()" in message, message
    assert state["q"].tolist() == [1.0, 1.0], state["q"]  # the warm-up, nothing after
    assert all(e["name"] != "sync test loop" for e in graphs.stats())
    out["capture_error"] = message.splitlines()[0]
    out["chunked"] = check_chunked_loops(device)
    out["trace"] = check_loop_trace(device)
    return out


def loop_bodies() -> list:
    """The node types of the cached device loops' captured bodies, each of
    which holds no node that runs device work ``graphs.body_ops`` does not
    count (a child graph or a conditional node), so that ``graph.loop_ops``
    counts every operation run inside the WHILE nodes."""
    from bammmotif2_tpu_torch.refinement import graphs

    bodies = [c["body_nodes"] for c in graphs.stats() if "body_nodes" in c]
    assert bodies and not any({"graph", "conditional"} & set(b) for b in bodies), bodies
    return bodies


def cgs_loop(data, alphas, f_bg, v0, q0, path, use, seed, n_iters, burn_in, K=2, W=12):
    """One ``gibbs.gibbs_optimize`` run of the chains keyed ``input_keys(
    seed, 0..M-1)`` on ``data``, graphed (``use``) or eager; settles the
    counters after it.  Returns (its results, host reads inside the call
    under torch.cuda.set_sync_debug_mode("warn"), {"b2", "b3", "cgs_z",
    "cgs_beta": each wrapper's launches})."""
    import warnings

    from bammmotif2_tpu_torch.ops import cuda_draws
    from bammmotif2_tpu_torch.refinement import gibbs, graphs

    device = q0.device
    M, N = q0.shape[0], data["lens"].shape[0]
    keys = gibbs.input_keys(seed, range(M), device)
    fns = {"b2": cuda_scores.window_scores_multi, "b3": cuda_counts.counts_from_r_multi,
           "cgs_z": cuda_draws.cgs_z, "cgs_beta": cuda_draws.cgs_beta}
    before = {k: fn.launches for k, fn in fns.items()}
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = gibbs.gibbs_optimize(v0, q0, torch.log(alphas), keys, data, f_bg, alphas,
                                       float(N), A=4, K=K, W=W, sample_z=True, sample_q=True,
                                       learn_alpha=True, path=path, n_iters=n_iters,
                                       burn_in=burn_in, graphs=use)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reads = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.synchronize(device)
    graphs.settle()
    return res, reads, {k: fn.launches - before[k] for k, fn in fns.items()}


def em_loop(data, alphas, f_bg, v0, q0, eps, cap, path, use, sync=None, ll0=None, K=2, W=12):
    """One ``multi.batched_while_loop`` of ``group_step`` on ``data`` (at
    SYNC_EVERY ``sync``, where given), graphed (``use``) or eager; settles the counters
    after it.  Returns (its results, host reads inside the loop call
    under torch.cuda.set_sync_debug_mode("warn"), {"b1": B1's launches,
    "condition": the stop-test kernel's launches, or its plain version's
    iterations where the loop ran eagerly})."""
    import warnings

    from bammmotif2_tpu_torch.refinement import graphs, multi

    step, inputs, key = multi.group_step(data, alphas, f_bg, int(data["lens"].shape[0]), A=4,
                                         K=K, W=W, optimize_q=True, path=path)
    device = q0.device
    saved = multi.SYNC_EVERY
    multi.SYNC_EVERY = sync or saved
    before = (cuda_em.em_counts_multi.launches, cuda_while.condition.launches)
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = multi.batched_while_loop(step, v0, q0, eps, cap, inputs=inputs, key=key,
                                           ll0=ll0, graphs=use)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        multi.SYNC_EVERY = saved
    reads = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.synchronize(device)
    graphs.settle()
    n = {"b1": cuda_em.em_counts_multi.launches - before[0],
         "condition": cuda_while.condition.launches - before[1] if use
         else int(res[4].max())}
    return res, reads, n


def check_device_loop_cases(device) -> dict:
    """check_loops' converged, warm-up-stopped and cached-graph EM cases on
    the kernel path (see there)."""
    from bammmotif2_tpu_torch.refinement import graphs

    data, v0, alphas, f_bg = loop_inputs(2_000, 200, 12, 2, 4, seed=1, device=device)
    M = alphas.shape[0]
    q0 = torch.full((M,), 0.9, device=device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    out = {}

    def pair(name, eps, cap, v=v0, ll0=None, fresh=False, cached=False):
        e, reads_e, _ = em_loop(data, alphas, f_bg, v, q0, eps, cap, "cuda", False, ll0=ll0)
        if fresh:
            graphs.clear()
        calls = {c["name"]: c for c in graphs.stats()}.get("EM loop", {}).get("calls", 0)
        g, reads_g, n = em_loop(data, alphas, f_bg, v, q0, eps, cap, "cuda", True, ll0=ll0)
        st = {c["name"]: c for c in graphs.stats()}["EM loop"]
        its_e, its_g = e[4].tolist(), g[4].tolist()
        dv = max((a - b).abs().max().item() for a, b in zip(e[0], g[0]))
        out[name] = {"its": its_g, "max_abs_dv": dv, "host_reads": [reads_e, reads_g],
                     "launches": n, "loop_graph": st}
        assert its_e == its_g, (name, its_e, its_g)
        assert dv <= LOOP_V_ATOL, (name, dv)
        assert reads_g == 0, (name, reads_g)
        assert n["b1"] == n["condition"] == max(its_g), (name, n, its_g)
        assert (st["calls"] == calls + 1) if cached else (st["calls"] == 1 and calls == 0), \
            (name, st, calls)
        return g

    g = pair("converged", f32(1e-3), 500, fresh=True)
    its = g[4].tolist()
    assert max(its) < 500 and len(set(its)) > 1, its
    pair("warm_up_cap_1", f32(0.0), 1, fresh=True)
    pair("warm_up_all_frozen", f32(1e9), 50, fresh=True)
    first = pair("cap_5", f32(0.0), 5, fresh=True)
    # a --checkpointEvery chunk: the cached graph, another cap, start and ll0
    pair("cached_cap_7_ll0", f32(0.0), 7, v=first[0], ll0=first[2], cached=True)
    pair("cached_converged", f32(1e-3), 500, v=first[0], ll0=first[2], cached=True)
    return out


def check_loop_trace(device) -> dict:
    """The loop cache under an active trace (``utils.metrics``), at a cache
    of one loop: a first EM loop captures (one ``graph.capture`` count and
    span, attr ``loop``, whose seconds are its ``capture_ms``), a second of
    its key is a ``graph.hit``, and a loop of another key (the plain path)
    captures and drops the first (``graph.evict``); no other span.  The
    loop graphs' iterations times their bodies' ``graphs.body_ops`` are
    ``graph.loop_ops``, and the kernel path's two loops each count one
    ``em.update_fused``."""
    from bammmotif2_tpu_torch.refinement import graphs
    from bammmotif2_tpu_torch.utils import metrics

    data, v0, alphas, f_bg = loop_inputs(2_000, 200, 12, 2, 2, seed=2, device=device)
    q0 = torch.full((alphas.shape[0],), 0.9, device=device)
    eps = torch.zeros((), device=device)
    size = graphs.CACHE_SIZE
    graphs.clear()
    graphs.CACHE_SIZE = 1
    try:
        with metrics.tracing() as trace:
            em_loop(data, alphas, f_bg, v0, q0, eps, 3, "cuda", True)
            (first,) = graphs.stats()
            em_loop(data, alphas, f_bg, v0, q0, eps, 5, "cuda", True)
            em_loop(data, alphas, f_bg, v0, q0, eps, 3, "plain", True)
            (last,) = graphs.stats()
    finally:
        graphs.CACHE_SIZE = size
        graphs.clear()
    spans = trace.export()["spans"]
    out = {"counts": trace.counts, "capture_ms": first["capture_ms"],
           "spans": [(s["name"], s["attrs"]) for s in spans]}
    # the loop graphs' iterations: 2 and 5 of the first key (its capture's
    # warm-up iteration runs eagerly), 2 of the second
    loop_ops = (7 * graphs.body_ops(first["body_nodes"])
                + 2 * graphs.body_ops(last["body_nodes"]))
    assert trace.counts == {"graph.capture": 2, "graph.hit": 1, "graph.evict": 1,
                            "graph.loop_ops": loop_ops, "em.update_fused": 2}, out
    assert [(s["name"], s["attrs"], s["parent"]) for s in spans] == \
        [("graph.capture", {"loop": "EM loop"}, None)] * 2, out
    span_ms = (spans[0]["end_ns"] - spans[0]["start_ns"]) / 1e6
    assert abs(first["capture_ms"] - span_ms) <= 1e-9 * span_ms, out
    return out


CHUNKED_LOOP = dict(N=2_000, L=200, W=12, K=0, M=33)


def launches_a_call(fn, wrapper) -> int:
    """How many launches ``wrapper.launches`` counts for one call of fn."""
    before = wrapper.launches
    fn()
    torch.cuda.synchronize()
    return wrapper.launches - before


def check_chunked_loops(device) -> dict:
    """check_loops' EM and CGS comparisons at CHUNKED_LOOP's seed stack, on
    the kernel path: graphed equals eager (CGS bit for bit, EM within
    LOOP_V_ATOL at LOOP_ITERS iterations), and the counters add each
    wrapper's launches a call once an iteration or sweep."""
    from bammmotif2_tpu_torch.refinement import gibbs

    c = CHUNKED_LOOP
    data, v0, alphas, f_bg = loop_inputs(c["N"], c["L"], c["W"], c["K"], c["M"], device=device)
    M, K, W, N = c["M"], c["K"], c["W"], c["N"]
    q0 = torch.full((M,), 0.9, device=device)
    s_flat = torch.zeros((M, encode.num_rows(4, K) + 1, W), device=device)
    per_call = {
        "b1": launches_a_call(lambda: cuda_em.em_counts_multi(
            s_flat, data["cidx"], data["lens"], q0), cuda_em.em_counts_multi),
        "b2": launches_a_call(lambda: cuda_scores.window_scores_multi(
            s_flat, data["cidx"], data["lens"]), cuda_scores.window_scores_multi),
        "b3": launches_a_call(lambda: cuda_counts.counts_from_r_multi(
            torch.zeros((M, *data["cidx"].shape), device=device), data["cidx"],
            s_flat.shape[1] - 1, W), cuda_counts.counts_from_r_multi)}
    out = {"launches_a_call": per_call}

    def cgs(use):
        res, _reads, n = cgs_loop(data, alphas, f_bg, v0, q0, "cuda", use, 0, LOOP_SWEEPS, 3,
                                  K=K, W=W)
        return [*res[0], *res[1:5], *res[5]], n

    e, _ = cgs(False)
    g, n = cgs(True)
    out["cgs_bit_equal"] = all(torch.equal(a, b) for a, b in zip(e, g))
    assert out["cgs_bit_equal"]
    assert (n["b2"], n["b3"]) == (LOOP_SWEEPS * per_call["b2"], LOOP_SWEEPS * per_call["b3"]), \
        (n, per_call)

    eps = torch.zeros((), device=device)
    (ve, *_r, its_e, _h), _, _ = em_loop(data, alphas, f_bg, v0, q0, eps, LOOP_ITERS, "cuda",
                                         False, K=K, W=W)
    (vg, *_r, its_g, _h), reads, n = em_loop(data, alphas, f_bg, v0, q0, eps, LOOP_ITERS, "cuda",
                                             True, K=K, W=W)
    dv = max((a - b).abs().max().item() for a, b in zip(ve, vg))
    out["em"] = {"max_abs_dv": dv, "launches": n, "host_reads": reads}
    assert its_e.tolist() == its_g.tolist() == [LOOP_ITERS] * M
    assert dv <= LOOP_V_ATOL, dv
    assert reads == 0, reads
    assert n["b1"] == LOOP_ITERS * per_call["b1"] and n["condition"] == LOOP_ITERS, (n, per_call)
    return out


# name -> the fused update's case (``check_update``): loop_inputs' geometry,
# the seeds frozen at the iteration's start, the rows of length 0 (a fold's
# held-out rows), --optimizeQ, the ll history's stride.  K=4 at W=30 and
# K=4 at W=12 keep their count tables in device memory, the rest in shared
# memory; K=4 at W=30 is also the float-count plan of the pass (a launch a
# seed).  ``q_exact``: PyTorch gives each output of q's column sum one thread
# there, whose order the kernel takes (c4.em's groups), so q is bit-equal.
UPDATE_CASES = {
    "c4_K2_W12_M4": dict(N=2_000, W=12, K=2, M=4, frozen=(1,), pad=0, optimize_q=True,
                         hist_stride=1, q_exact=True),
    "K0_W1_M1": dict(N=500, W=1, K=0, M=1, frozen=(), pad=0, optimize_q=True, hist_stride=1),
    "K1_W8_M16_pad": dict(N=1_000, W=8, K=1, M=16, frozen=(0, 5, 15), pad=200,
                          optimize_q=True, hist_stride=3),
    "K2_W30_M4_no_q": dict(N=1_000, W=30, K=2, M=4, frozen=(3,), pad=0, optimize_q=False,
                           hist_stride=2),
    "K3_W12_M16_pad_no_q": dict(N=1_000, W=12, K=3, M=16, frozen=(2, 3), pad=100,
                                optimize_q=False, hist_stride=1),
    "K4_W12_M4_device_table": dict(N=1_000, W=12, K=4, M=4, frozen=(0,), pad=50,
                                   optimize_q=True, hist_stride=4),
    "K4_W30_M4_float_counts": dict(N=1_000, W=30, K=4, M=4, frozen=(2,), pad=0,
                                   optimize_q=True, hist_stride=1),
}
# float32 spacings the fused update's v and LUT may lie from the PyTorch
# chain's (its sums of four may associate otherwise: PyTorch sums the four
# rows of a column pairwise where W=1), and the relative error of its
# sums: q's column (PyTorch splits it over threads at larger shapes) and
# v_diff (summed in double)
UPDATE_ULPS, UPDATE_SUM_RTOL = 2, 1e-6


def ulps_off(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor | None = None) -> float:
    """The largest |a - b| in float32 spacings of |b|, or of the larger of
    |b| and ``scale`` (0 where equal; inf where one is NaN)."""
    ref = b.abs() if scale is None else torch.maximum(b.abs(), scale)
    spacing = torch.nextafter(ref, torch.tensor(float("inf"), device=b.device)) - ref
    gap = (a - b).abs()
    err = torch.where(a == b, torch.zeros_like(gap), gap / spacing)
    return float(torch.nan_to_num(err, nan=float("inf")).max())


def check_update(case: dict, device) -> dict:
    """The fused update (``cuda_update.em_update``) against the PyTorch
    chain it replaces (``multi.update``, then ``multi.advance`` and the next
    iteration's ``log_odds_lut``), fed the same B1 pass (``cuda_em.em_pass``:
    Cd and logz) and the same loop state: some seeds frozen, lls of -inf
    (a first iteration) and of a likelihood, iteration counts past the ll
    history's end, rows of length 0.  C, ll (ll_reduce_kernel's sum of the
    same logz, through ``em_counts_multi``), the ll history and the
    iteration counts bit-equal (q too where ``q_exact``); v and the LUT
    within UPDATE_ULPS (the LUT's log(v) - log(bg) in spacings of log(v)
    where that is larger); q within UPDATE_SUM_RTOL, v_diff within it plus
    the UPDATE_ULPS of v that each of its terms |v' - v| may take (a sum
    of four that associates otherwise, as at W=1, moves v by a spacing,
    which its small differences magnify); the frozen seeds' state
    untouched; Cd left zero.  Then the same call with the loop stopped
    changes nothing but Cd.  Raises AssertionError on a mismatch; returns
    the errors."""
    from bammmotif2_tpu_torch.ops import cuda_update
    from bammmotif2_tpu_torch.refinement import multi

    N, W, K, M = case["N"], case["W"], case["K"], case["M"]
    data, v, alphas, f_bg = loop_inputs(N, 200, W, K, M, seed=K + W, device=device)
    n_real = N - case["pad"]
    lens = data["lens"].clone()
    lens[n_real:] = 0
    R = encode.num_rows(4, K)
    g = torch.Generator(device=device).manual_seed(M)
    q = 0.3 + 0.6 * torch.rand(M, generator=g, device=device)
    s_flat = log_odds_lut(v, data["bg_flat"]).contiguous()
    Cd = torch.zeros((M, R + 1, W), dtype=torch.float64, device=device)
    logz = torch.empty((M, N), device=device)
    cuda_em.em_pass(s_flat, data["cidx"], lens, q, Cd, logz)
    _C, ll = cuda_em.em_counts_multi(s_flat, data["cidx"], lens, q)
    C_ref = Cd.float()

    slots, stride = 5, case["hist_stride"]
    frozen = torch.zeros(M, dtype=torch.bool, device=device)
    frozen[list(case["frozen"])] = True
    eps = torch.tensor(1e-3, device=device)
    state = {
        "q": q.clone(),
        "lls": torch.where(torch.arange(M, device=device) % 2 == 0, float("-inf"), ll - 0.5),
        "vds": torch.where(frozen, 1e-4, 0.5 + torch.rand(M, generator=g, device=device)),
        "its": torch.randint(0, 3 * slots * stride, (M,), generator=g, device=device,
                             dtype=torch.int32),
        "hist": torch.randn((slots, M), generator=g, device=device),
        "running": torch.tensor(True, device=device), "eps": eps,
    }
    ref = {**{k: t.clone() for k, t in state.items()}, "v": tuple(vk.clone() for vk in v)}
    upd = multi.update(C_ref, ll, ref["v"], ref["q"], alphas, f_bg, n_real, N, A=4, K=K,
                       optimize_q=case["optimize_q"])
    multi.advance(ref, *upd, slots, stride)
    ref_lut = log_odds_lut(ref["v"], data["bg_flat"])

    got = {**{k: t.clone() for k, t in state.items()}, "v": torch.cat(v, dim=1),
           "s_flat": s_flat.clone()}
    C = torch.full_like(C_ref, float("nan"))
    args = lambda s: (Cd, logz, s["v"], s["s_flat"], s["q"], s["lls"], s["vds"],  # noqa: E731
                      s["its"], s["hist"], s["running"], s["eps"], alphas, f_bg,
                      data["bg_flat"])
    kw = dict(n_real=n_real, optimize_q=case["optimize_q"], hist_slots=slots,
              hist_stride=stride)
    launches = cuda_update.em_update.launches
    cuda_update.em_update(*args(got), C=C, **kw)
    torch.cuda.synchronize(device)
    off = encode.order_offsets(4, K)
    v_got = tuple(got["v"][:, off[k]:off[k + 1]] for k in range(K + 1))
    out = {
        "C_bit_equal": torch.equal(C, C_ref),
        "Cd_zero": not bool(Cd.any()),
        "ll_bit_equal": torch.equal(got["lls"], ref["lls"]),
        "its_equal": torch.equal(got["its"], ref["its"]),
        "hist_bit_equal": torch.equal(got["hist"], ref["hist"]),
        "v_ulps": max(ulps_off(a, b) for a, b in zip(v_got, ref["v"])),
        # in spacings of the difference's larger term, log(v), as well
        "lut_ulps": ulps_off(got["s_flat"], ref_lut, log_odds_lut(ref["v"], torch.ones_like(
            data["bg_flat"])).abs()),
        "q_rel": float(((got["q"] - ref["q"]).abs() / ref["q"]).max()),
        "q_bit_equal": torch.equal(got["q"], ref["q"]),
        "vd_rel": float(((got["vds"] - ref["vds"]).abs() / ref["vds"].abs()).max()),
        "vd_over_bound": float(((got["vds"] - ref["vds"]).abs() / (
            UPDATE_SUM_RTOL * ref["vds"].abs() + UPDATE_ULPS * sum(
                (torch.nextafter(vk.abs(), torch.tensor(float("inf"), device=device))
                 - vk.abs()).sum(dim=(1, 2)) for vk in ref["v"]))).max()),
        "frozen_untouched": all(
            torch.equal(got[k][frozen], state[k][frozen]) for k in ("q", "lls", "vds", "its"))
        and torch.equal(got["s_flat"][frozen], s_flat[frozen]),
        "launches": cuda_update.em_update.launches - launches,
    }
    assert out["C_bit_equal"] and out["Cd_zero"] and out["ll_bit_equal"], out
    assert out["its_equal"] and out["hist_bit_equal"] and out["frozen_untouched"], out
    assert out["v_ulps"] <= UPDATE_ULPS and out["lut_ulps"] <= UPDATE_ULPS, out
    assert out["q_rel"] <= UPDATE_SUM_RTOL and out["vd_over_bound"] <= 1, out
    assert out["q_bit_equal"] or not case.get("q_exact"), out
    assert out["launches"] == 1, out

    # the loop stopped: only Cd changes (back to zero)
    stopped = {k: (t.clone() if isinstance(t, torch.Tensor) else t) for k, t in got.items()}
    stopped["running"] = torch.tensor(False, device=device)
    Cd.copy_(C_ref.double())
    cuda_update.em_update(*args(stopped), **kw)
    torch.cuda.synchronize(device)
    out["stopped_unchanged"] = all(torch.equal(stopped[k], got[k]) for k in
                                   ("v", "s_flat", "q", "lls", "vds", "its", "hist"))
    assert out["stopped_unchanged"] and not bool(Cd.any()), out
    return out


def c4_group_motifs(sset, planted, K: int = 2) -> list:
    """c4.em's (W, K) groups on a set with a 12-wide planted motif: four
    seeds of W=8, three of W=10 and three of W=12 (the planted PWM's prefix,
    each copy softer), at order K."""
    motifs = []
    for W, n in ((8, 4), (10, 3), (12, 3)):
        for m in range(n):
            pwm = np.full((W, 4), (0.3 + 0.1 * m) / 3)
            pwm[np.arange(W), planted[:W]] = 0.7 - 0.1 * m
            motifs.append(seeds_mod.motif_from_pwm(pwm, K, sset.base_frequencies()))
    return motifs


def check_em_multi_fused(device) -> dict:
    """One traced ``run_em_multi`` of c4.em's groups (``c4_group_motifs``,
    4 + 3 + 3 seeds at K=2) on 2,000 planted rows, --optimizeQ at a fixed
    budget of 30 iterations (epsilon 0), with the fused update against the
    same run with the PyTorch update (``group_step``'s ``fused`` taken
    away): every seed's conditionals within the benchmark's model_dp (1e-3),
    ll within its ll_rel (2e-4) and q within its q_abs (1e-4), the same
    iterations.  The fused run's captured EM bodies hold at most 4 device
    operations (``graphs.body_ops``: B1, the update, the stop test) and only
    kernel, memcpy or memset nodes; its trace counts ``em.update_fused``
    once a group and ``graph.loop_ops`` as its loop graphs' iterations times
    their bodies' operations; the PyTorch run counts no ``em.update_fused``.
    Raises AssertionError on a mismatch; returns what it measured."""
    from bammmotif2_tpu_torch.refinement import graphs, multi
    from bammmotif2_tpu_torch.utils import metrics
    from bammmotif2_tpu_torch.utils.config import Params

    rng = np.random.default_rng(24)
    sset, planted = planted_set(2_000, 200, 12, 4, False, rng)
    bg = BackgroundModel.from_sequence_set(sset, order=2)
    params = Params(EM=True, optimizeQ=True, maxEMIterations=30, epsilon=0.0)
    group_step = multi.group_step

    def torch_update(*args, **kw):
        step, inputs, key = group_step(*args, **kw)
        step.fused = None
        return step, inputs, key

    runs = {}
    for name in ("fused", "torch"):
        motifs = c4_group_motifs(sset, planted)
        graphs.clear()
        multi.group_step = group_step if name == "fused" else torch_update
        try:
            with metrics.tracing() as trace:
                res = multi.run_em_multi(motifs, bg, sset, params, device=device)
        finally:
            multi.group_step = group_step
        bodies = [c["body_nodes"] for c in graphs.stats() if c["name"] == "EM loop"]
        runs[name] = (motifs, res, dict(trace.counts), bodies)
    (mf, rf, cf, bf), (mt, rt, ct, _bt) = runs["fused"], runs["torch"]
    out = {
        "model_dp": max(float(np.abs(a - b).max()) for x, y in zip(mf, mt)
                        for a, b in zip(x.v, y.v)),
        "ll_rel": max(abs(x.ll - y.ll) / abs(y.ll) for x, y in zip(rf, rt)),
        "q_abs": max(abs(x.q - y.q) for x, y in zip(rf, rt)),
        "iterations": [x.iterations for x in rf], "body_nodes": bf,
        "body_ops": [graphs.body_ops(b) for b in bf], "counts": cf, "torch_counts": ct,
    }
    assert out["model_dp"] <= 1e-3 and out["ll_rel"] <= 2e-4 and out["q_abs"] <= 1e-4, out
    assert out["iterations"] == [x.iterations for x in rt] == [30] * 10, out
    assert len(bf) == 3 and all(n <= 4 for n in out["body_ops"]), out
    assert all(set(b) <= {"kernel", "memcpy", "memset"} for b in bf), out
    assert cf.get("em.update_fused") == 3 and "em.update_fused" not in ct, out
    # each group's loop graph runs 29 iterations (its first is the capture's)
    assert cf["graph.loop_ops"] == 29 * sum(out["body_ops"]), out
    assert cf["em.seed_passes"] == 300 and cf["em.seed_passes_skipped"] == 0, out
    assert ct["em.seed_passes"] == 300 and ct["em.seed_passes_skipped"] == 0, out
    out["stopping"] = check_em_multi_fused_stopping(device, sset, planted, bg, torch_update)
    return out


def check_em_multi_fused_stopping(device, sset, planted, bg, torch_update) -> dict:
    """``check_em_multi_fused``'s groups at the benchmark's epsilon (1e-3),
    so their seeds stop at different iterations and the fused loop's B1
    pass serves fewer seeds as they freeze: each seed's model, ll and q
    within the benchmark's limits of the PyTorch update's run of that seed
    alone to the same iterations (``torch_update``, epsilon 0), at most 4
    device operations a loop body, and the counters at the passes run and
    skipped (M * max(its) - sum(its) a group, more than none)."""
    from bammmotif2_tpu_torch.refinement import graphs, multi
    from bammmotif2_tpu_torch.utils import metrics
    from bammmotif2_tpu_torch.utils.config import Params

    motifs = c4_group_motifs(sset, planted)
    graphs.clear()
    with metrics.tracing() as trace:
        res = multi.run_em_multi(motifs, bg, sset, Params(
            EM=True, optimizeQ=True, maxEMIterations=1000, epsilon=1e-3), device=device)
    bodies = [c["body_nodes"] for c in graphs.stats() if c["name"] == "EM loop"]
    its = [r.iterations for r in res]
    groups = (its[:4], its[4:7], its[7:])
    out = {"iterations": its, "body_ops": [graphs.body_ops(b) for b in bodies],
           "counts": {k: v for k, v in trace.counts.items() if k.startswith("em.")},
           "model_dp": 0.0, "ll_rel": 0.0, "q_abs": 0.0}
    group_step = multi.group_step
    for i, (m, r) in enumerate(zip(motifs, res)):
        alone = c4_group_motifs(sset, planted)[i]
        multi.group_step = torch_update
        try:
            (ra,) = multi.run_em_multi([alone], bg, sset, Params(
                EM=True, optimizeQ=True, maxEMIterations=r.iterations, epsilon=0.0),
                device=device)
        finally:
            multi.group_step = group_step
        assert ra.iterations == r.iterations, (i, ra.iterations, r.iterations)
        out["model_dp"] = max(out["model_dp"], max(float(np.abs(a - b).max())
                                                   for a, b in zip(m.v, alone.v)))
        out["ll_rel"] = max(out["ll_rel"], abs(r.ll - ra.ll) / abs(ra.ll))
        out["q_abs"] = max(out["q_abs"], abs(r.q - ra.q))
    skipped = sum(len(g) * max(g) - sum(g) for g in groups)
    assert out["model_dp"] <= 1e-3 and out["ll_rel"] <= 2e-4 and out["q_abs"] <= 1e-4, out
    assert len(bodies) == 3 and all(n <= 4 for n in out["body_ops"]), out
    assert out["counts"]["em.seed_passes"] == sum(its), out
    assert out["counts"]["em.seed_passes_skipped"] == skipped > 0, out
    return out


C4_SITES = ("TGACTCAG", "CACGTGACTT", "GGGGCGGGGCCA")


def c4_problem(outdir: str, N: int = 10_000, L: int = 200, seed: int = 4,
               site_strings: tuple = C4_SITES) -> tuple:
    """A planted N x L bp set as FASTA + seed MEME, shaped as BASELINE
    config 4: site i of the n ``site_strings`` in 80% of the rows i, i + n,
    ...; one base in a hundred N; ten soft seeds, the
    sites' and perturbed copies (with C4_SITES three (W, K) groups, of 4, 3
    and 3 at -k 2).  Returns (fasta, meme)."""
    import os

    from bammmotif2_tpu_torch.utils.fasta import write_fasta

    rng = np.random.default_rng(seed)
    alphabet = Alphabet.standard()
    codes = rng.integers(0, 4, (N, L)).astype(np.int8)
    sites = [alphabet.encode(s) for s in site_strings]
    for i, site in enumerate(sites):
        rows = np.arange(i, N, len(sites))
        rows = rows[rng.random(rows.size) < 0.8]
        pos = rng.integers(0, L - len(site), rows.size)
        codes[rows[:, None], pos[:, None] + np.arange(len(site))] = site
    codes[rng.random((N, L)) < 0.01] = -1
    sset = SequenceSet(codes, np.full(N, L, np.int32), [f"s{i}" for i in range(N)], alphabet)
    fasta = os.path.join(outdir, "c4.fasta")
    write_fasta(fasta, sset)
    meme = os.path.join(outdir, "c4.meme")
    with open(meme, "w") as fh:
        fh.write("MEME version 4\n\n")
        for s in range(10):
            site = sites[s % len(sites)]
            pwm = np.full((len(site), 4), 0.1)
            pwm[np.arange(len(site)), site] = 0.7
            if s >= len(sites):
                pwm = pwm * rng.uniform(0.8, 1.25, pwm.shape)
            pwm /= pwm.sum(axis=1, keepdims=True)
            fh.write(f"MOTIF seed{s + 1}\nletter-probability matrix: alength= 4 "
                     f"w= {len(pwm)} nsites= 100\n")
            fh.writelines(" ".join(f"{p:.6f}" for p in row) + "\n" for row in pwm)
            fh.write("\n")
    return fasta, meme


def check_background(device, tmp: str) -> dict:
    """The background fit on the card against the CPU, on c4_problem's set:
    the same integer counts and byte-equal .hbcp/.hbp files at orders 0, 2
    and 4, both strands and --ss; then a --EM job of c4_problem through
    the CLI on the card builds the k-mer index once (the background fit's)
    and its three (W, K) groups read it (``kmer_index.build`` 1,
    ``kmer_index.hit`` 3)."""
    import os
    import pathlib

    from bammmotif2_tpu_torch import cli
    from bammmotif2_tpu_torch.utils.fasta import read_fasta

    fasta, meme = c4_problem(tmp)
    sset = read_fasta(fasta, Alphabet.standard())
    out = {"cases": {}}
    for order, ss in ((0, False), (2, False), (2, True), (4, False)):
        C_card = BackgroundModel.kmer_counts(sset, order, ss, device)
        C_cpu = BackgroundModel.kmer_counts(sset, order, ss, "cpu")
        files = []
        for where in (device, "cpu"):
            bg = BackgroundModel.from_sequence_set(sset, order=order, ss=ss, device=where)
            paths = bg.write(os.path.join(tmp, f"bg_{order}_{ss}_{torch.device(where).type}"))
            files.append([pathlib.Path(p).read_bytes() for p in paths])
        case = {"counts_equal": bool(np.array_equal(C_card, C_cpu)),
                "files_equal": files[0] == files[1], "positions": int(C_cpu.sum())}
        out["cases"][f"K{order}{'_ss' if ss else ''}"] = case
        assert case["counts_equal"] and case["files_equal"], (order, ss, case)
        assert case["positions"] == (1 if ss else 2) * sset.n * sset.l_max
    params = cli.params_from_args([os.path.join(tmp, "em"), fasta, "--PWMFile", meme, "--EM",
                                   "--optimizeQ", "-k", "2", "-K", "2", "--maxEMIterations",
                                   "20", "--single-device"])
    res = cli.run_pipeline(params, device)
    counts = res["trace"]["counts"]
    out["job_counts"] = counts
    assert len(res["em_results"]) == 10
    assert (counts.get("kmer_index.build"), counts.get("kmer_index.hit")) == (1, 3), counts
    return out


# The records CUPTI keeps, a process, of the device operations run inside
# WHILE nodes: 8 MiB of 24-byte records.  A traced loop of ten torch kernels
# an iteration faulted between 341,031 and 352,032 such operations in its
# first traced window, and at 1.45 to 1.98 stores where a window holding
# such records had stopped first (CUPTI 12.8, CUDA 13.0, H100; PERF.md
# section 7 item 2).
CUPTI_LOOP_RECORDS = 8 * 2 ** 20 // 24
# the traced FDR checks' flags: small iteration caps keep a job's loop
# operations (``graph.loop_ops``) far under CUPTI_LOOP_RECORDS
TRACED_FDR_FLAGS = ["--maxPWM", "10", "-q", "0.5", "-k", "2", "-K", "2", "--cvFold", "5",
                    "--mFold", "10", "--maxEMIterations", "30", "--maxCGSIterations", "8"]
# case -> the FDR refinement ("cli": an --EM --FDR --profile job of the CLI)
TRACED_FDR_CASES = {"em_fdr": "EM", "unrefined_fdr": "none", "cgs_fdr": "CGS",
                    "cli_profile": "cli"}
TRACED_FDR_ARGS = {"EM": ["--FDR", "--optimizeQ"], "none": ["--FDR"], "CGS": ["--CGS", "--FDR"],
                   "cli": ["--EM", "--FDR", "--optimizeQ"]}


def run_worker(kind: str, case: str, tmp: str, timeout: int = 900) -> dict:
    """``python tests/test_torch_cuda.py KIND CASE TMP`` in a process of its
    own (CUPTI's store of loop records lasts a process, and a fault ends
    it): the JSON of its last line."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [
        root, os.environ.get("PYTHONPATH")]))}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), kind, case, tmp],
                          capture_output=True, text=True, timeout=timeout, cwd=root, env=env)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"{kind} {case} exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                             f"\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def fdr_results_equal(a: list, b: list) -> bool:
    """Two lists of FDRResults with the same iterations, p-values and sweeps."""
    return len(a) == len(b) and all(
        x.fold_iterations == y.fold_iterations and np.array_equal(x.pos_pvalues, y.pos_pvalues)
        and all(np.array_equal(x.zoops[k], y.zoops[k]) for k in x.zoops)
        and all(np.array_equal(x.mops[k], y.mops[k]) for k in x.mops)
        for x, y in zip(a, b))


def fold_loop_iterations(results: list, groups: list) -> int:
    """The fold loops' iterations of FDR results whose seeds fall into
    ``groups`` (lists of result indices): a group's loop iterates, each
    fold, as long as its longest-running seed."""
    return sum(max(results[i].fold_iterations[f] for i in g)
               for g in groups for f in range(len(results[g[0]].fold_iterations)))


def in_spans(times: list, spans: list) -> int:
    """How many of ``times`` lie in one of the (start, end) ``spans``."""
    return sum(any(a <= t <= b for a, b in spans) for t in times)


def fold_kernels(events: list, kernel: str) -> dict:
    """Where a Chrome trace's (``traceEvents``) runs of the ``__global__``
    function ``kernel`` lie against its ``bamm::fdr.folds`` annotations:
    running between one's start and the end of the group's
    ``bamm::fdr.fetch`` (``in_fold_stages``: the folds enqueue the device's
    work, which ends inside the fetch), and launched by a host call inside
    one (``launched_in_folds``: the call that the run's correlation id
    names; ``without_launch``: runs whose id names no traced call)."""
    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("name") == name and e.get("cat") == "user_annotation")

    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    runs = [e for e in events if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    launched = [calls.get(e.get("args", {}).get("correlation")) for e in runs]
    folds = spans("bamm::fdr.folds")
    stages = [(a, d) for (a, _b), (_c, d) in zip(folds, spans("bamm::fdr.fetch"))]
    return {"folds": len(folds), "runs": len(runs),
            "in_fold_stages": in_spans([e["ts"] for e in runs], stages),
            "launched_in_folds": in_spans([t for t in launched if t is not None], folds),
            "without_launch": sum(t is None for t in launched)}


def traced_fdr_worker(case: str, tmp: str) -> dict:
    """One traced FDR job against the same job untraced, on a 2,000 x 200 bp
    c4_problem of two (W, K) groups at TRACED_FDR_FLAGS, with a loop cache
    of two (one where nothing refines), so that each group's loops evict
    the other's.  The group
    program (``fdr.evaluate_motifs``) runs as the benchmark's traced run
    does: an untraced job, a first profiler window, ``graphs.clear()``, a
    job that captures, then the job under torch.profiler (CPU and CUDA);
    ``cli_profile`` runs ``--EM --FDR --profile DIR`` through the CLI in a
    fresh process, then the same job untraced."""
    import glob
    import json
    import os

    from bammmotif2_tpu_torch import cli
    from bammmotif2_tpu_torch.evaluation import fdr
    from bammmotif2_tpu_torch.models.motifset import load_motifs
    from bammmotif2_tpu_torch.refinement import graphs
    from bammmotif2_tpu_torch.utils import metrics
    from bammmotif2_tpu_torch.utils.fasta import read_fasta

    device = torch.device("cuda")
    refine = TRACED_FDR_CASES[case]
    fasta, meme = c4_problem(tmp, N=2_000, site_strings=C4_SITES[:2])
    argv = [fasta, "--PWMFile", meme, *TRACED_FDR_FLAGS, *TRACED_FDR_ARGS[refine]]
    params = cli.params_from_args([os.path.join(tmp, "out"), *argv])
    alphabet = Alphabet.from_type(params.alphabetType)
    pos = read_fasta(fasta, alphabet)
    seeds = load_motifs(params, pos.base_frequencies(), alphabet)
    graphs.CACHE_SIZE = 1 if refine == "none" else 2

    def read(paths):
        out = {}
        for p in paths:
            with open(p, "rb") as fh:
                out[os.path.basename(p)] = fh.read()
        return out

    prof_dir = os.path.join(tmp, "profile")
    if refine == "cli":
        runs = {}
        for tag, extra in (("traced", ["--profile", prof_dir]), ("untraced", [])):
            res = cli.run_pipeline(cli.params_from_args([os.path.join(tmp, tag), *argv, *extra]),
                                   device)
            torch.cuda.synchronize()
            runs[tag] = (res, read(res["files"]))
        got, ref = runs["traced"][0]["fdr_results"], runs["untraced"][0]["fdr_results"]
        files, ref_files = runs["traced"][1], runs["untraced"][1]
        counts = runs["traced"][0]["trace"]["counts"]
    else:
        bg = BackgroundModel.from_sequence_set(pos, order=params.bgModelOrder,
                                               alpha=params.bgModelAlpha, ss=params.ss)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

        def job(tag):
            with metrics.tracing() as trace:
                res = fdr.evaluate_motifs([m.copy() for m in seeds], bg, pos, params,
                                          refine=refine, device=device)
            torch.cuda.synchronize()
            paths = [p for m, r in zip(seeds, res) for p in r.write(os.path.join(tmp, tag),
                                                                    m.name)]
            return res, read(paths), trace.counts

        ref, ref_files, _ = job("untraced")
        first = torch.profiler.profile(activities=acts)
        first.start()
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()
        first.stop()
        graphs.clear()
        job("capture")
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        got, files, counts = job("traced")
        prof.stop()
        os.makedirs(prof_dir)
        prof.export_chrome_trace(os.path.join(prof_dir, "job.pt.trace.json"))
    (path,) = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    groups: dict = {}
    for i, m in enumerate(seeds):
        groups.setdefault((m.W, m.K), []).append(i)
    records = sum(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") for e in events)
    bodies = loop_bodies() if refine != "none" else []
    return {"case": case, "results_equal": fdr_results_equal(ref, got),
            "files_equal": files == ref_files, "files": sorted(files), "counts": counts,
            "device_records": records, "loop_bodies": bodies,
            "em_counts": fold_kernels(events, "em_counts_kernel"),
            "fold_loop_iterations": fold_loop_iterations(got, list(groups.values())),
            "trace_bytes": os.path.getsize(path)}


def check_traced_fdr(case: str, tmp: str) -> dict:
    """``traced_fdr_worker``'s case in a process of its own: the traced
    job's FDRResults and written files equal the untraced job's byte for
    byte; its trace counts captures and evictions (and, with a refinement,
    loop operations, far under CUPTI_LOOP_RECORDS and no more than the
    trace's device records: ``graph.loop_ops`` misses no operation run
    inside a WHILE node, ``loop_bodies``); where EM refines, every
    fold-loop iteration's ``em_counts_kernel`` lies inside a
    ``bamm::fdr.folds`` annotation of the trace; ``--profile`` wrote its
    Chrome trace."""
    out = run_worker("traced-fdr", case, tmp)
    refine = TRACED_FDR_CASES[case]
    counts = out["counts"]
    assert out["results_equal"] and out["files_equal"] and out["files"], out
    assert counts.get("graph.capture", 0) > 0 and counts.get("graph.evict", 0) > 0, out
    assert out["em_counts"]["folds"] == 2 and out["trace_bytes"] > 0, out
    if refine == "none":
        assert "graph.loop_ops" not in counts, out
    else:
        assert 0 < counts["graph.loop_ops"] < CUPTI_LOOP_RECORDS // 4, out
        assert out["device_records"] >= counts["graph.loop_ops"], out
    if refine in ("EM", "cli"):
        assert out["em_counts"]["in_fold_stages"] == out["fold_loop_iterations"] > 0, \
            (out["em_counts"], out["fold_loop_iterations"])
    return out


def cupti_store_worker(tmp: str) -> dict:
    """The store of loop records, standalone: a WHILE-node loop
    (``ops.cuda_while.WhileGraph``) around a captured body of ten small
    torch kernels.  Untraced, loops of 2.5 CUPTI_LOOP_RECORDS operations;
    after a first profiler window (CUDA), a loop graph built anew, traced
    in a window of half the store (its records counted), then in a second
    window up to 2.2 stores in all, stopped at the first CUDA error."""
    from bammmotif2_tpu_torch.refinement import graphs

    dev = torch.device("cuda")
    acts = [torch.profiler.ProfilerActivity.CUDA]

    def loop(iters: int):
        its = torch.zeros(1, dtype=torch.int32, device=dev)
        state = (its, torch.ones(1, device=dev), torch.full((), iters, dtype=torch.int32,
                                                            device=dev),
                 torch.zeros((), device=dev), torch.ones((), dtype=torch.bool, device=dev),
                 torch.zeros((), dtype=torch.int64, device=dev))
        x = torch.zeros(256, device=dev)

        def body():
            its.add_(1)
            for _ in range(9):
                x.add_(1.0)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.capture_begin()
            body()
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        raw = int(graph.raw_cuda_graph())
        ops = graphs.body_ops(cuda_while.node_types(raw)) * iters
        while_graph = cuda_while.WhileGraph(raw, *state)

        def launch():
            its.zero_()
            state[4].fill_(True)
            while_graph.launch()
            torch.cuda.synchronize(dev)
            assert int(its.item()) == iters
            return ops

        launch.keep = (graph, while_graph, state, x)
        return launch

    out = {}
    untraced = loop(20_000)
    out["untraced_ops"] = sum(untraced() for _ in range(4))
    first = torch.profiler.profile(activities=acts)
    first.start()
    torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize(dev)
    first.stop()
    traced = loop(2_000)

    def window(limit):
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        ops = 0
        try:
            while ops < limit:
                ops += traced()
        except Exception as err:  # the fault's CUDA error (torch.AcceleratorError)
            return ops, None, str(err).splitlines()[0]
        prof.stop()
        return ops, sum(1 for e in prof.events() if e.device_type.name == "CUDA"), None

    out["first_ops"], out["first_records"], out["first_error"] = window(CUPTI_LOOP_RECORDS // 2)
    out["second_ops"], out["second_records"], out["second_error"] = window(
        int(2.2 * CUPTI_LOOP_RECORDS) - out["first_ops"])
    return out


def check_cupti_store(tmp: str) -> dict:
    """``cupti_store_worker`` in a process of its own: untraced loops run
    well past the store; a traced window inside it runs and records every
    loop operation; and where a traced window faults, it is past the
    store (what CUPTI 12.8 does there: PERF.md section 7 item 2)."""
    out = run_worker("cupti-store", "", tmp)
    assert out["untraced_ops"] > 2 * CUPTI_LOOP_RECORDS, out
    assert out["first_error"] is None and out["first_records"] >= out["first_ops"], out
    if out["second_error"] is not None:
        assert out["first_ops"] + out["second_ops"] >= CUPTI_LOOP_RECORDS, out
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
@pytest.mark.parametrize("name", sorted(ACTIVITY_CASES))
def test_pass_dealt_to_the_active_seeds_matches_the_full_pass(cuda_device, name):
    check_activity(ACTIVITY_CASES[name], cuda_device)


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
def test_flat_calls_enqueue_their_kernel_and_no_gather(cuda_device):
    check_flat_calls(cuda_device)


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


@pytest.mark.cuda
def test_loops_graphed_equal_eager_one_read_a_chunk_and_failed_captures_raise(cuda_device):
    check_loops(cuda_device)


@pytest.mark.cuda
def test_loop_condition_kernel_matches_plain(cuda_device):
    check_condition(cuda_device)


@pytest.mark.cuda
def test_device_loop_converged_warm_up_stopped_and_cached(cuda_device):
    check_device_loop_cases(cuda_device)


@pytest.mark.cuda
def test_loop_cache_counts_and_capture_spans(cuda_device):
    check_loop_trace(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(UPDATE_CASES))
def test_update_kernel_matches_torch_update(cuda_device, name):
    check_update(UPDATE_CASES[name], cuda_device)


@pytest.mark.cuda
def test_em_multi_fused_within_the_benchmark_limits_and_four_ops_an_iteration(cuda_device):
    check_em_multi_fused(cuda_device)


@pytest.mark.cuda
def test_background_counts_on_the_card_and_one_index_a_job(cuda_device, tmp_path):
    check_background(cuda_device, str(tmp_path))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TRACED_FDR_CASES))
def test_traced_fdr_job_equals_untraced(cuda_device, case, tmp_path):
    check_traced_fdr(case, str(tmp_path))


@pytest.mark.cuda
def test_cupti_faults_only_past_its_store_of_loop_records(cuda_device, tmp_path):
    check_cupti_store(str(tmp_path))


if __name__ == "__main__":
    import json
    import os
    import sys

    kind, case, tmp = sys.argv[1:4]
    res = traced_fdr_worker(case, tmp) if kind == "traced-fdr" else cupti_store_worker(tmp)
    print(json.dumps(res), flush=True)
    os._exit(0)  # after a CUDA fault, the interpreter's teardown would touch the context
