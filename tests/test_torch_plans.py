"""The launch plans of the E+M and window-score kernels (``ops/cuda_em.py``,
``ops/cuda_scores.py``), checked on the CPU: a plan never asks for more
shared memory than one H100 block may opt into, puts a table in shared
memory only where it fits, and takes the global fallbacks where it must.
Imports no JAX."""

import pytest

from bammmotif2_tpu_torch.ops import cuda_em, cuda_scores, encode
from bammmotif2_tpu_torch.tools import kernel_variants

SMEM_MAX = cuda_em.SMEM_MAX
GEOMETRIES = ((2, 200), (1, 200), (2, 512), (2, 9_000))  # (S, L)


@pytest.mark.parametrize("M", (1, 4, 10))
@pytest.mark.parametrize("W", (8, 12, 30))
@pytest.mark.parametrize("A", (4, 5))
@pytest.mark.parametrize("K", range(6))
def test_em_launch_plan(K, A, W, M):
    R1 = encode.num_rows(A, K) + 1
    for S, L in GEOMETRIES:
        plan = cuda_em.launch_plan(M, R1, W, S, L)
        assert cuda_em.smem_bytes(plan, R1, W) <= SMEM_MAX, plan
        assert plan.team == (32 if S * L <= cuda_em.WARP_ROW_CODES else 256)
        assert plan.codes_cap % 4 == 0 and plan.codes_cap >= W
        if plan.team == 32:
            assert plan.codes_cap >= S * L  # a warp holds its whole row
        assert 1 <= plan.seeds_per_block <= M
        words = int(plan.smem_lut) + 1 + int(plan.fixed_counts)
        assert plan.seeds_per_block == 1 or (
            plan.seeds_per_block * R1 * W * 4 * words <= cuda_em.TABLES_TARGET)
        def fits(lut, counts, fixed):
            return cuda_em.smem_bytes(cuda_em.Plan(1, lut, counts, fixed, plan.team, plan.codes_cap),
                                      R1, W) <= SMEM_MAX

        counts_fit = fits(False, True, False)
        assert plan.smem_counts == counts_fit
        # fixed-point counts (8 bytes an entry) wherever they fit
        assert plan.fixed_counts == (counts_fit and fits(False, True, True))
        # the LUT in shared memory wherever it fits beside the counts
        assert plan.smem_lut == (plan.smem_counts and fits(True, True, plan.fixed_counts))
        if not plan.smem_counts:  # float64 global counts, LUT through L1
            assert not plan.smem_lut and not plan.fixed_counts and plan.seeds_per_block == 1
        assert plan.counts == (2 if plan.fixed_counts else int(plan.smem_counts))
        if A == 4 and K == 5 and W >= 12:  # 262 KB of counts a seed
            assert not plan.smem_counts


@pytest.mark.parametrize("M", (1, 4, 10))
@pytest.mark.parametrize("W", (8, 12, 30))
@pytest.mark.parametrize("A", (4, 5))
@pytest.mark.parametrize("K", range(6))
def test_scores_launch_plan(K, A, W, M):
    R1 = encode.num_rows(A, K) + 1
    spb, smem_lut = cuda_scores.launch_plan(M, R1, W)
    assert cuda_scores.smem_bytes(spb, smem_lut, R1, W) <= SMEM_MAX
    assert smem_lut == (cuda_scores.smem_bytes(1, True, R1, W) <= SMEM_MAX)
    if smem_lut:
        assert 1 <= spb <= M
        assert spb == 1 or spb * R1 * (W | 1) * 4 <= cuda_em.SMEM_TARGET
    else:  # LUT through L1: every seed shares one block's codes
        assert spb == M
    if A == 4 and K == 5 and W >= 12:
        assert not smem_lut


@pytest.mark.parametrize("case", sorted(kernel_variants.PLAN_CASES))
def test_plan_sweep_alternatives(case):
    """kernel_variants' em_plans sweep: every plan it launches fits one
    block's shared memory, launch_plan's is among them (tagged), and the
    row-length cases put a warp against a block with launch_plan's tables."""
    o = kernel_variants.PLAN_CASES[case]
    R1 = encode.num_rows(4, o["K"]) + 1
    teams_only = "_L" in case
    plans = kernel_variants.alternative_plans(o["M"], R1, o["W"], 2, o["L"], teams_only)
    base = cuda_em.launch_plan(o["M"], R1, o["W"], 2, o["L"])
    assert [p for t, p in plans.items() if t.startswith("plan:")] == [base]
    assert all(cuda_em.smem_bytes(p, R1, o["W"]) <= SMEM_MAX for p in plans.values())
    assert len(set(plans.values())) == len(plans)
    if teams_only:
        assert sorted(p.team for p in plans.values()) == [32, 256]
        assert {p._replace(team=0, codes_cap=0) for p in plans.values()} == {
            base._replace(team=0, codes_cap=0)}
