"""The launch plans of the E+M, window-score and counts-from-r kernels
(``ops/cuda_em.py``, ``ops/cuda_scores.py``, ``ops/cuda_counts.py``,
``ops/cuda_flat.py``), checked on the CPU: a plan never asks for more
shared memory than one H100 block may opt into, puts a table in shared
memory only where it fits, and takes the global fallbacks where it must;
the flat kernels run the combined kernels' plans.
Also the counts wrappers' per-stream workspace.  Imports no JAX."""

import pytest
import torch

from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em, cuda_flat, cuda_scores, encode
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


@pytest.mark.parametrize("W", (8, 12, 30))
@pytest.mark.parametrize("A", (4, 5))
@pytest.mark.parametrize("K", range(6))
def test_counts_launch_plans(K, A, W):
    """B3 privatises one seed's combined [R1, W] counts per block where they
    fit; B4c does the same on the same table (its counts land in combined
    rows) and stages map5 beside them only within SMEM_TARGET, so at A=4,
    W=12 the map is read through L1 from K=4 on."""
    R1 = encode.num_rows(A, K) + 1
    Q = (A + 1) ** (K + 1)
    static = cuda_counts.STATIC_SMEM
    smem_counts = cuda_counts.launch_plan(R1, W)
    assert smem_counts == (R1 * W * 4 + static <= SMEM_MAX)
    flat_counts, smem_map = cuda_flat.counts_plan(Q, R1, W)
    assert flat_counts == smem_counts
    table = R1 * W * 4 if smem_counts else 0
    assert table + (Q * 4 if smem_map else 0) + static <= SMEM_MAX
    assert smem_map == (table + Q * 4 <= cuda_em.SMEM_TARGET)
    if A == 4 and W == 12:
        assert smem_counts == (K <= 4)  # 262 KB a seed at K=5
        assert smem_map == (K <= 3)
    assert cuda_flat.counts_plan(Q, R1, W) is cuda_flat.counts_plan(Q, R1, W)  # cached


@pytest.mark.parametrize("W", (8, 12, 30))
@pytest.mark.parametrize("A", (4, 5))
@pytest.mark.parametrize("K", range(6))
def test_flat_launch_plans(K, A, W):
    """B4a runs B1's plan and B4b B2's, each for one seed, never downgraded
    for map5.  B4a reads the map through L1, so its plan's own bytes fit
    under SMEM_MAX; B4b may stage it only where its bytes fit under SMEM_MAX
    beside that plan (the launcher then asks the occupancy query)."""
    R1 = encode.num_rows(A, K) + 1
    Q = (A + 1) ** (K + 1)
    for S, L in GEOMETRIES:
        plan = cuda_flat.em_plan(R1, W, S, L)
        assert plan == cuda_em.launch_plan(1, R1, W, S, L)
        assert cuda_em.smem_bytes(plan, R1, W) <= SMEM_MAX, (S, L)
    smem_lut, map_fits = cuda_flat.scores_plan(Q, R1, W)
    assert (1, smem_lut) == cuda_scores.launch_plan(1, R1, W)
    base = cuda_scores.smem_bytes(1, smem_lut, R1, W)
    assert base <= SMEM_MAX and map_fits == (base + 4 * Q <= SMEM_MAX)
    if A == 4 and W == 12:  # bench's rows: the LUT in shared memory up to K=4
        assert smem_lut == (K <= 4) and map_fits
        assert cuda_flat.em_plan(R1, W, 2, 200).smem_lut == (K <= 4)
    assert cuda_flat.scores_plan(Q, R1, W) is cuda_flat.scores_plan(Q, R1, W)  # cached


def test_counts_workspace_grows_and_keeps_retired_buffers():
    """One zeroed (acc, tickets) pair per (device, stream): reused while it
    fits, grown (never shrunk) when a call needs more, with the outgrown
    buffers kept alive for CUDA graphs that captured them."""
    dev = torch.device("cpu")
    key = (dev.index, 12345)
    cuda_counts._WORKSPACES.pop(key, None)
    try:
        acc, tickets = cuda_counts.workspace(dev, 12345, 100, 2)
        assert acc.dtype == torch.float64 and tickets.dtype == torch.int32
        assert acc.numel() == 100 and tickets.numel() == 2
        assert not acc.any() and not tickets.any()
        again = cuda_counts.workspace(dev, 12345, 50, 1)
        assert again[0] is acc and again[1] is tickets
        grown = cuda_counts.workspace(dev, 12345, 40, 7)
        assert grown[0].numel() == 100 and grown[1].numel() == 7
        assert any(t is acc for t in cuda_counts._WORKSPACES[key][2])
        other = cuda_counts.workspace(dev, 54321, 10, 1)
        assert other[0] is not grown[0]
    finally:
        cuda_counts._WORKSPACES.pop(key, None)
        cuda_counts._WORKSPACES.pop((dev.index, 54321), None)
