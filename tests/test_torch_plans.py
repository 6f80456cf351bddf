"""The launch plans of the E+M, window-score and counts-from-r kernels
(``ops/cuda_em.py``, ``ops/cuda_scores.py``, ``ops/cuda_counts.py``,
``ops/cuda_flat.py``), checked on the CPU: a plan never asks for more
shared memory than one H100 block may opt into, puts a table in shared
memory only where it fits, and takes the global fallbacks where it must;
the flat kernels run the combined kernels' plans.  The seed stacks split
into balanced chunks, with the reference's chunk arithmetic
(``bammmotif2_tpu.refinement.multi._stacked_em_counts``, the one JAX
import here).  Also the counts wrappers' per-stream workspace."""

import numpy as np
import pytest
import torch

from bammmotif2_tpu.ops import pallas_em as jpallas_em
from bammmotif2_tpu.refinement import multi as jmulti
from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em, cuda_flat, cuda_scores, encode
from bammmotif2_tpu_torch.tools import kernel_variants

SMEM_MAX = cuda_em.SMEM_MAX
GEOMETRIES = ((2, 200), (1, 200), (2, 512), (2, 9_000))  # (S, L)


@pytest.mark.parametrize("M", (1, 4, 10, 16, 33))
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
        assert plan.seeds_per_block == 1  # a seed's blocks are its own
        assert plan == cuda_em.launch_plan(M, R1, W, S, L)  # the same plan for the same shapes
        # one launch, or one a seed where the counts are float
        launches = cuda_em.seed_launches(plan, M)
        float_counts = plan.smem_counts and not plan.fixed_counts
        assert len(launches) == (M if float_counts else min(M, 1))
        assert [m for a, b in launches for m in range(a, b)] == list(range(M))

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


@pytest.mark.parametrize("M", (1, 4, 10, 16, 33))
@pytest.mark.parametrize("W", (8, 12, 30))
@pytest.mark.parametrize("A", (4, 5))
@pytest.mark.parametrize("K", range(6))
def test_scores_launch_plan(K, A, W, M):
    R1 = encode.num_rows(A, K) + 1
    spb, smem_lut = cuda_scores.launch_plan(M, R1, W)
    assert (spb, smem_lut) == cuda_scores.launch_plan(M, R1, W)  # deterministic
    assert cuda_scores.smem_bytes(spb, smem_lut, R1, W) <= SMEM_MAX
    assert smem_lut == (cuda_scores.smem_bytes(1, True, R1, W) <= SMEM_MAX)
    if smem_lut:
        assert 1 <= spb <= M
        lut = R1 * (W | 1) * 4
        assert spb == 1 or spb * lut <= cuda_scores.LUT_TARGET
        # balanced: as few chunks as the cap allows, sizes within one
        cap = max(n for n in range(1, M + 1) if n == 1 or (
            n * lut <= cuda_scores.LUT_TARGET
            and cuda_scores.smem_bytes(n, True, R1, W) <= SMEM_MAX))
        chunks = -(-M // spb)  # the launcher's grid y
        assert chunks == -(-M // cap) and spb == -(-M // chunks)
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


@pytest.mark.parametrize("cap", (1, 2, 3, 4, 5, 6, 8, 11, 16, 32))
def test_seed_chunks_are_balanced(cap):
    """M = 0..70 seeds at a cap: ceil(M / cap) consecutive chunks that cover
    the seeds once, never above the cap, sizes differing by at most one, the
    same split every call (the kernels' grid-y split, y * M // n); the plan
    sweep's seeds a block give each distinct split once."""
    for M in range(71):
        chunks = cuda_em.seed_chunks(M, cap)
        assert len(chunks) == -(-M // cap)
        assert [m for a, b in chunks for m in range(a, b)] == list(range(M))
        sizes = [b - a for a, b in chunks]
        assert all(0 < n <= cap for n in sizes)
        assert not sizes or max(sizes) - min(sizes) <= 1
        assert chunks == cuda_em.seed_chunks(M, cap)
        # the sweep's seeds a block: each distinct balanced split once
        splits = {len(cuda_em.seed_chunks(M, c)) for c in range(1, M + 1)}
        caps = kernel_variants.seed_caps(M)
        assert sorted(len(cuda_em.seed_chunks(M, c)) for c in caps) == sorted(splits)


@pytest.mark.parametrize("cap", (1, 2, 3, 4, 6, 7, 16))
def test_seed_chunks_match_the_reference_arithmetic(cap, monkeypatch):
    """For the same chunk cap (the reference's ``max_seeds``), the port
    splits M = 1..70 seeds into as many chunks as
    ``_stacked_em_counts`` (n = ceil(M / cap)) and its largest chunk is the
    reference's chunk size, ceil(M / n); where the reference leaves a
    short last chunk (10 at 4: 4 + 4 + 2) the port's differ by one (4 + 3
    + 3)."""
    calls = []

    def record(s_flat, cidx, lens, q, **_kw):
        calls.append(s_flat.shape[0])
        return s_flat, q

    # the kernel call records its stack; numpy stands in for the arrays
    monkeypatch.setattr(jpallas_em, "max_seeds", lambda *a, **k: cap)
    monkeypatch.setattr(jpallas_em, "em_counts_multi", record)
    monkeypatch.setattr(jmulti.jnp, "concatenate", np.concatenate)
    for M in range(1, 71):
        calls.clear()
        C, ll = jmulti._stacked_em_counts(np.arange(M)[:, None, None], np.zeros((2, 1, 4)),
                                          np.zeros(1), np.arange(M), A=4, K=0, W=1, R=1,
                                          interpret=True)
        assert C.ravel().tolist() == ll.tolist() == list(range(M))
        sizes = [b - a for a, b in cuda_em.seed_chunks(M, cap)]
        assert sum(calls) == sum(sizes) == M
        assert len(sizes) == len(calls), (M, sizes, calls)
        assert max(sizes) == max(calls), (M, sizes, calls)
