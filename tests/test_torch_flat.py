"""Port parity: the base-(A+1) k-mer encoder (``ops/encode.py``) and the three
flat-layout passes (``ops/cuda_flat.py``, whose plain versions CPU tensors
take) against the JAX package's encoder and ``tools/pallas_flat.py`` in
interpret mode, and against the port's combined-layout plain versions, on the
same numpy-seeded sequences.

Bars (the TPU module's numerics): window scores within SC_ATOL on valid
windows with an identical mask and exactly NEG_INF elsewhere; counts within
C_ATOL + C_RTOL*|C| (the TPU kernel's 2-term bf16 split of r, relative error
~1e-6); ll within LL_RTOL.  Against the port's own combined plain versions
the scores are equal and counts agree to CC_ATOL + CC_RTOL*|C| (both sum in
float64; the flat path folds base-(A+1) sums into combined rows).  The TPU
``counts_from_r`` reads r at all L positions and rolls mass at
i >= L-W+1 into the next strand's or row's lanes, so r is zero there (the
port's contract)."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bammmotif2_tpu.ops import encode as jencode
from bammmotif2_tpu_torch import convert
from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em, cuda_flat, cuda_scores, encode
from bammmotif2_tpu_torch.ops.escore import NEG_INF
from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.fasta import SequenceSet

from tests.test_torch_encode import ragged_set

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import pallas_flat  # noqa: E402  (tools/pallas_flat.py)

torch.set_num_threads(1)

SC_ATOL = 1e-5
C_ATOL, C_RTOL, LL_RTOL = 1e-4, 1e-5, 1e-5
CC_ATOL, CC_RTOL = 1e-5, 1e-6


@pytest.mark.parametrize("alphabet", ["STANDARD", "METHYLC"])
@pytest.mark.parametrize("ss", [False, True])
@pytest.mark.parametrize("K", [0, 2, 5])
def test_base5_indices_match_jax(K, ss, alphabet):
    """Bit-identical to the JAX encoder on AMBIG, PAD, empty rows, --ss and
    A=5; map5[qidx] is the combined index everywhere."""
    sset = ragged_set(alphabet, seed=20 + K)
    psset = convert.sequence_set(sset)
    qidx = encode.strand_base5_indices(psset, K, ss, device="cpu")
    jq = jencode.strand_base5_indices(sset, K, ss)
    assert qidx.dtype == torch.int32
    np.testing.assert_array_equal(qidx.numpy(), np.asarray(jq))
    A = psset.alphabet.size
    assert int(qidx.min()) >= 0 and int(qidx.max()) < (A + 1) ** (K + 1)
    cidx, _lens = encode.strand_indices(psset, K, ss, device="cpu")
    map5 = torch.from_numpy(encode.map_base5_to_combined(A, K))
    assert torch.equal(map5[qidx.long()], cidx)
    # the single-row encoder on the raw codes, padding included
    np.testing.assert_array_equal(
        encode.base5_kmer_index(torch.from_numpy(psset.codes), A, K).numpy(),
        np.asarray(jencode.base5_kmer_index(jnp.asarray(sset.codes), A, K)))


@pytest.mark.parametrize("A", [4, 5])
@pytest.mark.parametrize("K", [0, 1, 2, 3, 4, 5])
def test_map_base5_matches_jax(A, K):
    map5 = encode.map_base5_to_combined(A, K)
    assert map5.dtype == np.int32 and map5.shape == ((A + 1) ** (K + 1),)
    np.testing.assert_array_equal(map5, jencode.map_base5_to_combined(A, K))


def flat_problem(K, W, A=4, ss=False, ragged=False, n=40, length=50, seed=0):
    """numpy-seeded sequences (1% ambiguous; ``ragged``: lengths in [0, L]
    with rows of length 0, W-1 and W), a random LUT [R+1, W] with a zero
    sentinel row, q, and fractional r [S, N, L] that is zero at
    i >= L-W+1 but carries mass on windows past a row's end, as the port's
    CPU tensors (qidx, cidx, lens, map5 int32; s_flat, r float32)."""
    rng = np.random.default_rng(seed)
    alphabet = Alphabet.from_type("STANDARD" if A == 4 else "METHYLC")
    codes = rng.integers(0, A, (n, length)).astype(np.int8)
    codes[rng.random((n, length)) < 0.01] = -1
    lens = np.full(n, length, np.int32)
    if ragged:
        lens = rng.integers(0, length + 1, n).astype(np.int32)
        lens[:3] = [0, W - 1, W]
    codes[np.arange(length)[None, :] >= lens[:, None]] = -2
    psset = SequenceSet(codes, lens, [f"s{i}" for i in range(n)], alphabet)
    R = encode.num_rows(A, K)
    s_flat = rng.normal(0.0, 1.0, (R + 1, W)).astype(np.float32)
    s_flat[R] = 0.0
    S = 1 if ss else 2
    n_win = length - W + 1
    r = np.zeros((S, n, length), np.float32)
    r[:, :, :n_win] = rng.random((S, n, n_win)) / (S * n_win)
    qidx = encode.strand_base5_indices(psset, K, ss, device="cpu")
    cidx, lens_t = encode.strand_indices(psset, K, ss, device="cpu")
    return dict(
        A=A, K=K, W=W, R=R, qidx=qidx, cidx=cidx, lens=lens_t,
        map5=torch.from_numpy(encode.map_base5_to_combined(A, K)),
        s_flat=torch.from_numpy(s_flat), q=np.float32(rng.uniform(0.3, 0.95)),
        r=torch.from_numpy(r),
    )


CASES = {
    "K0_W8_ragged": dict(K=0, W=8, ragged=True),
    "K2_W8": dict(K=2, W=8),
    "K2_W6_ss_ragged": dict(K=2, W=6, ss=True, ragged=True),
    "K5_W6": dict(K=5, W=6),
    "A5_K2_W6": dict(K=2, W=6, A=5),
}


def _launches():
    return (cuda_flat.em_counts.launches, cuda_flat.window_scores.launches,
            cuda_flat.counts_from_r.launches)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_passes_match_pallas_flat(name):
    p = flat_problem(**CASES[name])
    kw = dict(A=p["A"], K=p["K"], W=p["W"])
    W, R = p["W"], p["R"]
    before = _launches()
    sc, mk = cuda_flat.window_scores(p["s_flat"], p["qidx"], p["lens"], p["map5"], **kw)
    C, ll = cuda_flat.em_counts(p["s_flat"], p["qidx"], p["lens"], p["q"], p["map5"], R=R, **kw)
    Cr = cuda_flat.counts_from_r(p["r"], p["qidx"], p["map5"], R=R, **kw)
    assert _launches() == before  # CPU tensors: the plain versions, no kernel
    S, N, L = p["qidx"].shape
    assert sc.shape == (S, N, L - W + 1) and sc.dtype == torch.float32 and mk.dtype == torch.bool
    assert C.shape == Cr.shape == (R + 1, W) and C.dtype == Cr.dtype == torch.float32
    assert ll.shape == () and ll.dtype == torch.float32

    jq, jlens = jnp.asarray(p["qidx"].numpy()), jnp.asarray(p["lens"].numpy())
    jmap5, js = jnp.asarray(p["map5"].numpy()), jnp.asarray(p["s_flat"].numpy())
    psc, pmk = pallas_flat.window_scores(js, jq, jlens, jmap5, interpret=True, **kw)
    np.testing.assert_array_equal(mk.numpy(), np.asarray(pmk))
    valid = np.broadcast_to(mk.numpy()[None], sc.shape)
    np.testing.assert_allclose(sc.numpy()[valid], np.asarray(psc)[valid], rtol=0, atol=SC_ATOL)
    assert (sc.numpy()[~valid] == NEG_INF).all() and (np.asarray(psc)[~valid] == NEG_INF).all()

    pC, pll = pallas_flat.em_counts(js, jq, jlens, jnp.float32(p["q"]), jmap5, R=R,
                                    interpret=True, **kw)
    assert np.all(np.abs(C.numpy() - np.asarray(pC)) <= C_ATOL + C_RTOL * np.abs(np.asarray(pC)))
    np.testing.assert_allclose(float(ll), float(pll), rtol=LL_RTOL)

    pCr = pallas_flat.counts_from_r(jnp.asarray(p["r"].numpy()), jq, jmap5, R=R,
                                    interpret=True, **kw)
    assert np.all(np.abs(Cr.numpy() - np.asarray(pCr)) <= C_ATOL + C_RTOL * np.abs(np.asarray(pCr)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_passes_match_combined_plain(name):
    """The flat plain versions against the port's combined-layout ones
    (escore on cidx): scores and ll equal, counts within CC_ATOL +
    CC_RTOL*|C|; row R holds the sentinel mass in both."""
    p = flat_problem(**CASES[name], seed=1)
    kw = dict(A=p["A"], K=p["K"], W=p["W"])
    W, R = p["W"], p["R"]
    sc, mk = cuda_flat.window_scores(p["s_flat"], p["qidx"], p["lens"], p["map5"], **kw)
    csc, cmk = cuda_scores.window_scores(p["s_flat"], p["cidx"], p["lens"])
    assert torch.equal(sc, csc) and torch.equal(mk, cmk)

    q = torch.tensor([p["q"]])
    C, ll = cuda_flat.em_counts(p["s_flat"], p["qidx"], p["lens"], q, p["map5"], R=R, **kw)
    cC, cll = cuda_em.em_counts_multi(p["s_flat"][None], p["cidx"], p["lens"], q)
    assert torch.all((C - cC[0]).abs() <= CC_ATOL + CC_RTOL * cC[0].abs())
    assert float(ll) == float(cll[0])

    Cr = cuda_flat.counts_from_r(p["r"], p["qidx"], p["map5"], R=R, **kw)
    cCr = cuda_counts.counts_from_r(p["r"], p["cidx"], R, W)
    assert torch.all((Cr - cCr).abs() <= CC_ATOL + CC_RTOL * cCr.abs())
    # every window start deposits its r once at each offset
    np.testing.assert_allclose(Cr.sum(0).numpy(), np.full(W, float(p["r"].sum())), rtol=1e-5)


def test_zero_rows_and_short_rows_contribute_log1m_q():
    """Rows of length 0 and < W have no windows: each adds log(1-q) to ll
    and nothing to C (no block padding, so no pad-row correction)."""
    p = flat_problem(K=2, W=8, n=6, length=20, ragged=True)
    lens = torch.tensor([0, 7, 0, 3, 7, 1], dtype=torch.int32)
    kw = dict(A=4, K=2, W=8, R=p["R"])
    C, ll = cuda_flat.em_counts(p["s_flat"], p["qidx"], lens, 0.6, p["map5"], **kw)
    assert float(C.abs().sum()) == 0.0
    assert float(ll) == pytest.approx(6 * float(np.log1p(np.float32(-0.6))), rel=1e-6)


def test_launch_plans():
    """The flat kernels run the combined kernels' plans for one seed (A=4,
    W=12, bench's rows of 200 bp on both strands); the E+M kernel reads map5
    through L1, and the scores kernel's map fits beside its plan."""
    R1 = {K: encode.num_rows(4, K) + 1 for K in (2, 3, 4, 5)}
    for K in (2, 3, 4, 5):
        plan = cuda_flat.em_plan(R1[K], 12, 2, 200)
        assert plan == cuda_em.launch_plan(1, R1[K], 12, 2, 200)
        # fixed-point shared counts with the LUT beside them up to K=4; K=5
        # adds to global counts
        assert plan.counts == (2 if K <= 4 else 0) and plan.smem_lut == (K <= 4)
    # window scores: the LUT beside B2's buffers up to K=4, through L1 at K=5;
    # the map fits beside them (62.5 KB at K=5)
    for K in (2, 3, 4):
        assert cuda_flat.scores_plan(5 ** (K + 1), R1[K], 12) == (True, True)
    assert cuda_flat.scores_plan(5 ** 6, R1[5], 12) == (False, True)
    # A=4, K=4, W=30: float counts ([R1, W] 164 KB), the LUT through L1
    plan = cuda_flat.em_plan(R1[4], 30, 2, 200)
    assert (plan.smem_counts, plan.fixed_counts, plan.smem_lut) == (True, False, False)
    # counts from r land in combined rows: K=4's [R1, W] (65 KB) stays in
    # shared memory, map5 through L1; K=5's (262 KB) in global memory
    assert cuda_flat.counts_plan(5 ** 3, R1[2], 12) == (True, True)
    assert cuda_flat.counts_plan(5 ** 5, R1[4], 12) == (True, False)
    assert cuda_flat.counts_plan(5 ** 6, R1[5], 12) == (False, False)


def test_plain_versions_reject_width_beyond_length():
    qidx = torch.zeros((2, 3, 5), dtype=torch.int32)
    map5 = torch.from_numpy(encode.map_base5_to_combined(4, 0))
    lens = torch.full((3,), 5, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_flat.window_scores(torch.zeros((5, 6)), qidx, lens, map5, A=4, K=0, W=6)
    with pytest.raises(ValueError):
        cuda_flat.counts_from_r(torch.zeros((2, 3, 5)), qidx, map5, A=4, K=0, W=6, R=4)
