"""The CGS sweep's counter-based draws (``ops/cuda_draws.py``): the plain
Philox4x32-10 against Random123's known-answer vectors, the draws'
invariants (row offsets, sweeps, chains) and their distributions, on the
CPU; and, in the ``cuda`` lane, ``csrc/cgs_draws.cu`` against the plain
versions and ``csrc/philox.cuh`` against cuRAND's Philox.

``chip_smoke.py`` runs the card's checks (``check_uniforms``,
``check_beta``, ``check_philox_curand``) at the main path's shapes.  The
draws' distributions against ``jax.random``'s: tests/test_torch_gibbs.py.
This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import stats

from bammmotif2_tpu_torch.ops import cuda_draws
from bammmotif2_tpu_torch.refinement import gibbs

torch.set_num_threads(1)

# Random123's kat_vectors for philox4x32_10: (counter, key, output words)
KAT = {
    "zeros": ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}
# Beta shapes of the KS tests: a = n_occ + 1, b = n_real - n_occ + 1 at the
# edges (no row occupied, one row) and in the middle of the sampler's range
BETA_SHAPES = [(1.0, 1.0), (2.0, 300.0), (30.0, 12.0), (8_001.0, 2_000.0)]
# the kernel's q against the plain version's where both took the same
# candidates (float64 arithmetic; the card's log and cos may be an ulp
# off), and the share of draws whose candidates may differ (a candidate at
# its acceptance boundary flipped by such an ulp)
BETA_RTOL, BETA_FLIP_SHARE = 1e-5, 1e-4
Q_MIN, Q_MAX = gibbs.Q_MIN, gibbs.Q_MAX


def sweep(i: int, device="cpu") -> torch.Tensor:
    return torch.tensor([i], dtype=torch.int64, device=device)


def random_keys(n: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """n keys of random 32-bit words."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 2 ** 32, (n, 2)), dtype=torch.int64, device=device)


@pytest.mark.parametrize("name", sorted(KAT))
def test_philox_known_answers(name):
    ctr, key, want = KAT[name]
    got = cuda_draws.philox4x32_10(ctr, key)
    assert [int(x) for x in got] == list(want)


def test_philox_broadcasts_over_counters_and_keys():
    """A batch of counters under a batch of keys gives each pair's words."""
    ctrs = [c for c, _k, _w in KAT.values()]
    keys = [k for _c, k, _w in KAT.values()]
    got = cuda_draws.philox4x32_10(tuple(torch.tensor(w) for w in zip(*ctrs)),
                                   tuple(torch.tensor(w) for w in zip(*keys)))
    assert torch.stack(got, dim=1).tolist() == [list(w) for _c, _k, w in KAT.values()]


@pytest.mark.parametrize("row0,n", [(0, 37), (5, 20), (36, 1)])
def test_uniforms_of_a_shard_are_the_whole_sets_rows(row0, n):
    """Rows row0 .. row0+n-1 drawn as a shard equal the same rows of the
    whole set: a row's uniform depends on its global index only."""
    keys, i = random_keys(3), sweep(4)
    whole = cuda_draws.uniforms_ref(keys, i, 0, 40)
    assert torch.equal(cuda_draws.uniforms_ref(keys, i, row0, n), whole[:, row0 : row0 + n])


def test_uniforms_are_the_first_word_in_24_bits():
    """u = (x0 >> 8) 2^-24 of counter (row, sweep, 0, 0): in [0, 1), a
    multiple of 2^-24, exact in float32."""
    keys, i = random_keys(2, seed=1), sweep(7)
    u = cuda_draws.uniforms_ref(keys, i, 3, 50)
    x0 = cuda_draws.philox4x32_10((torch.arange(3, 53)[None], 7, 0, 0),
                                  (keys[:, 0:1], keys[:, 1:2]))[0]
    assert u.dtype == torch.float32 and ((u >= 0) & (u < 1)).all()
    assert torch.equal(u.double() * 2 ** 24, (x0 >> 8).double())


def test_sweeps_and_chains_differ():
    """Another sweep index, another chain, another row: other numbers; the
    same (key, sweep, rows): the same numbers."""
    keys = gibbs.chain_keys(3, [0, 1], "cpu")
    u0, u1 = (cuda_draws.uniforms_ref(keys, sweep(i), 0, 500) for i in (0, 1))
    assert torch.equal(u0, cuda_draws.uniforms_ref(keys, sweep(0), 0, 500))
    assert (u0 != u1).float().mean() > 0.99
    assert (u0[0] != u0[1]).float().mean() > 0.99
    assert len(set(u0[0].tolist())) > 490
    a, b = torch.full((2,), 40.0), torch.full((2,), 60.0)
    q = [cuda_draws.beta_ref(keys, sweep(i), a, b, Q_MIN, Q_MAX) for i in range(3)]
    assert q[0][0] != q[0][1] and q[0][0] != q[1][0] != q[2][0]
    assert gibbs.chain_keys(3, [0], "cpu").tolist() != gibbs.chain_keys(4, [0], "cpu").tolist()


@pytest.mark.parametrize("a,b", BETA_SHAPES)
def test_beta_follows_scipy_beta(a, b):
    """20,000 chains' draws at one sweep against scipy.stats.beta by a
    Kolmogorov-Smirnov test (p > 1e-3, fixed keys); every draw took one of
    the first candidates."""
    n = 20_000
    keys = random_keys(n, seed=2)
    q, cand = cuda_draws.beta_ref(keys, sweep(0), torch.full((n,), a), torch.full((n,), b),
                                  Q_MIN, Q_MAX, candidates=True)
    pval = stats.kstest(q.double().numpy(), stats.beta(a, b).cdf).pvalue
    assert pval > 1e-3, pval
    assert int(cand.max()) < 8


def test_gamma_candidates_follow_marsaglia_tsang():
    """Each gamma draw is d v of its first accepted candidate, and about 5%
    of first candidates are rejected at shape 1, far fewer at 100."""
    n = 20_000
    keys = random_keys(n, seed=3)
    for shape, most in ((1.0, 0.06), (100.0, 0.002)):
        g, first = cuda_draws.gamma_ref(keys, sweep(0), torch.full((n,), shape), cuda_draws.TAG_X)
        assert (first < cuda_draws.BETA_CAP).all() and (g > 0).all()
        assert float((first > 0).double().mean()) < most
        pval = stats.kstest(g.numpy(), stats.gamma(shape).cdf).pvalue
        assert pval > 1e-3, (shape, pval)


def test_beta_rejects_shapes_below_one():
    keys = random_keys(2)
    with pytest.raises(ValueError, match=">= 1"):
        cuda_draws.beta_ref(keys, sweep(0), torch.tensor([0.5, 2.0]), torch.tensor([3.0, 1.0]),
                            Q_MIN, Q_MAX)


def test_z_draws_follow_the_softmax_by_ks():
    """2,000 rows, each with its own logits (invalid windows at NEG_INF):
    the randomised probability integral transform F(z - 1) + V p(z) of
    the z draws is uniform by a Kolmogorov-Smirnov test (p > 1e-3), and no
    zero-probability column is drawn."""
    rng = np.random.default_rng(5)
    n, cols = 2_000, 9
    logits = rng.normal(0.0, 1.5, (1, n, cols)).astype(np.float32)
    logits[0, rng.random(n) < 0.3, 4] = -1e30
    flat = torch.as_tensor(logits)
    z = gibbs.draw_z(flat, gibbs.chain_keys(8, [0], "cpu"), sweep(2), True)[0].numpy()
    p = torch.softmax(flat[0].double(), dim=-1).numpy()
    cdf = np.cumsum(p, axis=1)
    rows = np.arange(n)
    assert (p[rows, z] > 0).all()
    pit = cdf[rows, z] - p[rows, z] + rng.random(n) * p[rows, z]
    pval = stats.kstest(pit, "uniform").pvalue
    assert pval > 1e-3, pval


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers return the plain versions' results and
    launch nothing."""
    keys, i = random_keys(3, seed=6), sweep(9)
    a, b = torch.tensor([1.0, 5.0, 70.0]), torch.tensor([3.0, 1.0, 40.0])
    before = (cuda_draws.uniforms.launches, cuda_draws.beta.launches)
    assert torch.equal(cuda_draws.uniforms(keys, i, 2, 11), cuda_draws.uniforms_ref(keys, i, 2, 11))
    q, cand = cuda_draws.beta(keys, i, a, b, Q_MIN, Q_MAX, candidates=True)
    q_ref, cand_ref = cuda_draws.beta_ref(keys, i, a, b, Q_MIN, Q_MAX, candidates=True)
    assert torch.equal(q, q_ref) and torch.equal(cand, cand_ref)
    assert (cuda_draws.uniforms.launches, cuda_draws.beta.launches) == before


# ---- on the card ----

UNIFORM_SWEEPS, UNIFORM_ROW0S = (0, 1, 77), (0, 4_096)


def check_uniforms(device, M: int = 16, N: int = 10_000) -> dict:
    """cgs_uniforms against uniforms_ref at M chains and N rows (the 10k
    set at a 16-seed stack) for each of UNIFORM_SWEEPS and UNIFORM_ROW0S:
    bit-equal, one launch a call.  Returns {"cases", "mismatches",
    "launches"}."""
    keys = random_keys(M, seed=7, device=device)
    bad, before, cases = 0, cuda_draws.uniforms.launches, 0
    for i in UNIFORM_SWEEPS:
        for row0 in UNIFORM_ROW0S:
            got = cuda_draws.uniforms(keys, sweep(i, device), row0, N)
            want = cuda_draws.uniforms_ref(keys, sweep(i, device), row0, N)
            bad += int((got != want).sum())
            cases += 1
    torch.cuda.synchronize(device)
    out = {"cases": cases, "mismatches": bad, "launches": cuda_draws.uniforms.launches - before,
           "M": M, "N": N}
    assert bad == 0 and out["launches"] == cases, out
    return out


def check_beta(device, n: int = 100_000) -> dict:
    """cgs_beta against beta_ref on n (a, b) pairs (n chains, sweeps 0 and
    12; shapes from 1 to 10^4, a tenth of them below 4): the same
    candidates but for at most BETA_FLIP_SHARE of the draws, and q within
    BETA_RTOL where the candidates agree.  Returns {"pairs", "flips",
    "max_rel_err", "max_abs_err", "max_candidate", "launches"}."""
    rng = np.random.default_rng(8)
    shapes = np.where(rng.random((2, n)) < 0.1, rng.integers(1, 4, (2, n)),
                      rng.integers(1, 10_001, (2, n))).astype(np.float32)
    a = torch.as_tensor(shapes[0], device=device)
    b = torch.as_tensor(shapes[1], device=device)
    keys = random_keys(n, seed=9, device=device)
    flips, rel, err, top, before = 0, 0.0, 0.0, 0, cuda_draws.beta.launches
    for i in (0, 12):
        q, cand = cuda_draws.beta(keys, sweep(i, device), a, b, Q_MIN, Q_MAX, candidates=True)
        q_ref, cand_ref = cuda_draws.beta_ref(keys, sweep(i, device), a, b, Q_MIN, Q_MAX,
                                              candidates=True)
        same = (cand == cand_ref).all(dim=1)
        flips += int((~same).sum())
        d = (q - q_ref).abs()[same]
        rel = max(rel, float((d / q_ref.abs()[same]).max()))
        err = max(err, float(d.max()))
        top = max(top, int(cand.max()))
    torch.cuda.synchronize(device)
    out = {"pairs": 2 * n, "flips": flips, "max_rel_err": rel, "max_abs_err": err,
           "max_candidate": top, "launches": cuda_draws.beta.launches - before}
    assert flips <= BETA_FLIP_SHARE * 2 * n and rel <= BETA_RTOL and out["launches"] == 2, out
    return out


def check_philox_curand(device) -> dict:
    """philox.cuh's Philox4x32-10 against cuRAND's curand_Philox4x32_10
    on the card, on the known-answer pairs and 1,000 random ones; the
    known answers also against Random123's words.  Returns {"pairs",
    "mismatches_curand", "mismatches_known"}."""
    rng = np.random.default_rng(10)
    ctrs = np.concatenate([np.array([c for c, _k, _w in KAT.values()]),
                           rng.integers(0, 2 ** 32, (1_000, 4))])
    keys = np.concatenate([np.array([k for _c, k, _w in KAT.values()]),
                           rng.integers(0, 2 ** 32, (1_000, 2))])
    mine, theirs = cuda_draws.philox_pairs(torch.as_tensor(ctrs, device=device),
                                           torch.as_tensor(keys, device=device))
    known = torch.tensor([w for _c, _k, w in KAT.values()], device=device)
    out = {"pairs": len(ctrs), "mismatches_curand": int((mine != theirs).any(dim=1).sum()),
           "mismatches_known": int((mine[: len(KAT)] != known).any(dim=1).sum())}
    assert out["mismatches_curand"] == 0 and out["mismatches_known"] == 0, out
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
def test_uniforms_kernel_bit_equal_to_plain(cuda_device):
    check_uniforms(cuda_device)


@pytest.mark.cuda
def test_beta_kernel_matches_plain(cuda_device):
    check_beta(cuda_device)


@pytest.mark.cuda
def test_philox_matches_curand(cuda_device):
    check_philox_curand(cuda_device)


@pytest.mark.cuda
def test_draw_wrappers_reject_bad_inputs(cuda_device):
    keys, i = random_keys(2, device=cuda_device), sweep(0, cuda_device)
    a = torch.ones(2, device=cuda_device)
    with pytest.raises(TypeError):
        cuda_draws.uniforms(keys.int(), i, 0, 10)
    with pytest.raises(ValueError):
        cuda_draws.uniforms(keys, i.cpu(), 0, 10)
    with pytest.raises(ValueError):
        cuda_draws.beta(keys, i, a[:1], a, Q_MIN, Q_MAX)
    with pytest.raises(ValueError):
        cuda_draws.uniforms(keys, torch.zeros(2, dtype=torch.int64, device=cuda_device), 0, 10)
