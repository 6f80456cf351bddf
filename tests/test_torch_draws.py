"""The sampled paths' draws (``ops/cuda_draws.py``): the plain versions'
invariants (a shard's rows, the key advance, chains and sweeps) and their
distributions, on the CPU; and, in the ``cuda`` lane, ``csrc/jax_draws.cu``
against the plain versions.

``chip_smoke.py`` runs the card's checks (``check_markov``, ``check_z``,
``check_beta``) at the main path's shapes.  The draws against
``jax.random``'s, draw for draw: tests/test_torch_threefry.py (the
streams), tests/test_torch_seqgen.py (the sampler) and
tests/test_torch_gibbs.py (CGS).  This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import stats

from bammmotif2_tpu_torch.ops import cuda_draws, threefry
from bammmotif2_tpu_torch.refinement import gibbs

torch.set_num_threads(1)

# Beta shapes of the KS tests: a = n_occ + 1, b = n_real - n_occ + 1 at the
# edges (no row occupied, one row) and in the middle of the sampler's range
BETA_SHAPES = [(1.0, 1.0), (2.0, 300.0), (30.0, 12.0), (8_001.0, 2_000.0)]
Q_MIN, Q_MAX = gibbs.Q_MIN, gibbs.Q_MAX
# the kernel's q against the plain version's where both took the same
# attempts (both round float64's exp; the bound leaves room for an ulp), and
# the share of draws whose attempts may differ
BETA_RTOL, BETA_FLIP_SHARE = 1e-6, 0.0


def random_keys(n: int, seed: int = 0, device="cpu") -> torch.Tensor:
    """n keys of random 32-bit words."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 2 ** 32, (n, 2)), dtype=torch.int64, device=device)


@pytest.mark.parametrize("row0,n", [(0, 37), (5, 20), (36, 1)])
def test_z_of_a_shard_is_the_whole_sets_rows(row0, n):
    """Rows row0 .. row0+n-1 drawn as a shard equal the same rows of the
    whole set: a row's key is fold_in(sub, global row)."""
    rng = np.random.default_rng(row0)
    flat = torch.as_tensor(rng.normal(size=(3, 40, 11)).astype(np.float32))
    keys = random_keys(3)
    whole = cuda_draws.cgs_z_ref(flat, keys, 0)
    assert torch.equal(cuda_draws.cgs_z_ref(flat[:, row0 : row0 + n].contiguous(), keys, row0),
                       whole[:, row0 : row0 + n])


def test_z_is_the_row_keys_categorical():
    """Row n's z is threefry.categorical of fold_in(split(key)[1], n) over
    its logits; cgs_z leaves the keys as they were."""
    rng = np.random.default_rng(1)
    flat = torch.as_tensor(rng.normal(size=(2, 9, 30)).astype(np.float32))
    keys = random_keys(2, seed=1)
    before = keys.clone()
    z = cuda_draws.cgs_z_ref(flat, keys, 4)
    assert torch.equal(keys, before)
    for m in range(2):
        sub = threefry.split(keys[m])[1]
        for n in range(9):
            want = threefry.categorical(threefry.fold_in(sub, 4 + n), flat[m, n])
            assert int(z[m, n]) == int(want)


@pytest.mark.parametrize("draw", [True, False], ids=["draw", "advance"])
def test_beta_advances_the_keys_by_two_splits(draw):
    """cgs_beta leaves each key at split(split(key)[0])[0], drawn or not,
    and draws q from split(split(key)[0])[1]."""
    keys = random_keys(4, seed=2)
    k1 = threefry.split(keys)[:, 0]
    want_keys, sub_q = threefry.split(k1).unbind(dim=1)
    a, b = torch.tensor([1.0, 5.0, 70.0, 2.0]), torch.tensor([3.0, 1.0, 40.0, 900.0])
    q = cuda_draws.cgs_beta_ref(a, b, keys, Q_MIN, Q_MAX, draw=draw)
    assert torch.equal(keys, want_keys)
    if draw:
        assert torch.equal(q, threefry.beta(sub_q, a, b).clamp(Q_MIN, Q_MAX))
    else:
        assert q is None


def test_sweeps_and_chains_differ():
    """Another sweep (the advanced keys), another chain, another row: other
    numbers; the same keys: the same numbers."""
    keys = gibbs.input_keys(3, [0, 1], "cpu")
    flat = torch.zeros((2, 500, 64))
    z0 = cuda_draws.cgs_z_ref(flat, keys)
    assert torch.equal(z0, cuda_draws.cgs_z_ref(flat, keys.clone()))
    a, b = torch.full((2,), 40.0), torch.full((2,), 60.0)
    q = [cuda_draws.cgs_beta_ref(a, b, keys, Q_MIN, Q_MAX) for _ in range(3)]
    z1 = cuda_draws.cgs_z_ref(flat, keys)
    assert (z0 != z1).float().mean() > 0.9
    assert (z0[0] != z0[1]).float().mean() > 0.9
    assert len(set(z0[0].tolist())) > 60
    assert q[0][0] != q[0][1] and q[0][0] != q[1][0] != q[2][0]
    assert gibbs.input_keys(3, [0], "cpu").tolist() != gibbs.input_keys(4, [0], "cpu").tolist()


@pytest.mark.parametrize("a,b", BETA_SHAPES)
def test_beta_follows_scipy_beta(a, b):
    """20,000 chains' draws against scipy.stats.beta by a Kolmogorov-Smirnov
    test (p > 1e-3, fixed keys); no gamma took more than a few attempts."""
    n = 20_000
    keys = random_keys(n, seed=2)
    q, attempts = cuda_draws.cgs_beta_ref(torch.full((n,), a), torch.full((n,), b), keys, Q_MIN,
                                          Q_MAX, attempts=True)
    pval = stats.kstest(q.double().numpy(), stats.beta(a, b).cdf).pvalue
    assert pval > 1e-3, pval
    assert int(attempts.max()) < 8


def test_gamma_attempts_follow_marsaglia_tsang():
    """Each gamma's log draw follows Gamma(shape) by a Kolmogorov-Smirnov
    test, and about 5% of first attempts are rejected at shape 1, far fewer
    at 100."""
    n = 20_000
    keys = random_keys(n, seed=3)
    for shape, most in ((1.0, 0.06), (100.0, 0.002)):
        lg, attempts = threefry.loggamma(keys, torch.full((n,), shape))
        assert (attempts >= 1).all() and torch.isfinite(lg).all()
        assert float((attempts > 1).double().mean()) < most
        pval = stats.kstest(np.exp(lg.double().numpy()), stats.gamma(shape).cdf).pvalue
        assert pval > 1e-3, (shape, pval)


def test_beta_rejects_shapes_below_one():
    keys = random_keys(2)
    with pytest.raises(ValueError, match=">= 1"):
        cuda_draws.cgs_beta_ref(torch.tensor([0.5, 2.0]), torch.tensor([3.0, 1.0]), keys, Q_MIN,
                                Q_MAX)


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
    z = gibbs.draw_z(flat, gibbs.input_keys(8, [0], "cpu"), True)[0].numpy()
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
    keys = random_keys(3, seed=6)
    a, b = torch.tensor([1.0, 5.0, 70.0]), torch.tensor([3.0, 1.0, 40.0])
    flat = torch.as_tensor(np.random.default_rng(6).normal(size=(3, 11, 7)).astype(np.float32))
    before = [f.launches for f in (cuda_draws.markov_codes, cuda_draws.cgs_z, cuda_draws.cgs_beta)]
    assert torch.equal(cuda_draws.cgs_z(flat, keys, 2), cuda_draws.cgs_z_ref(flat, keys, 2))
    k1, k2 = keys.clone(), keys.clone()
    q, n = cuda_draws.cgs_beta(a, b, k1, Q_MIN, Q_MAX, attempts=True)
    q_ref, n_ref = cuda_draws.cgs_beta_ref(a, b, k2, Q_MIN, Q_MAX, attempts=True)
    assert torch.equal(q, q_ref) and torch.equal(n, n_ref) and torch.equal(k1, k2)
    trans = (torch.full((4,), 0.25), torch.full((16,), 0.25))
    lens = torch.tensor([5, 0, 7], dtype=torch.int32)
    key = threefry.prng_key(1)
    assert torch.equal(cuda_draws.markov_codes(key, trans, lens, L=8, s_order=1, A=4),
                       cuda_draws.markov_codes_ref(key, trans, lens, L=8, s_order=1, A=4))
    assert [f.launches for f in (cuda_draws.markov_codes, cuda_draws.cgs_z,
                                 cuda_draws.cgs_beta)] == before


# ---- on the card ----

def _markov_inputs(device, N: int, L: int, s_order: int, seed: int):
    """Random conditionals of orders 0 .. s_order (some zero), lengths from
    0 to L, and a key."""
    rng = np.random.default_rng(seed)
    trans = []
    for m in range(s_order + 1):
        p = rng.random((4 ** m, 4)) ** 3
        p[rng.random(p.shape) < 0.05] = 0.0
        p[:, 0] += 1e-3
        trans.append(torch.as_tensor((p / p.sum(axis=1, keepdims=True)).ravel(), dtype=torch.float32,
                                     device=device))
    lens = torch.as_tensor(rng.integers(0, L + 1, N), dtype=torch.int32, device=device)
    return tuple(trans), lens, threefry.prng_key(seed, device)


MARKOV_CASES = [(4_096, 200, 0), (4_096, 200, 2), (1_000, 57, 3), (333, 40, 5)]


def check_markov(device, cases=MARKOV_CASES) -> dict:
    """markov_codes against markov_codes_ref on the card for each (N, L,
    s_order) of ``cases``: bit-equal, one launch a call.  Returns {"cases",
    "rows", "mismatched_codes", "launches"}."""
    bad, rows, before = 0, 0, cuda_draws.markov_codes.launches
    for i, (N, L, s) in enumerate(cases):
        trans, lens, key = _markov_inputs(device, N, L, s, i)
        got = cuda_draws.markov_codes(key, trans, lens, L=L, s_order=s, A=4)
        want = cuda_draws.markov_codes_ref(key, trans, lens, L=L, s_order=s, A=4)
        bad += int((got != want).sum())
        rows += N
    torch.cuda.synchronize(device)
    out = {"cases": len(cases), "rows": rows, "mismatched_codes": bad,
           "launches": cuda_draws.markov_codes.launches - before}
    assert bad == 0 and out["launches"] == len(cases), out
    return out


# check_z's cases: name -> (M, N, C, row0, logits); the 10k set at a 16-seed
# stack and bench's C (two row offsets), M=1 (the one chain's rows on the
# resident grid), C around a warp's 32 lanes, N not a multiple of a block's
# 8 rows, the last rows fold_in's 32 bits reach, and rows of special values
Z_CASES = {
    "M16_C379": (16, 10_000, 379, 0, "neg_inf_windows"),
    "M16_C379_row4096": (16, 10_000, 379, 4_096, "neg_inf_windows"),
    "M1_C379": (1, 10_000, 379, 0, "neg_inf_windows"),
    "M3_C1": (3, 1_003, 1, 0, "normal"),
    "M3_C31": (3, 1_003, 31, 17, "normal"),
    "M3_C33": (3, 1_003, 33, 0, "normal"),
    "M2_N10001_top_rows": (2, 10_001, 379, 2 ** 32 - 10_001, "neg_inf_windows"),
    "M4_special_rows": (4, 2_003, 379, 0, "special"),
}


def z_logits(M: int, N: int, C: int, kind: str, seed: int = 7) -> np.ndarray:
    """check_z's logits float32 [M, N, C]: normal(0, 2); with NEG_INF
    (-1e30) at every 7th column (``neg_inf_windows``); or (``special``)
    with rows all NEG_INF, rows all -inf, and rows with one or two NaNs,
    one or two +inf, and a NaN beside a +inf."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 2.0, (M, N, C)).astype(np.float32)
    if kind == "neg_inf_windows":
        x[:, :, 5::7] = -1e30
    elif kind == "special":
        nan, inf = np.float32("nan"), np.float32("inf")
        x[:, 0::11] = -1e30
        x[:, 1::11] = -inf
        x[:, 2::11, 200] = nan
        x[:, 3::11, 17] = nan
        x[:, 3::11, 300] = nan
        x[:, 4::11, 50] = inf
        x[:, 5::11, 9] = inf
        x[:, 5::11, 10] = inf
        x[:, 6::11, 301] = inf
        x[:, 6::11, 302] = nan
        x[:, 7::11, :] = x[:, 7::11, :1]  # all equal: the gumbel alone decides
    return x


def check_z(device, cases=Z_CASES) -> dict:
    """cgs_z against cgs_z_ref for each case of ``cases`` (M chains, N
    rows, C logits, rows from row0): bit-equal, one launch a call.
    Returns {"cases", "rows", "mismatches", "launches"}."""
    bad, rows, before = 0, 0, cuda_draws.cgs_z.launches
    for i, (M, N, C, row0, kind) in enumerate(cases.values()):
        flat = torch.as_tensor(z_logits(M, N, C, kind), device=device)
        keys = random_keys(M, seed=7 + i, device=device)
        got = cuda_draws.cgs_z(flat, keys, row0)
        want = cuda_draws.cgs_z_ref(flat, keys, row0)
        bad += int((got != want).sum())
        rows += M * N
        del flat
    torch.cuda.synchronize(device)
    out = {"cases": len(cases), "rows": rows, "mismatches": bad,
           "launches": cuda_draws.cgs_z.launches - before}
    assert bad == 0 and out["launches"] == len(cases), out
    return out


# check_beta's small shapes: (a, b, chains); at a = b = 1 about one attempt
# in twenty is rejected, so some gamma needs more attempts than the kernel
# has lanes for (cuda_draws.beta_spec_lanes()) and the next round runs
BETA_SMALL = ((1.0, 1.0, 200_000), (1.0, 2.0, 4_096), (2.0, 1.0, 1), (1.5, 3.0, 33))


def check_beta(device, n: int = 100_000, small=BETA_SMALL) -> dict:
    """cgs_beta against cgs_beta_ref on n (a, b) pairs (n chains, the keys
    then advanced and drawn again, then advanced without a draw; shapes
    from 1 to 10^4 + 1, a tenth of them below 4), and on the ``small``
    shapes' chains: the same attempts but for at most BETA_FLIP_SHARE of
    the draws, q within BETA_RTOL where they agree, and the same advanced
    keys; some gamma took more attempts than the kernel's lanes a gamma
    (cuda_draws.beta_spec_lanes()).
    Returns {"pairs", "flips", "max_rel_err", "max_abs_err",
    "max_attempts", "spec_lanes", "launches"}."""
    rng = np.random.default_rng(8)
    shapes = np.where(rng.random((2, n)) < 0.1, rng.integers(1, 4, (2, n)),
                      rng.integers(1, 10_002, (2, n))).astype(np.float32)
    cases = [(torch.as_tensor(shapes[0], device=device), torch.as_tensor(shapes[1], device=device),
              random_keys(n, seed=9, device=device), 2)]
    for i, (sa, sb, m) in enumerate(small):
        cases.append((torch.full((m,), sa, device=device), torch.full((m,), sb, device=device),
                      random_keys(m, seed=10 + i, device=device), 1))
    flips = pairs = top = calls = 0
    rel = err = 0.0
    before = cuda_draws.cgs_beta.launches
    for a, b, keys, draws in cases:
        ref_keys = keys.clone()
        for _ in range(draws):
            q, att = cuda_draws.cgs_beta(a, b, keys, Q_MIN, Q_MAX, attempts=True)
            q_ref, att_ref = cuda_draws.cgs_beta_ref(a, b, ref_keys, Q_MIN, Q_MAX, attempts=True)
            same = (att == att_ref).all(dim=1)
            flips += int((~same).sum())
            d = (q - q_ref).abs()[same]
            rel = max(rel, float((d / q_ref.abs()[same]).max()))
            err = max(err, float(d.max()))
            top = max(top, int(att.max()))
            pairs += a.shape[0]
            assert torch.equal(keys, ref_keys)
        # --noQSampling: the keys advance, nothing is drawn
        assert cuda_draws.cgs_beta(a, b, keys, Q_MIN, Q_MAX, draw=False) is None
        cuda_draws.cgs_beta_ref(a, b, ref_keys, Q_MIN, Q_MAX, draw=False)
        assert torch.equal(keys, ref_keys)
        calls += draws + 1
    torch.cuda.synchronize(device)
    out = {"pairs": pairs, "flips": flips, "max_rel_err": rel, "max_abs_err": err,
           "max_attempts": top, "spec_lanes": cuda_draws.beta_spec_lanes(),
           "launches": cuda_draws.cgs_beta.launches - before}
    assert flips <= BETA_FLIP_SHARE * pairs and rel <= BETA_RTOL and out["launches"] == calls, out
    assert top > out["spec_lanes"], out
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
def test_markov_kernel_bit_equal_to_plain(cuda_device):
    check_markov(cuda_device)


@pytest.mark.cuda
def test_z_kernel_bit_equal_to_plain(cuda_device):
    check_z(cuda_device)


@pytest.mark.cuda
def test_beta_kernel_matches_plain(cuda_device):
    check_beta(cuda_device)


@pytest.mark.cuda
def test_draw_wrappers_reject_bad_inputs(cuda_device):
    keys = random_keys(2, device=cuda_device)
    a = torch.ones(2, device=cuda_device)
    flat = torch.zeros((2, 3, 4), device=cuda_device)
    with pytest.raises(TypeError):
        cuda_draws.cgs_z(flat, keys.int())
    with pytest.raises(ValueError):
        cuda_draws.cgs_z(flat, keys[:1].contiguous())
    with pytest.raises(ValueError):
        cuda_draws.cgs_beta(a[:1], a, keys, Q_MIN, Q_MAX)
    with pytest.raises(ValueError):
        cuda_draws.markov_codes(keys[0].cpu(), (a,), torch.ones(2, dtype=torch.int32,
                                                                  device=cuda_device),
                                L=2, s_order=0, A=2)
