"""The port's copy of the reference's random streams (``ops/threefry.py``)
against ``jax.random`` on the CPU: keys, splits, bits and uniforms bit for
bit; XLA's float32 log, log1p and erf_inv bit for bit (the bar is 1 ulp);
categorical draws equal; beta draws within rtol 1e-5 (their last step is
an ``exp``, torch's against XLA's); and the exact fused multiply-add the
float functions rest on.

Run: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_threefry.py -q``.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bammmotif2_tpu_torch.ops import threefry

torch.set_num_threads(1)

BETA_RTOL = 1e-5
# (a, b) = (n_occ + 1, n_real - n_occ + 1) as CGS makes them: no row
# occupied, one, a few, most, all of 10^4 rows
BETA_SHAPES = [(1.0, 10_001.0), (2.0, 10_000.0), (37.0, 9_965.0), (8_001.0, 2_001.0),
               (10_001.0, 1.0), (1.0, 1.0)]


def jax_key(seed: int = 42):
    return jax.random.PRNGKey(seed)


def port_key(key) -> torch.Tensor:
    return threefry.from_jax_key(np.asarray(key))


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 steps (equal NaNs count 0)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2 ** 31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2 ** 31) - ib, ib)
    return np.where(np.isnan(a) & np.isnan(b), 0, np.abs(ia - ib))


def test_threefry_is_partitionable():
    """The streams copied are those of partitionable Threefry, jax 0.9's
    default."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_prng_key_matches_jax(seed):
    assert threefry.prng_key(seed).tolist() == np.asarray(jax_key(seed)).tolist()


@pytest.mark.parametrize("seed", [0, 7])
def test_split_matches_jax(seed):
    """split(key, n) for n = 1 .. 300, and split of a batch of keys."""
    k, pk = jax_key(seed), port_key(jax_key(seed))
    for n in range(1, 301):
        np.testing.assert_array_equal(threefry.split(pk, n).numpy(), np.asarray(jax.random.split(k, n)))
    ks = jax.random.split(k, 5)
    want = np.stack([np.asarray(jax.random.split(x, 3)) for x in ks])
    np.testing.assert_array_equal(threefry.split(port_key(ks), 3).numpy(), want)


def test_fold_in_matches_jax():
    k, pk = jax_key(), port_key(jax_key())
    data = [0, 1, 2, 99, 12_345, 2 ** 31 - 1, 2 ** 32 - 1]
    want = np.stack([np.asarray(jax.random.fold_in(k, d)) for d in data])
    np.testing.assert_array_equal(threefry.fold_in(pk[None], torch.tensor(data)).numpy(), want)
    np.testing.assert_array_equal(threefry.fold_in(pk, 5).numpy(), np.asarray(jax.random.fold_in(k, 5)))


@pytest.mark.parametrize("shape", [(), (7,), (1_000, 3), (40, 5, 9)])
def test_random_bits_match_jax(shape):
    np.testing.assert_array_equal(threefry.random_bits(port_key(jax_key(3)), shape).numpy(),
                                  np.asarray(jax.random.bits(jax_key(3), shape)).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                                   (threefry.NORMAL_LO, 1.0)])
def test_uniform_matches_jax(lo, hi):
    got = threefry.uniform(port_key(jax_key(4)), (100_000,), lo, hi).numpy()
    want = np.asarray(jax.random.uniform(jax_key(4), (100_000,), minval=lo, maxval=hi))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["log", "log1p"])
def test_xla_log_matches_jax(fn):
    """XLA's CPU log and log1p, bit for bit on 10^6 inputs spanning float32,
    the special values included."""
    rng = np.random.default_rng(0)
    if fn == "log":
        x = np.exp(rng.uniform(-87, 88, 1_000_000)).astype(np.float32)
        x = np.concatenate([x, np.float32([0.0, -0.0, 1e-40, -1.0, np.inf, np.nan, 1.0])])
        got, want = threefry.xla_log(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(jnp.log)(x))
    else:
        x = rng.uniform(-1, 3, 1_000_000).astype(np.float32)
        x = np.concatenate([x, np.float32([0.0, -1.0, 1e-8, -0.41421357, 0.41421357])])
        got, want = threefry.xla_log1p(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(jnp.log1p)(x))
    assert ulps(got, want).max() == 0


def test_erf_inv_within_one_ulp_of_jax():
    """XLA's float32 erf_inv on 10^6 uniforms of (-1, 1) and the ends."""
    x = np.asarray(jax.random.uniform(jax_key(5), (1_000_000,), minval=-1.0, maxval=1.0))
    x = np.concatenate([x, np.float32([-1.0, 1.0, 0.0, 0.9999999, -0.99999994])])
    got = threefry.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    assert ulps(got, want).max() <= 1


@pytest.mark.parametrize("sampler", ["normal", "gumbel"])
def test_float_draws_within_one_ulp_of_jax(sampler):
    got = getattr(threefry, sampler)(port_key(jax_key(6)), (200_000,)).numpy()
    want = np.asarray(getattr(jax.random, sampler)(jax_key(6), (200_000,)))
    assert ulps(got, want).max() <= 1


@pytest.mark.parametrize("N,A,scale", [(20_000, 4, 1.0), (2_000, 379, 3.0)])
def test_categorical_matches_jax(N, A, scale):
    """[N, A] logits (a tenth of the columns -inf): equal draws on at least
    99.99% of rows."""
    rng = np.random.default_rng(A)
    logits = (scale * rng.normal(size=(N, A))).astype(np.float32)
    logits[rng.random((N, A)) < 0.1] = -np.inf
    logits[:, 0] = 0.0
    got = threefry.categorical(port_key(jax_key(8)), torch.from_numpy(logits)).numpy()
    want = np.asarray(jax.random.categorical(jax_key(8), logits, axis=-1))
    assert (got == want).mean() >= 0.9999


@pytest.mark.parametrize("a", [1.0, 1.5, 37.0, 2_000.0, 10_001.0])
def test_loggamma_matches_jax(a):
    """_gamma_one in log space with its key splits: equal on 500 keys."""
    keys = jax.random.split(jax_key(9), 500)
    want = np.asarray(jax.vmap(lambda k: jax.random.loggamma(k, jnp.float32(a)))(keys))
    got, attempts = threefry.loggamma(port_key(keys), torch.full((500,), a))
    assert ulps(got.numpy(), want).max() == 0
    assert int(attempts.min()) >= 1


@pytest.mark.parametrize("a,b", BETA_SHAPES)
def test_beta_matches_jax(a, b):
    """jax.random.beta of 500 keys at the shapes CGS makes, within rtol
    1e-5 (the loggammas are equal; exp differs by an ulp at most)."""
    keys = jax.random.split(jax_key(10), 500)
    want = np.asarray(jax.vmap(lambda k: jax.random.beta(k, jnp.float32(a), jnp.float32(b)))(keys))
    got = threefry.beta(port_key(keys), torch.full((500,), a), torch.full((500,), b)).numpy()
    np.testing.assert_allclose(got, want, rtol=BETA_RTOL)


def test_beta_rejects_shapes_below_one():
    with pytest.raises(ValueError, match=">= 1"):
        threefry.beta(threefry.split(threefry.prng_key(0), 2), torch.tensor([0.5, 2.0]),
                      torch.tensor([3.0, 1.0]))


def test_fma32_rounds_once():
    """fma32 = the exact a * b + c rounded once to float32, on random inputs
    and on a sum whose float64 rounding lands on a float32 tie (where two
    roundings would err)."""
    rng = np.random.default_rng(11)
    a, b, c = (rng.normal(size=200_000).astype(np.float32) for _ in range(3))
    got = threefry.fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in rng.integers(0, a.size, 2_000):
        exact = fractions.Fraction(float(a[i])) * fractions.Fraction(float(b[i])) + \
            fractions.Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # the float32 nearest the exact value (ties to even)
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda f: (abs(fractions.Fraction(float(f)) - exact),
                                         int(np.float32(f).view(np.int32)) & 1))
        assert got[i] == best, (a[i], b[i], c[i])
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 is a float32 tie; + 2^-60 lifts it
    # above the tie, which float64 rounds away (ties to even would then give
    # 1 + 2^-11): once rounded it is 1 + 2^-11 + 2^-23
    x = torch.tensor([1.0 + 2.0 ** -12])
    for c, want in ((2.0 ** -60, 1.0 + 2.0 ** -11 + 2.0 ** -23), (0.0, 1.0 + 2.0 ** -11),
                    (-2.0 ** -60, 1.0 + 2.0 ** -11)):
        assert float(threefry.fma32(x, x, torch.tensor([c]))) == want, c


def test_from_jax_key_round_trips():
    keys = jax.random.split(jax_key(12), 4)
    pk = threefry.from_jax_key(np.asarray(keys))
    assert pk.dtype == torch.int64 and pk.shape == (4, 2)
    np.testing.assert_array_equal(pk.numpy().astype(np.uint32), np.asarray(keys))
