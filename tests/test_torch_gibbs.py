"""Port parity: collapsed Gibbs sampling (``refinement/gibbs.py``) and the
count-from-responsibilities op (``ops/cuda_counts.py``) against the JAX
package, on numpy-seeded inputs at small sizes.

The deterministic path (z = argmax, q fixed) is compared with the reference
sweep for sweep; sampled chains cannot reproduce ``jax.random`` streams, so
they are held to their own invariants (stacked = solo, independent of
appended empty rows, independent across groups) and to their
distributions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import stats

from bammmotif2_tpu.models import background as jbackground
from bammmotif2_tpu.models import seeds as jseeds
from bammmotif2_tpu.ops import encode as jencode
from bammmotif2_tpu.ops import escore as jescore
from bammmotif2_tpu.ops import pallas_em
from bammmotif2_tpu.refinement import em as jem
from bammmotif2_tpu.refinement import gibbs as jgibbs
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu_torch import convert
from bammmotif2_tpu_torch.models.motif import log_odds_lut
from bammmotif2_tpu_torch.ops import cuda_counts, cuda_scores
from bammmotif2_tpu_torch.ops.escore import NEG_INF
from bammmotif2_tpu_torch.refinement import gibbs

from tests.test_em import planted_set
from tests.test_pallas_em import _setup

torch.set_num_threads(1)

MOTIF = "TGACTCAG"
# every row's argmax must win by this much in the deterministic parity
# tests: the port's LUTs come from torch.log and the reference's from XLA's
# log, an ulp apart, so a closer race could be won by different windows
ARGMAX_MARGIN = 1e-3


def _responsibilities(mask_np, S, M, rng, fractional):
    """r [M, S, N, n_win] shaped like the sampler's (0/1, at most one window
    per (m, n)) or like a posterior (fractional, summing to <= 1 per (m, n)),
    zero on invalid windows."""
    N, n_win = mask_np.shape
    r = np.zeros((M, S, N, n_win), np.float32)
    for m in range(M):
        for n in range(N):
            valid = np.nonzero(mask_np[n])[0]
            if not len(valid) or rng.random() >= 0.8:
                continue
            if fractional:
                w = rng.random((S, len(valid)))
                r[m, :, n, valid] = (rng.random() * w / w.sum()).T
            else:
                r[m, rng.integers(0, S), n, rng.choice(valid)] = 1.0
    return r


@pytest.mark.parametrize("fractional", [False, True], ids=["01", "fractional"])
@pytest.mark.parametrize("K,W,M", [(0, 8, 3), (2, 8, 3), (4, 6, 2)])
def test_counts_from_r_matches_jax(K, W, M, fractional):
    """(a) The plain version the CPU path takes, against the Pallas kernel
    in interpret mode and escore.mstep_counts, atol 1e-5 (the JAX suite's
    bar for this kernel)."""
    _v, data, _motif = _setup(K, W)
    cidx, lens = data["cidx"], data["lens"]
    S, N, L = cidx.shape
    n_win = L - W + 1
    R = jencode.num_rows(4, K)
    mask = np.asarray(jescore.window_mask(lens, n_win, W))
    r = _responsibilities(mask, S, M, np.random.default_rng(2), fractional)
    r_msnl = np.pad(r, ((0, 0), (0, 0), (0, 0), (0, L - n_win)))
    C = cuda_counts.counts_from_r_multi(torch.from_numpy(r_msnl), convert.indices(cidx, "cpu"), R, W)
    assert C.shape == (M, R + 1, W) and C.dtype == torch.float32
    C_pal = pallas_em.counts_from_r_multi(jnp.asarray(r_msnl), cidx, A=4, K=K, W=W, R=R,
                                          interpret=True)
    np.testing.assert_allclose(C.numpy(), np.asarray(C_pal), atol=1e-5)
    for m in range(M):
        C_ref = jescore.mstep_counts(jnp.asarray(r[m]), cidx, R, W)
        np.testing.assert_allclose(C[m].numpy(), np.asarray(C_ref), atol=1e-5)
    one = cuda_counts.counts_from_r(torch.from_numpy(r_msnl[0]), convert.indices(cidx, "cpu"), R, W)
    assert torch.equal(one, C[0])


def test_counts_from_r_keeps_mass_on_invalid_windows():
    """No lens in the contract: mass past a row's end lands in the row cidx
    holds there (the sentinel), and columns past L-W+1 are never read."""
    cidx = torch.tensor([[[0, 1, 2, 3, 3]]], dtype=torch.int32)  # R = 3: position 4 is padding
    r = torch.tensor([[[[0.5, 0.0, 0.25, 7.0, 9.0]]]])  # windows 0..2 of W=3 are read
    C = cuda_counts.counts_from_r_multi(r, cidx, 3, 3)
    want = torch.zeros((1, 4, 3))
    for i, ri in enumerate([0.5, 0.0, 0.25]):
        for j in range(3):
            want[0, cidx[0, 0, i + j], j] += ri
    assert torch.equal(C, want)
    assert C[0, 3].sum() == 0.25 * 2  # window 2 covers the padding at j = 1, 2


@pytest.mark.parametrize("K", [0, 1, 2, 3])
def test_log_alpha_posterior_matches_jax(K):
    """(b) Value and gradient against jax.grad, rtol 1e-5, both in float64:
    in float32 the gradient (digamma terms summed over A^(k+1) k-mers)
    cancels, and either package's float32 gradient lies up to 1e-3 of its
    scale from the float64 one at K=3 (measured), which no parity bar
    can hold.  The float32 value agrees to rtol 1e-5 as well."""
    rng = np.random.default_rng(K)
    W, A = 6, 4
    counts = [np.floor(rng.exponential(8.0, (A ** (k + 1), W))) * (rng.random((A ** (k + 1), W)) < 0.6)
              for k in range(K + 1)]
    la = np.log(rng.uniform(0.5, 30.0, (K + 1, W)))
    da = rng.uniform(0.5, 30.0, (K + 1, W))
    f_bg = np.array([0.3, 0.2, 0.2, 0.3])
    with jax.enable_x64(True):
        jval, jgrad = jax.value_and_grad(jgibbs._log_alpha_posterior)(
            jnp.asarray(la), tuple(jnp.asarray(c) for c in counts), jnp.asarray(f_bg), jnp.asarray(da))
        jval, jgrad = float(jval), np.asarray(jgrad)
    assert jgrad.dtype == np.float64
    t = torch.tensor(la, requires_grad=True)
    val = gibbs._log_alpha_posterior(t, tuple(torch.tensor(c) for c in counts), torch.tensor(f_bg),
                                     torch.tensor(da))
    (grad,) = torch.autograd.grad(val, t)
    assert val.item() == pytest.approx(jval, rel=1e-5)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-5)
    val32 = gibbs._log_alpha_posterior(
        torch.tensor(la, dtype=torch.float32), tuple(torch.tensor(c, dtype=torch.float32) for c in counts),
        torch.tensor(f_bg, dtype=torch.float32), torch.tensor(da, dtype=torch.float32))
    jval32 = jgibbs._log_alpha_posterior(
        jnp.asarray(la, jnp.float32), tuple(jnp.asarray(c, jnp.float32) for c in counts),
        jnp.asarray(f_bg, jnp.float32), jnp.asarray(da, jnp.float32))
    assert float(val32) == pytest.approx(float(jval32), rel=1e-5)


@pytest.fixture(scope="module")
def small():
    """A small planted set (every row's argmax wins by ARGMAX_MARGIN for the
    sweeps the deterministic tests run; they assert it) with both packages'
    background and three seeds."""
    sset = planted_set(n=80, l=60, motif=MOTIF, q=0.8, noise=0.1, seed=3)
    jbg = jbackground.BackgroundModel.from_sequence_set(sset, order=2)
    seeds = [jseeds.motif_from_pwm(jseeds.iupac_to_pwm(s, soft=soft), K=2, f_bg=sset.base_frequencies())
             for s, soft in ((MOTIF, 0.6), (MOTIF, 0.75), ("TGASTCAG", 0.6))]
    return sset, jbg, convert.background(jbg), seeds


def _margin(v, q, data) -> float:
    """The smallest gap between a row's best and second-best logit, for the
    port's state v [M, ...], q [M]."""
    sc, mk = cuda_scores.window_scores_multi_ref(log_odds_lut(v, data["bg_flat"]), data["cidx"],
                                                 data["lens"])
    top = gibbs.flat_logits(sc, mk, q).topk(2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


def _assert_step_parity(out, jout):
    """counts and n_occ equal; v atol 1e-5; alpha rtol 1e-4; ll rtol 1e-5."""
    v, q, la, ll, n_occ, counts = out
    jv, jq, jla, _key, jll, jn_occ, jcounts = jout
    for c, jc in zip(counts, jcounts):
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(n_occ.numpy(), np.asarray(jn_occ, np.float32))
    for a, b in zip(v, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(torch.exp(la).numpy(), np.exp(np.asarray(jla)), rtol=1e-4)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=1e-5)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("sweeps", [1, 5])
@pytest.mark.parametrize("learn_alpha", [True, False], ids=["alpha", "no_alpha"])
@pytest.mark.parametrize("stacked", [False, True], ids=["gibbs_step", "gibbs_step_multi"])
def test_deterministic_sweeps_match_jax(small, stacked, learn_alpha, sweeps):
    """(c) z = argmax, q fixed: sweep for sweep against the reference's
    gather path, with every row's argmax margin asserted first."""
    sset, jbg, _bg, seeds = small
    seeds = seeds if stacked else seeds[:1]
    M, K, W = len(seeds), 2, 8
    jdata = jem.prepare_data(sset, jbg, K, False)
    data = convert.em_data(jdata["cidx"], jdata["lens"], jdata["bg_flat"], "cpu")
    states = [convert.cgs_state(m, 0.5, "cpu") for m in seeds]
    v = tuple(torch.stack([s[0][k] for s in states]) for k in range(K + 1))
    q = torch.stack([s[1] for s in states])
    la, da = torch.stack([s[2] for s in states]), torch.stack([s[3] for s in states])
    f_bg = states[0][4]
    jv = tuple(jnp.asarray(vk.numpy()) for vk in v)
    jq, jla, jda = jnp.asarray(q.numpy()), jnp.asarray(la.numpy()), jnp.asarray(da.numpy())
    kw = dict(A=4, K=K, W=W, sample_z=False, sample_q=False, learn_alpha=learn_alpha)
    gens = gibbs.chain_generators(0, range(M), "cpu")
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(M)])
    for _ in range(sweeps):
        assert _margin(v, q, data) > ARGMAX_MARGIN
        if stacked:
            out = gibbs.gibbs_step_multi(v, q, la, gens, data, f_bg, da, float(sset.n), **kw)
            jout = jgibbs.gibbs_step_multi(jv, jq, jla, keys, jdata, jnp.asarray(f_bg.numpy()), jda,
                                           jnp.float32(sset.n), path="gather", **kw)
        else:
            out = gibbs.gibbs_step(tuple(vk[0] for vk in v), q[0], la[0], gens[0], data, f_bg, da[0],
                                   float(sset.n), **kw)
            jout = jgibbs.gibbs_step(tuple(vk[0] for vk in jv), jq[0], jla[0], keys[0], jdata,
                                     jnp.asarray(f_bg.numpy()), jda[0], jnp.float32(sset.n),
                                     path="gather", **kw)
            out = (tuple(x[None] for x in out[0]), out[1][None], out[2][None], out[3][None],
                   out[4][None], tuple(c[None] for c in out[5]))
            jout = (tuple(x[None] for x in jout[0]), jout[1][None], jout[2][None], None,
                    jout[4][None], jout[5][None], tuple(c[None] for c in jout[6]))
        _assert_step_parity(out, jout)
        v, q, la = out[0], out[1], out[2]
        jv, jq, jla = jout[0], jout[1], jout[2]
        if not learn_alpha:
            assert torch.equal(la, torch.log(da))


@pytest.mark.parametrize("burn_in", [0, 3])
def test_run_gibbs_deterministic_matches_jax(small, burn_in):
    """(d) run_gibbs under --noZSampling --noQSampling, with and without
    --cgsBurnIn, against the reference's run_gibbs: v atol 1e-5, alpha
    rtol 1e-4, the ll history rtol 1e-5.  The margins of the run's sweeps
    are asserted on the port's own trajectory first."""
    sset, jbg, bg, seeds = small
    params = Params(CGS=True, q=0.5, maxCGSIterations=6, cgsBurnIn=burn_in, noZSampling=True,
                    noQSampling=True)
    jdata = jem.prepare_data(sset, jbg, 2, False)
    data = convert.em_data(jdata["cidx"], jdata["lens"], jdata["bg_flat"], "cpu")
    v, q, la, da, f_bg = convert.cgs_state(seeds[0], params.q, "cpu")
    v, q, la, da = tuple(vk[None] for vk in v), q.reshape(1), la[None], da[None]
    for _ in range(params.maxCGSIterations):
        assert _margin(v, q, data) > ARGMAX_MARGIN
        v, q, la, *_rest = gibbs.gibbs_step_multi(v, q, la, [None], data, f_bg, da, float(sset.n),
                                                  A=4, K=2, W=8, sample_z=False, sample_q=False,
                                                  learn_alpha=True)
    jm, m = seeds[0].copy(), convert.motif(seeds[0])
    jres = jgibbs.run_gibbs(jm, jbg, sset, params)
    res = gibbs.run_gibbs(m, bg, sset, params)
    assert res.iterations == jres.iterations == params.maxCGSIterations
    for a, b in zip(m.v, jm.v):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(m.alphas, jm.alphas, rtol=1e-4)
    np.testing.assert_allclose(res.ll_history, jres.ll_history, rtol=1e-5)
    assert res.q == jres.q == params.q


def test_stacked_member_equals_solo_run(small):
    """(e) Sampling on: member i of run_gibbs_multi is run_gibbs(...,
    index=i), bit for bit."""
    sset, _jbg, bg, seeds = small
    params = Params(CGS=True, q=0.5, maxCGSIterations=5, seed=9)
    stacked = [convert.motif(m) for m in seeds]
    res = gibbs.run_gibbs_multi(stacked, bg, sset, params)
    assert res[0].group_seconds > 0
    for i, m in enumerate(seeds):
        solo = convert.motif(m)
        r = gibbs.run_gibbs(solo, bg, sset, params, index=i)
        for a, b in zip(solo.v, stacked[i].v):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(solo.alphas, stacked[i].alphas)
        assert r.q == res[i].q and r.ll_history == res[i].ll_history
        assert r.group_seconds == 0.0


def test_appended_empty_rows_keep_the_draws(small):
    """(f) Zero-length rows appended after the real ones change neither the
    real rows' z nor the sweep's counts, n_occ and ll (with n_real the real
    row count).  The draws come from the chain's generator one uniform per
    row in row order, so a real row's uniform does not depend on what
    follows it."""
    sset, jbg, _bg, seeds = small
    jdata = jem.prepare_data(sset, jbg, 2, False)
    data = convert.em_data(jdata["cidx"], jdata["lens"], jdata["bg_flat"], "cpu")
    extra = 7
    cidx = data["cidx"]
    pad = torch.full((cidx.shape[0], extra, cidx.shape[2]), int(cidx.max()), dtype=torch.int32)
    padded = {**data, "cidx": torch.cat([cidx, pad], dim=1),
              "lens": torch.cat([data["lens"], torch.zeros(extra, dtype=torch.int32)])}
    v, q, la, da, f_bg = convert.cgs_state(seeds[0], 0.5, "cpu")
    v, q, la, da = tuple(vk[None] for vk in v), q.reshape(1), la[None], da[None]
    z = []
    for d in (data, padded):
        sc, mk = cuda_scores.window_scores_multi_ref(log_odds_lut(v, d["bg_flat"]), d["cidx"], d["lens"])
        z.append(gibbs.draw_z(gibbs.flat_logits(sc, mk, q), gibbs.chain_generators(4, [0], "cpu"),
                              True))
    N = sset.n
    assert torch.equal(z[1][:, :N], z[0]) and (z[1][:, N:] == 0).all()
    kw = dict(A=4, K=2, W=8, sample_z=True, sample_q=True, learn_alpha=True)
    out = [gibbs.gibbs_step_multi(v, q, la, gibbs.chain_generators(4, [0], "cpu"), d, f_bg, da,
                                  float(N), **kw) for d in (data, padded)]
    for c0, c1 in zip(out[0][5], out[1][5]):
        assert torch.equal(c0, c1)
    assert torch.equal(out[0][4], out[1][4])
    np.testing.assert_allclose(out[0][3].numpy(), out[1][3].numpy(), rtol=1e-6)


def test_q_is_the_beta_draw_after_z(small):
    """Sampling on: a sweep's q is Beta(n_occ + 1, n_real - n_occ + 1) as
    X / (X + Y) of two gamma draws taken from the chain's generator right
    after the N z uniforms, clipped to [1e-4, 1 - 1e-4]."""
    sset, jbg, _bg, seeds = small
    jdata = jem.prepare_data(sset, jbg, 2, False)
    data = convert.em_data(jdata["cidx"], jdata["lens"], jdata["bg_flat"], "cpu")
    v, q, la, da, f_bg = convert.cgs_state(seeds[0], 0.5, "cpu")
    g = gibbs.chain_generators(5, [0], "cpu")[0]
    state = g.get_state()
    n_real = sset.n - 3.0
    out = gibbs.gibbs_step_multi(tuple(vk[None] for vk in v), q.reshape(1), la[None], [g], data,
                                 f_bg, da[None], n_real, A=4, K=2, W=8, sample_z=True,
                                 sample_q=True, learn_alpha=True)
    n_occ = out[4]
    assert 0 < float(n_occ) < sset.n
    g2 = torch.Generator().set_state(state)
    torch.rand(sset.n, generator=g2)
    x = torch._standard_gamma(n_occ + 1.0, generator=g2)
    y = torch._standard_gamma(n_real - n_occ + 1.0, generator=g2)
    assert torch.equal(out[1], (x / (x + y)).clamp(1e-4, 1 - 1e-4))


def test_z_draws_follow_the_softmax():
    """(g) 6,000 rows of one logit vector: z frequencies against the
    softmax by chi-square (p > 1e-3, a fixed seed), and a column of
    probability 0 (NEG_INF) never drawn."""
    logits = torch.tensor([np.log(0.2), 0.3, NEG_INF, -1.0, 1.2, NEG_INF - 5.0, 0.0])
    n = 6000
    flat = logits.expand(1, n, -1).contiguous()
    z = gibbs.draw_z(flat, gibbs.chain_generators(1, [0], "cpu"), True)[0]
    p = torch.softmax(logits.double(), dim=0).numpy()
    obs = np.bincount(z.numpy(), minlength=p.size)
    assert obs[p == 0].sum() == 0
    keep = p > 0
    _chi2, pval = stats.chisquare(obs[keep], n * p[keep] / p[keep].sum())
    assert pval > 1e-3, (obs, n * p)
    assert torch.equal(gibbs.draw_z(flat, [None], False), torch.full((1, n), 4))


def test_q_draws_follow_the_beta():
    """(g) 4,000 draws of Beta(30, 12) through the chain's generator: the
    mean and the variance within 4 standard errors of the Beta's."""
    a, b = torch.tensor([30.0]), torch.tensor([12.0])
    g = gibbs.chain_generators(2, [0], "cpu")
    x = torch.cat([gibbs.draw_beta(a, b, g) for _ in range(4000)]).double().numpy()
    n = x.size
    mean = 30 / 42
    var = 30 * 12 / (42 ** 2 * 43)
    assert abs(x.mean() - mean) < 4 * np.sqrt(var / n)
    dev2 = (x - x.mean()) ** 2
    assert abs(dev2.mean() - var) < 4 * dev2.std() / np.sqrt(n)


def test_chains_of_two_groups_differ(small):
    """(h) The m-th members of two (W, K) groups are independent chains:
    member i reproduces run_gibbs(..., index=i), and the group-local index
    (0) does not."""
    sset, _jbg, bg, _seeds = small
    params = Params(CGS=True, q=0.5, maxCGSIterations=5, seed=11)

    def mk(s):
        return convert.motif(jseeds.motif_from_pwm(jseeds.iupac_to_pwm(s, soft=0.6), K=2,
                                                   f_bg=sset.base_frequencies()))

    m8, m6 = mk("TGACTCAG"), mk("TGACTC")  # two (W, K) groups
    gibbs.run_gibbs_multi([m8, m6], bg, sset, params)
    solo6 = mk("TGACTC")
    gibbs.run_gibbs(solo6, bg, sset, params, index=1)
    for a, b in zip(m6.v, solo6.v):
        np.testing.assert_array_equal(a, b)
    local6 = mk("TGACTC")
    gibbs.run_gibbs(local6, bg, sset, params, index=0)
    assert not all(np.allclose(a, b, atol=1e-6) for a, b in zip(m6.v, local6.v))
    assert gibbs.chain_seed(11, 0) != gibbs.chain_seed(11, 1) != gibbs.chain_seed(12, 1)


def test_sampled_cgs_on_the_planted_set():
    """(i) tests/test_gibbs.py's planted set and seed (300 x 100 bp, 80%
    planted): the sampled chain recovers the consensus, alphas stay positive
    and change, rows are normalised, and the final q lies within 0.15 of
    the reference's.  Both q are single draws of Beta(n_occ + 1, N - n_occ
    + 1) with n_occ near 0.8 N: sd ~ 0.023 each, so their difference has sd
    ~ 0.033 and 0.15 is 4.5 of it."""
    sset = planted_set(n=300, l=100, motif=MOTIF, q=0.8, noise=0.1)
    jbg = jbackground.BackgroundModel.from_sequence_set(sset, order=2)
    seed = jseeds.motif_from_pwm(jseeds.iupac_to_pwm(MOTIF, soft=0.6), K=2, f_bg=sset.base_frequencies())
    params = Params(CGS=True, q=0.5, maxCGSIterations=30, seed=0)
    m = convert.motif(seed)
    res = gibbs.run_gibbs(m, convert.background(jbg), sset, params)
    assert "".join("ACGT"[i] for i in m.v[0].argmax(axis=0)) == MOTIF
    assert np.all(m.alphas > 0) and not np.allclose(m.alphas, seed.alphas)
    for k, vk in enumerate(m.v):
        np.testing.assert_allclose(vk.reshape(-1, 4, m.W).sum(axis=1), 1.0, atol=1e-4, err_msg=f"order {k}")
    ll = np.array(res.ll_history)
    assert np.isfinite(ll).all() and ll[-5:].mean() > ll[:5].mean()
    jres = jgibbs.run_gibbs(seed.copy(), jbg, sset, params)
    assert abs(res.q - jres.q) < 0.15, (res.q, jres.q)
