"""Port parity: collapsed Gibbs sampling (``refinement/gibbs.py``) and the
count-from-responsibilities op (``ops/cuda_counts.py``) against the JAX
package, on numpy-seeded inputs at small sizes.

The deterministic path (z = argmax, q fixed) is compared with the reference
sweep for sweep.  Sampled chains draw from the reference's own
``jax.random`` streams (``ops/threefry.py``), so they are compared with
the reference's sampled runs too, and held to their own invariants
(stacked = solo, independent of appended empty rows, independent across
groups) and to their distributions.
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
from bammmotif2_tpu_torch.ops import cuda_counts, cuda_draws, cuda_scores, threefry
from bammmotif2_tpu_torch.ops.escore import NEG_INF
from bammmotif2_tpu_torch.refinement import gibbs
from bammmotif2_tpu_torch.utils.config import Params as PParams

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
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(M)])
    pkeys = threefry.from_jax_key(np.asarray(keys))
    for _ in range(sweeps):
        assert _margin(v, q, data) > ARGMAX_MARGIN
        if stacked:
            out = gibbs.gibbs_step_multi(v, q, la, pkeys, data, f_bg, da, float(sset.n), **kw)
            jout = jgibbs.gibbs_step_multi(jv, jq, jla, keys, jdata, jnp.asarray(f_bg.numpy()), jda,
                                           jnp.float32(sset.n), path="gather", **kw)
        else:
            out = gibbs.gibbs_step(tuple(vk[0] for vk in v), q[0], la[0], pkeys[0], data, f_bg, da[0],
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
        v, q, la, *_rest = gibbs.gibbs_step_multi(v, q, la, None, data, f_bg, da, float(sset.n),
                                                  A=4, K=2, W=8, sample_z=False, sample_q=False,
                                                  learn_alpha=True)
    jm, m = seeds[0].copy(), convert.motif(seeds[0])
    jres = jgibbs.run_gibbs(jm, jbg, sset, params)
    res = gibbs.run_gibbs(m, bg, convert.sequence_set(sset), convert.params(params), device="cpu")
    assert res.iterations == jres.iterations == params.maxCGSIterations
    for a, b in zip(m.v, jm.v):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(m.alphas, jm.alphas, rtol=1e-4)
    np.testing.assert_allclose(res.ll_history, jres.ll_history, rtol=1e-5)
    assert res.q == jres.q == params.q


def test_stacked_member_equals_solo_run(small):
    """(e) Sampling on: member i of run_gibbs_multi is run_gibbs(...,
    key=fold_in(PRNGKey(seed), i)), bit for bit."""
    sset, _jbg, bg, seeds = small
    sset, params = convert.sequence_set(sset), PParams(CGS=True, q=0.5, maxCGSIterations=5, seed=9)
    stacked = [convert.motif(m) for m in seeds]
    res = gibbs.run_gibbs_multi(stacked, bg, sset, params, device="cpu")
    assert res[0].group_seconds > 0
    for i, m in enumerate(seeds):
        solo = convert.motif(m)
        r = gibbs.run_gibbs(solo, bg, sset, params, key=gibbs.input_keys(params.seed, [i], "cpu")[0],
                            device="cpu")
        for a, b in zip(solo.v, stacked[i].v):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(solo.alphas, stacked[i].alphas)
        assert r.q == res[i].q and r.ll_history == res[i].ll_history
        assert r.group_seconds == 0.0


@pytest.mark.parametrize("entry", ["run_gibbs", "multi_1", "multi_3"])
def test_sampled_runs_match_jax(small, entry):
    """Sampling on (z and q): the port draws the reference's chains, from
    PRNGKey(seed) (run_gibbs) or fold_in(PRNGKey(seed), i) (run_gibbs_multi,
    one seed and a stacked group of three): every sweep's ll within rtol
    1e-5, the final q equal, v within atol 1e-5 and alpha within rtol 1e-4.
    The two packages' logits agree to rounding, so their draws agree
    unless a row's two best gumbel-shifted logits lie that close."""
    sset, jbg, bg, seeds = small
    params = Params(CGS=True, q=0.5, maxCGSIterations=8, seed=3)
    n = 3 if entry == "multi_3" else 1
    jms, ms = [m.copy() for m in seeds[:n]], [convert.motif(m) for m in seeds[:n]]
    psset, pparams = convert.sequence_set(sset), convert.params(params)
    if entry == "run_gibbs":
        jres = [jgibbs.run_gibbs(jms[0], jbg, sset, params)]
        res = [gibbs.run_gibbs(ms[0], bg, psset, pparams, device="cpu")]
    else:
        jres = jgibbs.run_gibbs_multi(jms, jbg, sset, params)
        res = gibbs.run_gibbs_multi(ms, bg, psset, pparams, device="cpu")
    for r, jr, m, jm in zip(res, jres, ms, jms):
        np.testing.assert_allclose(r.ll_history, jr.ll_history, rtol=1e-5)
        assert r.q == jr.q
        for a, b in zip(m.v, jm.v):
            np.testing.assert_allclose(a, b, atol=1e-5)
        np.testing.assert_allclose(m.alphas, jm.alphas, rtol=1e-4)


def test_appended_empty_rows_keep_the_draws(small):
    """(f) Zero-length rows appended after the real ones change neither the
    real rows' z nor the sweep's counts, n_occ, ll and q (with n_real the
    real row count).  Each row's draw is keyed by its own index and the
    sweep's key, and q's by the sweep's key alone, so nothing depends on how
    many rows follow."""
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
    keys = gibbs.input_keys(4, [0], "cpu")
    z = []
    for d in (data, padded):
        sc, mk = cuda_scores.window_scores_multi_ref(log_odds_lut(v, d["bg_flat"]), d["cidx"], d["lens"])
        z.append(gibbs.draw_z(gibbs.flat_logits(sc, mk, q), keys, True))
    N = sset.n
    assert torch.equal(z[1][:, :N], z[0]) and (z[1][:, N:] == 0).all()
    kw = dict(A=4, K=2, W=8, sample_z=True, sample_q=True, learn_alpha=True)
    out = [gibbs.gibbs_step_multi(v, q, la, keys.clone(), d, f_bg, da, float(N), **kw)
           for d in (data, padded)]
    for c0, c1 in zip(out[0][5], out[1][5]):
        assert torch.equal(c0, c1)
    assert torch.equal(out[0][4], out[1][4]) and torch.equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][3].numpy(), out[1][3].numpy(), rtol=1e-6)


def test_q_is_the_beta_draw_after_z(small):
    """Sampling on: a sweep's q is Beta(n_occ + 1, n_real - n_occ + 1) of
    the z draws' n_occ, drawn from the chain's key after z's split
    (``ops.cuda_draws.cgs_beta``), clipped to [1e-4, 1 - 1e-4], and the
    sweep leaves the key split twice; z is drawn from the key the sweep
    began with."""
    sset, jbg, _bg, seeds = small
    jdata = jem.prepare_data(sset, jbg, 2, False)
    data = convert.em_data(jdata["cidx"], jdata["lens"], jdata["bg_flat"], "cpu")
    v, q, la, da, f_bg = convert.cgs_state(seeds[0], 0.5, "cpu")
    keys = gibbs.input_keys(5, [0], "cpu")
    n_real = sset.n - 3.0
    v1, q1, la1 = tuple(vk[None] for vk in v), q.reshape(1), la[None]
    carried = keys.clone()
    out = gibbs.gibbs_step_multi(v1, q1, la1, carried, data, f_bg, da[None], n_real, A=4, K=2,
                                 W=8, sample_z=True, sample_q=True, learn_alpha=True)
    n_occ = out[4]
    assert 0 < float(n_occ) < sset.n
    advanced = keys.clone()
    want = cuda_draws.cgs_beta_ref(n_occ + 1.0, n_real - n_occ + 1.0, advanced, 1e-4, 1 - 1e-4)
    assert torch.equal(out[1], want) and torch.equal(carried, advanced)
    sc, mk = cuda_scores.window_scores_multi_ref(log_odds_lut(v1, data["bg_flat"]), data["cidx"],
                                                 data["lens"])
    z = gibbs.draw_z(gibbs.flat_logits(sc, mk, q1), keys, True)
    assert torch.equal(n_occ, (z > 0).sum(dim=1).to(torch.float32))


def test_z_draws_follow_the_softmax():
    """(g) 6,000 rows of one logit vector: z frequencies against the
    softmax by chi-square (p > 1e-3, a fixed seed), and a column of
    probability 0 (NEG_INF) never drawn."""
    logits = torch.tensor([np.log(0.2), 0.3, NEG_INF, -1.0, 1.2, NEG_INF - 5.0, 0.0])
    n = 6000
    flat = logits.expand(1, n, -1).contiguous()
    z = gibbs.draw_z(flat, gibbs.input_keys(1, [0], "cpu"), True)[0]
    p = torch.softmax(logits.double(), dim=0).numpy()
    obs = np.bincount(z.numpy(), minlength=p.size)
    assert obs[p == 0].sum() == 0
    keep = p > 0
    _chi2, pval = stats.chisquare(obs[keep], n * p[keep] / p[keep].sum())
    assert pval > 1e-3, (obs, n * p)
    assert torch.equal(gibbs.draw_z(flat, None, False), torch.full((1, n), 4))


def test_q_draws_follow_the_beta():
    """(g) 4,000 draws of Beta(30, 12), 400 chains over 10 sweeps: the mean
    and the variance within 4 standard errors of the Beta's."""
    a, b = torch.full((400,), 30.0), torch.full((400,), 12.0)
    keys = gibbs.input_keys(2, range(400), "cpu")
    x = torch.cat([gibbs.draw_beta(a, b, keys, True) for _ in range(10)]).double().numpy()
    n = x.size
    mean = 30 / 42
    var = 30 * 12 / (42 ** 2 * 43)
    assert abs(x.mean() - mean) < 4 * np.sqrt(var / n)
    dev2 = (x - x.mean()) ** 2
    assert abs(dev2.mean() - var) < 4 * dev2.std() / np.sqrt(n)


def test_draws_match_jax_random_in_distribution():
    """The port's draws against the reference's jax.random on the same
    parameters from other keys (p > 1e-3, fixed seeds): 4,000 Beta(30, 12)
    q draws (jax.random.beta) by a two-sample Kolmogorov-Smirnov test, and
    the z draws of 4,000 rows of one logit vector (jax.random.categorical),
    whose column counts the chi-square test of the 2 x k table compares."""
    n = 4000
    keys = gibbs.input_keys(3, range(n), "cpu")
    q = gibbs.draw_beta(torch.full((n,), 30.0), torch.full((n,), 12.0), keys, True)
    jq = np.asarray(jax.random.beta(jax.random.PRNGKey(0), 30.0, 12.0, (n,)))
    pval = stats.ks_2samp(q.double().numpy(), jq).pvalue
    assert pval > 1e-3, pval
    logits = np.array([np.log(0.2), 0.3, NEG_INF, -1.0, 1.2, 0.0], np.float32)
    z = gibbs.draw_z(torch.as_tensor(logits).expand(1, n, -1).contiguous(), keys[:1],
                     True)[0].numpy()
    jz = np.asarray(jax.random.categorical(jax.random.PRNGKey(1), jnp.asarray(logits), shape=(n,)))
    table = np.stack([np.bincount(z, minlength=logits.size), np.bincount(jz, minlength=logits.size)])
    assert table[:, 2].sum() == 0
    pval = stats.chi2_contingency(table[:, table.sum(axis=0) > 0]).pvalue
    assert pval > 1e-3, (pval, table)


def test_chains_of_two_groups_differ(small):
    """(h) The m-th members of two (W, K) groups are independent chains:
    member i reproduces run_gibbs(..., key=fold_in(PRNGKey(seed), i)), and
    the group-local index (0) does not."""
    sset, _jbg, bg, _seeds = small
    sset, params = convert.sequence_set(sset), PParams(CGS=True, q=0.5, maxCGSIterations=5, seed=11)

    def mk(s):
        return convert.motif(jseeds.motif_from_pwm(jseeds.iupac_to_pwm(s, soft=0.6), K=2,
                                                   f_bg=sset.base_frequencies()))

    m8, m6 = mk("TGACTCAG"), mk("TGACTC")  # two (W, K) groups
    gibbs.run_gibbs_multi([m8, m6], bg, sset, params, device="cpu")
    solo6 = mk("TGACTC")
    gibbs.run_gibbs(solo6, bg, sset, params, key=gibbs.input_keys(11, [1], "cpu")[0], device="cpu")
    for a, b in zip(m6.v, solo6.v):
        np.testing.assert_array_equal(a, b)
    local6 = mk("TGACTC")
    gibbs.run_gibbs(local6, bg, sset, params, key=gibbs.input_keys(11, [0], "cpu")[0], device="cpu")
    assert not all(np.allclose(a, b, atol=1e-6) for a, b in zip(m6.v, local6.v))
    keys = [gibbs.input_keys(s, [i], "cpu").tolist() for s, i in ((11, 0), (11, 1), (12, 1))]
    assert keys[0] != keys[1] != keys[2]


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
    res = gibbs.run_gibbs(m, convert.background(jbg), convert.sequence_set(sset), convert.params(params), device="cpu")
    assert "".join("ACGT"[i] for i in m.v[0].argmax(axis=0)) == MOTIF
    assert np.all(m.alphas > 0) and not np.allclose(m.alphas, seed.alphas)
    for k, vk in enumerate(m.v):
        np.testing.assert_allclose(vk.reshape(-1, 4, m.W).sum(axis=1), 1.0, atol=1e-4, err_msg=f"order {k}")
    ll = np.array(res.ll_history)
    assert np.isfinite(ll).all() and ll[-5:].mean() > ll[:5].mean()
    jres = jgibbs.run_gibbs(seed.copy(), jbg, sset, params)
    assert abs(res.q - jres.q) < 0.15, (res.q, jres.q)
