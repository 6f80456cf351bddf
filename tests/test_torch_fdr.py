"""Port parity: the threshold sweep (``evaluation/prcurve.py``) and
cross-validated FDR (``evaluation/fdr.py``) against the JAX package, on the
same numpy-seeded sequences and user negatives (``--negSeqFile``), and the
port's stacked group path against its per-seed path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bammmotif2_tpu.evaluation import fdr as jfdr
from bammmotif2_tpu.evaluation import prcurve as jprcurve
from bammmotif2_tpu.models import background as jbackground
from bammmotif2_tpu.models import seeds as jseeds
from bammmotif2_tpu.refinement import em as jem
from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import SequenceSet
from bammmotif2_tpu_torch import convert
from bammmotif2_tpu_torch.evaluation import fdr, prcurve
from bammmotif2_tpu_torch.generator import seqgen
from bammmotif2_tpu_torch.models.background import BackgroundModel as PBackgroundModel
from bammmotif2_tpu_torch.ops.escore import NEG_INF
from bammmotif2_tpu_torch.utils.config import Params as PParams
from bammmotif2_tpu_torch.utils.fasta import SequenceSet as PSequenceSet

from tests.test_em import planted_set

torch.set_num_threads(1)

MOTIF = "TGACTCAG"
SWEEP_KEYS = ("score", "tp", "fp", "precision", "recall", "pvalue")


def _pools(seed=0):
    """Positive/negative f32 pools with tie blocks (scores rounded to 0.1)
    and NEG_INF pads, as the FDR scorer hands them over."""
    rng = np.random.default_rng(seed)
    pos = np.round(rng.normal(1.5, 1, 3000), 1).astype(np.float32)
    neg = np.round(rng.normal(0, 1, 9000), 1).astype(np.float32)
    pp = np.concatenate([pos, np.full(37, NEG_INF, np.float32)])
    nn = np.concatenate([np.full(91, NEG_INF, np.float32), neg])
    return pos, neg, pp, nn


@pytest.mark.parametrize("max_rows", [10**9, 500])
def test_thinned_rank_rows_match_jax(max_rows):
    pos, neg, pp, nn = _pools()
    rows = prcurve.thin_rows(pos.size + neg.size, max_rows)
    np.testing.assert_array_equal(rows, jprcurve.thin_rows(pos.size + neg.size, max_rows))
    out = prcurve.thinned_rank_rows(torch.from_numpy(pp), torch.from_numpy(nn),
                                    torch.from_numpy(rows), neg.size)
    jout = jprcurve.thinned_rank_rows(jnp.asarray(pp), jnp.asarray(nn),
                                      jnp.asarray(rows, jnp.int32), neg.size)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    for a, b in zip(out[1:], jout[1:]):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sweeps_and_avrec_match_jax():
    pos, neg, pp, nn = _pools(1)
    a = prcurve.threshold_sweep(pos, neg, 3)
    b = jprcurve.threshold_sweep(pos, neg, 3)
    for k in SWEEP_KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert prcurve.average_recall(a) == jprcurve.average_recall(b)
    # the device sweep: equal to JAX's, and to the host sweep up to
    # within-tie row order (identical at tie-block boundaries)
    d = prcurve.threshold_sweep_device(torch.from_numpy(pp), torch.from_numpy(nn), 3,
                                       pos.size, neg.size, max_rows=10**9)
    jd = jprcurve.threshold_sweep_device(jnp.asarray(pp), jnp.asarray(nn), 3,
                                         pos.size, neg.size, max_rows=10**9)
    for k in SWEEP_KEYS:
        np.testing.assert_array_equal(d[k], jd[k], err_msg=k)
    end = np.nonzero(np.diff(a["score"]) != 0)[0]
    for k in ("tp", "fp", "pvalue"):
        np.testing.assert_allclose(d[k][end], a[k][end], rtol=1e-12, err_msg=k)
    thin = prcurve.threshold_sweep_device(torch.from_numpy(pp), torch.from_numpy(nn), 3,
                                          pos.size, neg.size, max_rows=2000)
    assert prcurve.average_recall(thin) == pytest.approx(prcurve.average_recall(a), abs=2e-3)


@pytest.fixture(scope="module")
def fdr_data():
    """(JAX positives, JAX negatives, JAX background, and the port's copies
    of the background, positives and negatives)."""
    sset = planted_set(n=90, l=50, motif=MOTIF, q=0.8, noise=0.05, seed=6)
    neg = planted_set(n=70, l=50, motif="ACGTACGT", q=0.0, noise=1.0, seed=7)
    jbg = jbackground.BackgroundModel.from_sequence_set(sset, order=2)
    return sset, neg, jbg, convert.background(jbg), convert.sequence_set(sset), convert.sequence_set(neg)


def _jseeds(sset, specs=(MOTIF, "TGASTCAG"), K=2):
    return [jseeds.motif_from_pwm(jseeds.iupac_to_pwm(s, soft=0.6), K, sset.base_frequencies())
            for s in specs]


def _stats_rows(path):
    with open(path) as fh:
        return [ln.split("\t") for ln in fh.read().splitlines()[1:]]


def test_fdr_unrefined_matches_jax(fdr_data, tmp_path):
    """refine='none' with user negatives: both packages score the same seeds
    with the same folds.  Scores agree to 1e-5 (the window-score bar).  TP
    and FP are equal at 99.9% of the rows and within 0.1% of the row's rank
    everywhere, p-values equal there and within one rank elsewhere: the LUTs come from torch.log and XLA's log, which differ by
    an ulp, so two windows that tie in one package can split in the other
    (1 row of 13,760 here)."""
    sset, neg, jbg, bg, psset, pneg = fdr_data
    params = Params(FDR=True, cvFold=3, q=0.5)
    jms = _jseeds(sset)
    jres = jfdr.evaluate_motifs(jms, jbg, sset, params, refine="none", neg_set=neg)
    res = fdr.evaluate_motifs([convert.motif(m) for m in jms], bg, psset, convert.params(params),
                              refine="none", neg_set=pneg, device="cpu")
    n_neg = {"zoops": neg.n, "mops": 2 * int(np.maximum(neg.lens - 8 + 1, 0).sum())}
    for i, (r, jr) in enumerate(zip(res, jres)):
        assert r.fold_iterations == [0, 0, 0]
        for tag in ("zoops", "mops"):
            a, b = getattr(r, tag), getattr(jr, tag)
            rank = np.arange(1, a["tp"].size + 1)
            for k in ("tp", "fp"):
                d = np.abs(a[k] - b[k])
                assert (d == 0).mean() >= 0.999, f"{tag} {k} seed {i}"
                assert (d <= 1e-3 * rank).all(), f"{tag} {k} seed {i}"
            np.testing.assert_allclose(a["score"], b["score"], atol=1e-5, err_msg=f"{tag} seed {i}")
            # p-values likewise: a split tie moves a rank by one
            unit = 1.0 / (n_neg[tag] + 1)
            d = np.abs(a["pvalue"] - b["pvalue"])
            assert (d == 0).mean() >= 0.999 and (d <= unit + 1e-12).all(), f"{tag} seed {i}"
        d = np.abs(r.pos_pvalues - jr.pos_pvalues)
        assert (d == 0).mean() >= 0.99 and (d <= 1.0 / (neg.n + 1) + 1e-12).all()
        # the written tables: same rows, scores within 1e-5 plus one unit
        # of their 6th significant digit
        for pa, pb in zip(r.write(str(tmp_path / "t"), f"s{i}"), jr.write(str(tmp_path / "j"), f"s{i}")):
            ra, rb = _stats_rows(pa), _stats_rows(pb)
            assert len(ra) == len(rb) > 1
            for r1, (x, y) in enumerate(zip(ra, rb), start=1):
                assert np.abs(np.array(x[1:3], float) - np.array(y[1:3], float)).max() <= 1e-3 * r1
                assert float(x[0]) == pytest.approx(float(y[0]), rel=1e-5, abs=1e-5)


def test_fdr_em_matches_jax(fdr_data):
    """refine='EM' with user negatives: every fold's EM runs as many
    iterations as the reference's; the refined models then differ by
    rounding, so .stats scores agree to 1e-4 and AvRec to 1e-3.  epsilon is
    1e-2: at 1e-3 the stop statistic of some folds lands within float noise
    of epsilon, and the packages then stop one iteration apart (as
    test_torch_em.py::test_run_em_multi_matches_jax notes)."""
    sset, neg, jbg, bg, psset, pneg = fdr_data
    params = Params(FDR=True, cvFold=3, q=0.5, maxEMIterations=40, epsilon=1e-2)
    jms = _jseeds(sset)
    jres = jfdr.evaluate_motifs(jms, jbg, sset, params, neg_set=neg)
    res = fdr.evaluate_motifs([convert.motif(m) for m in jms], bg, psset, convert.params(params),
                              neg_set=pneg, device="cpu")
    # the reference's per-fold iteration counts: its single-seed EM on the
    # same train-masked lengths (its fused group loop returns none)
    jdata = jem.prepare_data(sset, jbg, 2, False)
    fold_of = np.arange(sset.n) % 3
    for i, (r, jr, jm) in enumerate(zip(res, jres, jms)):
        jits = []
        for f in range(3):
            train = fold_of != f
            tdata = {**jdata, "lens": jnp.asarray(np.where(train, sset.lens, 0).astype(np.int32))}
            jits.append(jem.run_em(jm.copy(), jbg, sset, params, data=tdata,
                                   n_real=int(train.sum())).iterations)
        assert r.fold_iterations == jits, f"seed {i}"
        assert 1 < max(jits) < params.maxEMIterations  # converged, and not at once
        for tag in ("zoops", "mops"):
            a, b = getattr(r, tag), getattr(jr, tag)
            assert a["score"].shape == b["score"].shape
            np.testing.assert_allclose(a["score"], b["score"], atol=1e-4, err_msg=f"{tag} seed {i}")
            assert prcurve.average_recall(a) == pytest.approx(jprcurve.average_recall(b), abs=1e-3)


@pytest.mark.parametrize("refine", ["none", "EM", "CGS"])
def test_fdr_sampled_negatives_match_jax(fdr_data, refine):
    """Sampled negatives (no --negSeqFile): each fold's are the reference's,
    from PRNGKey(seed + fold), so the .stats tables agree with the
    reference's by the bars of test_fdr_em_matches_jax (scores atol 1e-4,
    AvRec 1e-3), unrefined, EM-refined and CGS-refined with sampled z and q
    (the chains the reference's, from its shared PRNGKey(seed))."""
    sset, _neg, jbg, bg, psset, _pneg = fdr_data
    params = Params(FDR=True, CGS=refine == "CGS", cvFold=3, mFold=2, q=0.5, seed=5,
                    maxEMIterations=40, epsilon=1e-2, maxCGSIterations=8)
    jms = _jseeds(sset)
    jres = jfdr.evaluate_motifs(jms, jbg, sset, params, refine=refine)
    res = fdr.evaluate_motifs([convert.motif(m) for m in jms], bg, psset, convert.params(params),
                              refine=refine, device="cpu")
    for i, (r, jr) in enumerate(zip(res, jres)):
        for tag in ("zoops", "mops"):
            a, b = getattr(r, tag), getattr(jr, tag)
            assert a["score"].shape == b["score"].shape
            np.testing.assert_allclose(a["score"], b["score"], atol=1e-4, err_msg=f"{tag} seed {i}")
            assert prcurve.average_recall(a) == pytest.approx(jprcurve.average_recall(b), abs=1e-3)


def _assert_same(ref, new):
    """The reference suite's TestFusedFDR bar: ZOOPS rtol 1e-4, MOPS rtol
    1e-5, pos_pvalues rtol 1e-5; iteration counts equal."""
    for i, (r, n) in enumerate(zip(ref, new)):
        assert r.m_fold == n.m_fold and r.fold_iterations == n.fold_iterations
        np.testing.assert_allclose(r.pos_pvalues, n.pos_pvalues, rtol=1e-5, atol=1e-8)
        for k in SWEEP_KEYS:
            np.testing.assert_allclose(r.zoops[k], n.zoops[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"zoops {k} seed {i}")
            np.testing.assert_allclose(r.mops[k], n.mops[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"mops {k} seed {i}")


@pytest.mark.parametrize("negatives", ["sampled", "user"])
def test_group_matches_per_seed(fdr_data, negatives):
    sset, _neg, _jbg, bg, psset, pneg = fdr_data
    params = PParams(FDR=True, cvFold=3, mFold=2, q=0.5, maxEMIterations=12)
    neg_set = pneg if negatives == "user" else None
    ms = [convert.motif(m) for m in _jseeds(sset, (MOTIF, "TGASTCAG", "ACGTACGT"))]
    ref = [fdr.evaluate_motif(m.copy(), bg, psset, params, neg_set=neg_set, device="cpu") for m in ms]
    new = fdr.evaluate_motifs([m.copy() for m in ms], bg, psset, params, neg_set=neg_set, device="cpu")
    _assert_same(ref, new)
    assert all(it > 0 for it in new[0].fold_iterations)


def _short_and_empty_rows():
    """(JAX set, port background, port K=1 seeds, port set): 40 rows of 4-50
    bp, two of them empty, so folds of 14, 13 and 13 rows."""
    rng = np.random.default_rng(9)
    N, L = 40, 50
    codes = np.full((N, L), -2, np.int8)
    lens = rng.integers(4, L + 1, N).astype(np.int32)
    lens[[2, 7]] = 0
    for i in range(N):
        codes[i, : lens[i]] = rng.integers(0, 4, lens[i])
    sset = SequenceSet(codes=codes, lens=lens, headers=[f"s{i}" for i in range(N)],
                       alphabet=Alphabet.standard())
    bg = convert.background(jbackground.BackgroundModel.from_sequence_set(sset, order=1))
    seeds = [convert.motif(m) for m in _jseeds(sset, (MOTIF, "TGASTCAG"), K=1)]
    return sset, bg, seeds, convert.sequence_set(sset)


def test_group_matches_per_seed_short_and_empty_rows():
    """Zero-length rows and rows shorter than W: fold masks, window
    frontiers and the negatives chosen by index agree between the paths."""
    _sset, bg, ms, psset = _short_and_empty_rows()
    params = PParams(FDR=True, cvFold=3, mFold=2, q=0.5, sOrder=1, maxEMIterations=6, ss=True)
    ref = [fdr.evaluate_motif(ms[0].copy(), bg, psset, params, device="cpu")]
    new = fdr.evaluate_motifs([ms[0].copy()], bg, psset, params, device="cpu")
    _assert_same(ref, new)


def test_cgs_raises_before_work(fdr_data, tmp_path):
    """CGS is an engine FDR accepts (by name, or from params.CGS), EM the
    default.  Any other engine scores the seeds unrefined, as the
    reference's FDR does for a string it does not know: 'Gibbs' and 'cgs'
    give the .stats of 'none', through the group and the per-seed paths."""
    sset, _neg, _jbg, bg, psset, pneg = fdr_data
    ms = [convert.motif(m) for m in _jseeds(sset)]
    assert fdr._resolve(PParams(FDR=True, CGS=True), None)[1] == "CGS"
    assert fdr._resolve(None, "CGS")[1] == "CGS"
    assert fdr._resolve(PParams(FDR=True), None)[1] == "EM"
    params = PParams(FDR=True, CGS=True, cvFold=3, q=0.5, maxCGSIterations=4)
    none = fdr.evaluate_motifs(ms, bg, psset, params, refine="none", neg_set=pneg, device="cpu")
    expect = [[open(p).read() for p in r.write(str(tmp_path / "none"), f"s{i}")]
              for i, r in enumerate(none)]
    for refine in ("Gibbs", "cgs"):
        group = fdr.evaluate_motifs(ms, bg, psset, params, refine=refine, neg_set=pneg, device="cpu")
        solo = [fdr.evaluate_motif(ms[0], bg, psset, params, refine=refine, neg_set=pneg, device="cpu")]
        for res in (group, solo):
            assert [r.fold_iterations for r in res] == [[0, 0, 0]] * len(res)
            for i, r in enumerate(res):
                got = [open(p).read() for p in r.write(str(tmp_path / refine), f"s{i}")]
                assert got == expect[i], (refine, i)


def test_fdr_cgs_matches_jax(fdr_data):
    """refine='CGS' under --noZSampling --noQSampling with user negatives:
    no random draw is made, so the chains' keys do not matter, and the
    .stats tables agree with the reference's by the bars of
    test_fdr_em_matches_jax (scores atol 1e-4, AvRec 1e-3)."""
    sset, neg, jbg, bg, psset, pneg = fdr_data
    params = Params(FDR=True, CGS=True, cvFold=3, q=0.5, maxCGSIterations=8,
                    noZSampling=True, noQSampling=True)
    jms = _jseeds(sset)
    jres = jfdr.evaluate_motifs(jms, jbg, sset, params, neg_set=neg)
    res = fdr.evaluate_motifs([convert.motif(m) for m in jms], bg, psset, convert.params(params),
                              neg_set=pneg, device="cpu")
    for i, (r, jr) in enumerate(zip(res, jres)):
        assert r.fold_iterations == [params.maxCGSIterations] * 3
        for tag in ("zoops", "mops"):
            a, b = getattr(r, tag), getattr(jr, tag)
            assert a["score"].shape == b["score"].shape
            np.testing.assert_allclose(a["score"], b["score"], atol=1e-4, err_msg=f"{tag} seed {i}")
            assert prcurve.average_recall(a) == pytest.approx(jprcurve.average_recall(b), abs=1e-3)


@pytest.mark.parametrize("negatives", ["sampled", "user"])
def test_cgs_group_matches_per_seed(fdr_data, negatives):
    """Sampled CGS: the stacked group's chains are the per-seed path's
    (evaluate_motif), bit for bit, so the two give the same statistics.
    Every chain starts from PRNGKey(seed), as the reference's FDR keys it,
    so a seed's chain does not depend on its position in the set."""
    sset, _neg, _jbg, bg, psset, pneg = fdr_data
    params = PParams(FDR=True, CGS=True, cvFold=3, mFold=2, q=0.5, maxCGSIterations=6)
    neg_set = pneg if negatives == "user" else None
    ms = [convert.motif(m) for m in _jseeds(sset, (MOTIF, "TGASTCAG", "ACGTACGT"))]
    ref = [fdr.evaluate_motif(m.copy(), bg, psset, params, neg_set=neg_set, device="cpu")
           for m in ms]
    new = fdr.evaluate_motifs([m.copy() for m in ms], bg, psset, params, neg_set=neg_set, device="cpu")
    for r, n in zip(ref, new):
        np.testing.assert_array_equal(r.pos_pvalues, n.pos_pvalues)
        for k in SWEEP_KEYS:
            np.testing.assert_array_equal(r.zoops[k], n.zoops[k])
            np.testing.assert_array_equal(r.mops[k], n.mops[k])
    # the reference's shared key: the same seeds in another order, the same
    # chains (under --CGS alone each input index has its own)
    swapped = fdr.evaluate_motifs([ms[1].copy(), ms[0].copy()], bg, psset, params,
                                  neg_set=neg_set, device="cpu")
    for r, n in zip(ref[:2], swapped[::-1]):
        np.testing.assert_array_equal(r.zoops["score"], n.zoops["score"])
        np.testing.assert_array_equal(r.mops["score"], n.mops["score"])


def test_cvfold1_and_empty_set(fdr_data):
    sset, _neg, _jbg, bg, psset, _pneg = fdr_data
    m = convert.motif(_jseeds(sset)[0])
    res = fdr.evaluate_motifs([m], bg, psset, PParams(FDR=True, cvFold=1, mFold=2), device="cpu")
    # one fold holds every row out, so nothing trains and the seed is scored as is
    assert res[0].zoops["score"].size == psset.n * 3 and res[0].fold_iterations == [0]
    empty = fdr.evaluate_motif(m, bg, PSequenceSet.from_sequences([]), PParams(FDR=True, cvFold=3), device="cpu")
    assert empty.pos_pvalues.size == 0 and empty.zoops["score"].size == 0


# the group program against its plain version, the fold loop: (engine,
# negatives, set, Params fields); "planted" is fdr_data's 90 rows, cut into
# 4 folds of 23, 23, 22 and 22 rows, "short" _short_and_empty_rows's
PROGRAM_CASES = {
    "em_sampled": ("EM", "sampled", "planted", dict(maxEMIterations=12)),
    "em_user": ("EM", "user", "planted", dict(maxEMIterations=12)),
    "em_ss_sampled": ("EM", "sampled", "planted", dict(maxEMIterations=12, ss=True)),
    "cgs_deterministic_user": ("CGS", "user", "planted",
                               dict(maxCGSIterations=5, noZSampling=True, noQSampling=True)),
    "cgs_deterministic_sampled": ("CGS", "sampled", "planted",
                                  dict(maxCGSIterations=5, noZSampling=True, noQSampling=True)),
    "cgs_sampled": ("CGS", "sampled", "planted", dict(maxCGSIterations=5)),
    "cgs_burn_in_user": ("CGS", "user", "planted", dict(maxCGSIterations=5, cgsBurnIn=2)),
    "none_sampled": ("none", "sampled", "planted", {}),
    "none_user": ("none", "user", "planted", {}),
    "em_short_sampled": ("EM", "sampled", "short", dict(maxEMIterations=6, ss=True, sOrder=1)),
    "em_short_user": ("EM", "user", "short", dict(maxEMIterations=6, sOrder=1)),
    "cgs_short_sampled": ("CGS", "sampled", "short", dict(maxCGSIterations=4, sOrder=1)),
}


def _program_inputs(fdr_data, negatives, which):
    """(seeds, port background, port set, user negatives or None, cvFold)."""
    sset, _neg, _jbg, bg, psset, pneg = fdr_data
    if which == "short":
        _s, bg, ms, psset = _short_and_empty_rows()
        return ms, bg, psset, pneg if negatives == "user" else None, 3
    ms = [convert.motif(m) for m in _jseeds(sset, (MOTIF, "TGASTCAG", "ACGTACGT"))]
    return ms, bg, psset, pneg if negatives == "user" else None, 4


def _assert_equal_results(a, b, tmp_path):
    """FDRResults equal array for array, and their written files byte for byte."""
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.m_fold == y.m_fold and x.fold_iterations == y.fold_iterations, i
        np.testing.assert_array_equal(x.pos_pvalues, y.pos_pvalues)
        for k in SWEEP_KEYS:
            np.testing.assert_array_equal(x.zoops[k], y.zoops[k], err_msg=f"zoops {k} seed {i}")
            np.testing.assert_array_equal(x.mops[k], y.mops[k], err_msg=f"mops {k} seed {i}")
        for pa, pb in zip(x.write(str(tmp_path / "a"), f"s{i}"), y.write(str(tmp_path / "b"), f"s{i}")):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), pa


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_program_matches_fold_loop(fdr_data, tmp_path, case):
    """evaluate_motifs' group program and its plain version, the fold loop,
    give equal results and files: the same scores, negatives, iterations
    and sweeps (a smaller fold's pad rows only add NEG_INF to the MOPS
    pools, which the rank sweep counts as invalid windows)."""
    refine, negatives, which, fields = PROGRAM_CASES[case]
    ms, bg, psset, neg_set, cv = _program_inputs(fdr_data, negatives, which)
    params = PParams(FDR=True, cvFold=cv, mFold=2, q=0.5, **fields)
    program = fdr.evaluate_motifs([m.copy() for m in ms], bg, psset, params, refine=refine,
                                  neg_set=neg_set, device="cpu")
    loop = fdr.evaluate_motifs([m.copy() for m in ms], bg, psset, params, refine=refine,
                               neg_set=neg_set, device="cpu", program=False)
    _assert_equal_results(program, loop, tmp_path)
    if refine == "EM":
        assert all(it > 0 for it in program[0].fold_iterations)


@pytest.mark.parametrize("which,order,ss", [("planted", 2, False), ("planted", 0, True),
                                            ("short", 1, False), ("short", 3, True)])
def test_fold_backgrounds_match_per_fold_fits(fdr_data, which, order, ss):
    """The program's stacked background tables are the fold loop's fits to
    each fold's training rows, bit for bit (float32)."""
    _ms, _bg, psset, _neg, F = _program_inputs(fdr_data, "sampled", which)
    fold_of = np.arange(psset.n) % F
    tables = fdr.fold_backgrounds(psset, fold_of, F, order, 10.0, ss)
    assert [t.shape for t in tables] == [(F, 4 ** (o + 1)) for o in range(order + 1)]
    for f in range(F):
        fit = PBackgroundModel.from_sequence_set(psset.subset(np.nonzero(fold_of != f)[0]),
                                                 order=order, alpha=10.0, ss=ss)
        for o in range(order + 1):
            np.testing.assert_array_equal(tables[o][f], np.asarray(fit.v[o], np.float32).ravel())


@pytest.mark.parametrize("which,ss", [("planted", False), ("short", True)])
def test_fold_negatives_match_generate_neg_data(fdr_data, which, ss):
    """The fold tail's negatives, drawn from the stacked tables with the key
    PRNGKey(--seed + fold), are generate_neg_data's for that fold's fit and
    lengths, bit for bit."""
    ms, bg, psset, _neg, F = _program_inputs(fdr_data, "sampled", which)
    params = PParams(FDR=True, cvFold=F, mFold=3, sOrder=2, ss=ss, seed=11)
    g = fdr._prepare_group(ms, bg, psset, params, None, "cpu")
    fold_of = np.arange(psset.n) % F
    lens = np.asarray(psset.lens, np.int32)
    for f in range(F):
        fit = PBackgroundModel.from_sequence_set(psset.subset(np.nonzero(fold_of != f)[0]),
                                                 order=2, alpha=params.bgModelAlpha, ss=ss)
        ref, ref_lens = seqgen.generate_neg_data(
            fit, lens[fold_of == f], m_fold=3, seed=params.seed + f, K=ms[0].K, ss=ss,
            n_pad=g.inputs["neg_lens"].shape[1], pad_len=g.neg_pad_len, device="cpu")
        got = fdr._negatives(g, g.inputs, torch.tensor([f]))
        assert got.dtype == ref.dtype and torch.equal(got, ref), f
        np.testing.assert_array_equal(g.inputs["neg_lens"][f].numpy(), ref_lens)
        np.testing.assert_array_equal(g.neg_keep[f], np.nonzero(ref_lens > 0)[0])


@pytest.mark.parametrize("refine", ["none", "EM"])
def test_program_matches_jax_unequal_folds(fdr_data, refine):
    """The group program against the JAX package's evaluate_motifs on folds
    of unequal size (90 rows in 4) with user negatives, single-stranded:
    .stats scores within 1e-4 and AvRec within 1e-3, the bars of
    test_fdr_em_matches_jax."""
    sset, neg, jbg, bg, psset, pneg = fdr_data
    params = Params(FDR=True, cvFold=4, q=0.5, ss=True, maxEMIterations=40, epsilon=1e-2)
    jms = _jseeds(sset)
    jres = jfdr.evaluate_motifs(jms, jbg, sset, params, refine=refine, neg_set=neg)
    res = fdr.evaluate_motifs([convert.motif(m) for m in jms], bg, psset, convert.params(params),
                              refine=refine, neg_set=pneg, device="cpu")
    for i, (r, jr) in enumerate(zip(res, jres)):
        for tag in ("zoops", "mops"):
            a, b = getattr(r, tag), getattr(jr, tag)
            assert a["score"].shape == b["score"].shape
            np.testing.assert_allclose(a["score"], b["score"], atol=1e-4, err_msg=f"{tag} seed {i}")
            assert prcurve.average_recall(a) == pytest.approx(jprcurve.average_recall(b), abs=1e-3)
