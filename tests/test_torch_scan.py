"""Port parity: the window-score op (``ops/cuda_scores.py``, whose plain
version CPU tensors take) and the scanner (``scoring/scan.py``) against the
JAX package's Pallas kernel in interpret mode, its gather path and its
scanner, on the same numpy-seeded sequences."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bammmotif2_tpu.models import background as jbackground
from bammmotif2_tpu.generator import seqgen as jseqgen
from bammmotif2_tpu.models import seeds as jseeds
from bammmotif2_tpu.ops import escore as jescore
from bammmotif2_tpu.ops import pallas_em
from bammmotif2_tpu.refinement.em import run_em as jrun_em
from bammmotif2_tpu.scoring import scan as jscan
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import SequenceSet as JSequenceSet
from bammmotif2_tpu_torch import convert
from bammmotif2_tpu_torch.generator import seqgen
from bammmotif2_tpu_torch.ops import cuda_scores, escore
from bammmotif2_tpu_torch.scoring import scan
from bammmotif2_tpu_torch.utils.fasta import SequenceSet

from tests.test_em import planted_set
from tests.test_torch_em_kernel import em_problem

torch.set_num_threads(1)

MOTIF = "TGACTCAG"
# Window scores: atol 1e-5, the JAX suite's bar for its Pallas kernels
# (tests/test_pallas_em.py).  Both the port and the reference's gather path
# add j = 0..W-1 in order, so on the CPU they agree far inside it.
SC_ATOL = 1e-5

WS_CASES = {
    "K0_M1_ragged": dict(K=0, W=6, M=1, ragged=True),
    "K2_M3_ss": dict(K=2, W=8, M=3, ss=True),
    "K5_M3": dict(K=5, W=6, M=3),
    "K5_M1_ragged_ss": dict(K=5, W=6, M=1, ss=True, ragged=True),
}


@pytest.mark.parametrize("name", sorted(WS_CASES))
def test_window_scores_match_jax(name):
    case = WS_CASES[name]
    luts, _qs, jdata = em_problem(**case)
    K, W, M = case["K"], case["W"], case["M"]
    cidx, lens = convert.indices(jdata["cidx"], "cpu"), convert.indices(jdata["lens"], "cpu")
    s_flat = convert.floats(luts, "cpu")
    launches = cuda_scores.window_scores_multi.launches
    sc, mk = cuda_scores.window_scores_multi(s_flat, cidx, lens)
    assert cuda_scores.window_scores_multi.launches == launches  # CPU tensors: no kernel
    ref, ref_mk = cuda_scores.window_scores_multi_ref(s_flat, cidx, lens)
    assert torch.equal(sc, ref) and torch.equal(mk, ref_mk)
    assert sc.dtype == torch.float32 and mk.dtype == torch.bool
    S, N, L = jdata["cidx"].shape
    assert sc.shape == (M, S, N, L - W + 1)

    psc, pmk = pallas_em.window_scores_multi(jnp.asarray(luts), jdata["cidx"], jdata["lens"],
                                             A=4, K=K, W=W, interpret=True)
    np.testing.assert_array_equal(mk.numpy(), np.asarray(pmk))
    np.testing.assert_allclose(sc.numpy(), np.asarray(psc), atol=SC_ATOL)
    for m in range(M):
        gsc, gmk = jescore.window_scores(jnp.asarray(luts[m]), jdata["cidx"], jdata["lens"], W)
        np.testing.assert_allclose(sc[m].numpy(), np.asarray(gsc), atol=SC_ATOL)
        np.testing.assert_array_equal(mk.numpy(), np.asarray(gmk))
    # the M=1 form
    sc1, mk1 = cuda_scores.window_scores(s_flat[0], cidx, lens)
    assert torch.equal(sc1, sc[0]) and torch.equal(mk1, mk)
    # invalid windows carry exactly NEG_INF
    assert bool((sc[:, :, ~mk] == escore.NEG_INF).all())


def test_window_scores_reject_width_beyond_length():
    with pytest.raises(ValueError):
        cuda_scores.window_scores_multi(torch.zeros((1, 3, 6)), torch.zeros((2, 3, 5), dtype=torch.int32),
                                        torch.full((3,), 5, dtype=torch.int32))


def test_launch_plan():
    # config 5's K=2, W=12: 4 KB a seed, ten seeds share a block's LUTs
    assert cuda_scores.launch_plan(10, 85, 12) == (10, True)
    # K=4 (69 KB a seed) stays in shared memory, two seeds a block within
    # LUT_TARGET: three seeds run as balanced chunks of one and two
    assert cuda_scores.launch_plan(3, 1366, 12) == (2, True)
    # A=4, K=5 (262 KB a seed): read through the cache, all seeds one block
    assert cuda_scores.launch_plan(3, 5462, 12) == (3, False)


@pytest.fixture(scope="module")
def trained():
    """A JAX-refined motif on a planted set, a second seed, and numpy-made
    user negatives; the port's copies of the sets, motifs and background."""
    sset = planted_set(n=120, l=60, motif=MOTIF, q=0.9, noise=0.05, seed=4)
    jbg = jbackground.BackgroundModel.from_sequence_set(sset, order=2)
    jm = jseeds.motif_from_pwm(jseeds.iupac_to_pwm(MOTIF, soft=0.6), 2, sset.base_frequencies())
    jrun_em(jm, jbg, sset, Params(EM=True, q=0.5, use_pallas=False, maxEMIterations=30))
    jm2 = jseeds.motif_from_pwm(jseeds.iupac_to_pwm("TGASTCAG", soft=0.8), 2, sset.base_frequencies())
    neg = planted_set(n=150, l=70, motif="ACGTACGT", q=0.0, noise=1.0, seed=5)
    return dict(sset=sset, neg=neg, jbg=jbg, jms=[jm, jm2], bg=convert.background(jbg),
                ms=[convert.motif(jm), convert.motif(jm2)],
                psset=convert.sequence_set(sset), pneg=convert.sequence_set(neg))


@pytest.mark.parametrize("keep_bytes", [scan.KEEP_BYTES, 0], ids=["retained", "streamed"])
def test_score_set_multi_matches_jax(trained, keep_bytes):
    t = trained
    jres = jscan.score_set_multi(t["jms"], t["jbg"], t["sset"], keep_bytes=keep_bytes, batch=50)
    res = scan.score_set_multi(t["ms"], t["bg"], t["psset"], keep_bytes=keep_bytes, batch=50, device="cpu")
    retained = scan.score_set_multi(t["ms"], t["bg"], t["psset"], batch=50, device="cpu")
    for r, jr, kept in zip(res, jres, retained):
        assert (r._chunks is None) == (keep_bytes == 0)
        assert r.n_windows == jr.n_windows == kept.n_windows
        np.testing.assert_allclose(r.max_scores, jr.max_scores, atol=SC_ATOL)
        np.testing.assert_allclose(r.all_window_scores(), jr.all_window_scores(), atol=SC_ATOL)
        np.testing.assert_allclose(r.scores, jr.scores, atol=SC_ATOL)
        np.testing.assert_array_equal(r.mask, jr.mask)
        # streaming re-scores exactly what retaining keeps
        np.testing.assert_array_equal(r.max_scores, kept.max_scores)
        np.testing.assert_array_equal(r.all_window_scores(), kept.all_window_scores())
    # chunking does not change the reductions
    small = scan.score_set(t["ms"][0], t["bg"], t["psset"], batch=17, device="cpu")
    np.testing.assert_array_equal(small.max_scores, retained[0].max_scores)


def _rows(occs):
    return [(o.seq_idx, o.header, o.length, o.strand, o.start, o.end, o.site) for o in occs]


@pytest.mark.parametrize("cutoff", [1e-3, 0.02])
def test_find_occurrences_matches_jax(trained, cutoff):
    t = trained
    m, jm = t["ms"][0], t["jms"][0]
    jres = jscan.score_set(jm, t["jbg"], t["sset"])
    jneg = jscan.score_set(jm, t["jbg"], t["neg"])
    jocc = jscan.find_occurrences(jres, t["sset"], jneg, cutoff)
    res = scan.score_set(m, t["bg"], t["psset"], batch=50, device="cpu")
    neg = scan.score_set(m, t["bg"], t["pneg"], batch=64, keep_bytes=0, device="cpu")
    occ_dev = scan.find_occurrences(res, t["psset"], neg, cutoff)        # device pool
    occ_host = scan.find_occurrences(res, t["psset"], neg.all_window_scores(), cutoff)
    assert len(jocc) > 0
    assert _rows(occ_dev) == _rows(occ_host) == _rows(jocc)
    for a, b, j in zip(occ_dev, occ_host, jocc):
        assert a.pvalue == b.pvalue and a.evalue == b.evalue and a.score == b.score
        assert a.score == pytest.approx(j.score, abs=SC_ATOL)
        assert a.pvalue == pytest.approx(j.pvalue, rel=1e-9)
        assert a.evalue == pytest.approx(j.evalue, rel=1e-9)


@pytest.mark.parametrize("cutoff", [1e-3, 0.02])
def test_sampled_negatives_scan_matches_jax(trained, cutoff):
    """--scoreSeqset with no --negSeqFile: the negatives sampled from
    PRNGKey(--seed) are the reference's, so their per-window pool and every
    occurrence's p-value and e-value are the reference's too."""
    t = trained
    m, jm = t["ms"][0], t["jms"][0]
    jneg_set = jseqgen.generate_neg_set(t["jbg"], t["sset"].lens, m_fold=3, seed=42)
    neg_set = seqgen.generate_neg_set(t["bg"], t["psset"].lens, m_fold=3, seed=42, device="cpu")
    np.testing.assert_array_equal(neg_set.codes, np.asarray(jneg_set.codes))
    jres = jscan.score_set(jm, t["jbg"], t["sset"])
    jocc = jscan.find_occurrences(jres, t["sset"], jscan.score_set(jm, t["jbg"], jneg_set), cutoff)
    res = scan.score_set(m, t["bg"], t["psset"], device="cpu")
    neg = scan.score_set(m, t["bg"], neg_set, device="cpu")
    occ = scan.find_occurrences(res, t["psset"], neg, cutoff)
    assert len(jocc) > 0 and _rows(occ) == _rows(jocc)
    for a, j in zip(occ, jocc):
        assert a.score == pytest.approx(j.score, abs=SC_ATOL)
        assert a.pvalue == pytest.approx(j.pvalue, rel=1e-9)
        assert a.evalue == pytest.approx(j.evalue, rel=1e-9)


def test_writers_match_jax(trained, tmp_path):
    t = trained
    m, jm = t["ms"][0], t["jms"][0]
    jres = jscan.score_set(jm, t["jbg"], t["sset"])
    res = scan.score_set(m, t["bg"], t["psset"], device="cpu")
    neg = np.random.default_rng(0).normal(-8, 3, 2000)
    jscan.write_occurrences(tmp_path / "j.occurrence", jscan.find_occurrences(jres, t["sset"], neg, 1e-2))
    scan.write_occurrences(tmp_path / "t.occurrence", scan.find_occurrences(res, t["psset"], neg, 1e-2))
    n_j = jscan.write_logodds(tmp_path / "j.logOdds", jres, t["sset"])
    n_t = scan.write_logodds(tmp_path / "t.logOdds", res, t["psset"])
    assert n_t == n_j == res.n_windows
    for ext in ("occurrence", "logOdds"):
        a = (tmp_path / f"t.{ext}").read_text().splitlines()
        b = (tmp_path / f"j.{ext}").read_text().splitlines()
        assert len(a) == len(b) > 1 and a[0] == b[0]
        # columns other than the score are equal; scores within SC_ATOL plus
        # one unit in the 6th significant digit they are written with
        for la, lb in zip(a[1:], b[1:]):
            fa, fb = la.split("\t"), lb.split("\t")
            col = 5 if ext == "occurrence" else 3
            assert fa[:col] + fa[col + 1:] == fb[:col] + fb[col + 1:]
            assert float(fa[col]) == pytest.approx(float(fb[col]), rel=1e-5, abs=SC_ATOL)


def test_empirical_pvalues_match_jax():
    rng = np.random.default_rng(1)
    neg = np.round(rng.normal(0, 1, 500), 1)  # tie blocks
    s = np.concatenate([np.round(rng.normal(0, 2, 200), 1), [-10.0, 10.0]])
    np.testing.assert_array_equal(scan.empirical_pvalues(s, neg), jscan.empirical_pvalues(s, neg))
    assert scan.empirical_pvalues(np.array([1.0]), np.array([]))[0] == 1.0


class TestScanEdgeCases:
    def test_motif_wider_than_set(self, trained):
        short = SequenceSet.from_sequences(["ACGTACGTACGT"])  # len 12
        jm = jseeds.motif_from_pwm(jseeds.iupac_to_pwm("TGACTCAGTGACTCAGTGAC", soft=0.6), 2,
                                   short.base_frequencies())  # W=20 > 12
        res = scan.score_set(convert.motif(jm), trained["bg"], short, device="cpu")
        assert res.n_windows == 0
        assert res.max_scores.shape == (1,)
        assert scan.find_occurrences(res, short, np.zeros(10), 0.01) == []

    def test_empty_set(self, trained):
        empty = SequenceSet.from_sequences([])
        res = scan.score_set(trained["ms"][0], trained["bg"], empty, device="cpu")
        assert res.n_windows == 0 and res.max_scores.size == 0
        assert res.scores.shape[1] == 0
        assert res.mask.shape[0] == 0
        assert res.all_window_scores().size == 0

    def test_budget_uses_padded_width(self, trained):
        m = trained["ms"][0]
        wide = np.full((300, 4000), -2, np.int8)
        wide[:, :30] = np.random.default_rng(0).integers(0, 4, (300, 30))
        short_wide = SequenceSet(codes=wide, lens=np.full(300, 30, np.int32),
                                 headers=[f"s{i}" for i in range(300)],
                                 alphabet=trained["psset"].alphabet)
        # padded chunks: 2 * 300 * (4000-8+1) * 4 B = 9.6 MB > a 1 MB budget,
        # while a lens-based estimate (30-8+1 windows) would say retain
        res = scan.score_set(m, trained["bg"], short_wide, keep_bytes=1 << 20, device="cpu")
        assert res._chunks is None and res._rescan is not None
        assert res.n_windows == 300 * (30 - m.W + 1) * 2

    def test_single_strand_empty_scan_keeps_two_strands(self, trained):
        """The reference's quirk, kept for parity (ROADMAP C): a --ss scan
        with no chunks reports S = 2 in ``scores`` when the set has rows."""
        res = scan.score_set(trained["ms"][0], trained["bg"], SequenceSet.from_sequences(["ACGTAC"]),
                             ss=True, device="cpu")
        jres = jscan.score_set(trained["jms"][0], trained["jbg"], JSequenceSet.from_sequences(["ACGTAC"]),
                               ss=True)
        assert res.scores.shape == jres.scores.shape == (2, 1, 0)

    def test_device_codes_memo(self, trained):
        """The upload is memoized on the set, apart from the reference's
        memo; like it, the memo assumes the codes are never mutated."""
        sset = trained["psset"]
        a = scan._device_codes(sset, 50, "cpu")
        assert scan._device_codes(sset, 50, "cpu")[0] is a[0]
        assert (50, "cpu") in sset.__dict__["_torch_device_codes_cache"]
        assert "_torch_device_codes_cache" not in trained["sset"].__dict__
        assert a[0].shape == (150, sset.codes.shape[1]) and int(a[1][120:].sum()) == 0
