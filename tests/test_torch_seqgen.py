"""Port checks of sequence generation (``generator/seqgen.py``).

The port samples from the reference's own ``jax.random`` streams, so its
sets are held to the JAX package's from the same seed, row for row; the
sampled paths are also held to the background they were fit to (by
distribution, as ``tests/test_scan_fdr.py::TestSeqGen`` holds the
reference), and the deterministic parts (lengths, padding, seeding, the
encoded form) are checked exactly.
"""

import os

import numpy as np
import pytest
import torch

from bammmotif2_tpu.generator import seqgen as jseqgen
from bammmotif2_tpu.models import seeds as jseeds
from bammmotif2_tpu.models.background import BackgroundModel as JBackgroundModel
from bammmotif2_tpu.utils.fasta import read_fasta
from bammmotif2_tpu_torch import convert
from bammmotif2_tpu_torch.generator import seqgen
from bammmotif2_tpu_torch.models import seeds as seeds_mod
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.ops import encode
from bammmotif2_tpu_torch.scoring import scan
from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.fasta import PAD, SequenceSet

from tests import test_em

torch.set_num_threads(1)

MOTIF = "TGACTCAG"
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                        "positives.fasta")
# rows of a sampled set equal to the reference's (a near tie of two
# gumbel-shifted logits, an ulp apart between the packages, could flip a
# draw and the rest of its row)
ROW_SHARE = 0.999


def planted_set(**kw) -> SequenceSet:
    """tests/test_em.py's planted set as the port's SequenceSet."""
    return convert.sequence_set(test_em.planted_set(**kw))


def _kmer_freqs(sset: SequenceSet, k: int) -> np.ndarray:
    """Frequencies of the forward-strand k-mers that hold no PAD."""
    A = sset.alphabet.size
    c = sset.codes.astype(np.int64)
    code = np.zeros(c[:, k - 1 :].shape, np.int64)
    ok = np.ones(code.shape, bool)
    for d in range(k):
        part = c[:, d : c.shape[1] - k + 1 + d]
        code = code * A + np.maximum(part, 0)
        ok &= part >= 0
    n = np.bincount(code[ok], minlength=A ** k).astype(np.float64)
    return n / n.sum()


def test_lengths_and_padding():
    sset = planted_set(n=50, l=60)
    lens = sset.lens.copy()
    lens[:3] = [0, 5, 60]
    bg_fit = BackgroundModel.from_sequence_set(sset, order=2)
    neg = seqgen.generate_neg_set(bg_fit, lens, m_fold=3, seed=1, n_pad=160, pad_len=70, device="cpu")
    assert neg.n == 160 and neg.codes.shape == (160, 70)
    np.testing.assert_array_equal(neg.lens, np.concatenate([np.tile(lens, 3), np.zeros(10)]))
    pad = np.arange(70)[None, :] >= neg.lens[:, None]
    assert (neg.codes[pad] == PAD).all()
    assert neg.codes[~pad].min() >= 0 and neg.codes[~pad].max() <= 3
    assert neg.headers[0] == "neg_1" and len(neg.headers) == 160
    with pytest.raises(ValueError):
        seqgen.generate_neg_set(bg_fit, lens, m_fold=3, n_pad=10, device="cpu")
    with pytest.raises(ValueError):
        seqgen.generate_neg_set(bg_fit, lens, m_fold=1, pad_len=50, device="cpu")


def test_same_seed_same_set():
    sset = planted_set(n=40, l=50)
    bg_fit = BackgroundModel.from_sequence_set(sset, order=2)
    a = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=2, seed=7, device="cpu")
    b = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=2, seed=7, device="cpu")
    c = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=2, seed=8, device="cpu")
    np.testing.assert_array_equal(a.codes, b.codes)
    assert not np.array_equal(a.codes, c.codes)


@pytest.mark.parametrize("order", [0, 2])
def test_matches_background_distribution(order):
    """Mono- and (order+1)-mer frequencies of a sample follow a skewed
    source: within 0.02 (mono) and 0.015 (k-mers) at 10^5 bases."""
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGT"), p=[0.4, 0.1, 0.1, 0.4], size=200)) for _ in range(50)]
    sset = SequenceSet.from_sequences(seqs)
    bg_fit = BackgroundModel.from_sequence_set(sset, order=order, ss=True)
    neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=10, seed=2, device="cpu")
    np.testing.assert_allclose(neg.base_frequencies(), sset.base_frequencies(), atol=0.02)
    k = order + 1
    # the order-k model's joint (k)-mer probabilities (.hbp) vs the sample
    np.testing.assert_allclose(_kmer_freqs(neg, k), bg_fit.full_probs()[order], atol=0.015)


def test_order1_transition_structure():
    """An (almost) deterministic AC-repeat source: after an A comes a C."""
    sset = SequenceSet.from_sequences(["ACACACACAC" * 10 for _ in range(20)])
    bg_fit = BackgroundModel.from_sequence_set(sset, order=1, ss=True)
    neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=1, seed=3, device="cpu")
    a_pos = neg.codes[:, :-1] == 0
    frac = (a_pos & (neg.codes[:, 1:] == 1)).sum() / max(a_pos.sum(), 1)
    assert frac > 0.9


@pytest.mark.parametrize("ss", [False, True])
def test_neg_data_equals_encoded_neg_set(ss):
    """generate_neg_data's device tensors == encoding generate_neg_set's set
    drawn with the same seed (the FDR fold loop relies on it)."""
    alphabet = Alphabet.from_type("METHYLC") if ss else Alphabet.standard()
    rng = np.random.default_rng(4)
    codes = rng.integers(0, alphabet.size, (30, 40)).astype(np.int8)
    lens = rng.integers(0, 41, 30).astype(np.int32)
    codes[np.arange(40)[None, :] >= lens[:, None]] = PAD
    sset = SequenceSet(codes, lens, [f"s{i}" for i in range(30)], alphabet)
    bg_fit = BackgroundModel.from_sequence_set(sset, order=2, ss=ss)
    cidx, nlens = seqgen.generate_neg_data(bg_fit, sset.lens, m_fold=3, seed=11, K=3, ss=ss,
                                           n_pad=95, pad_len=45, device="cpu")
    neg = seqgen.generate_neg_set(bg_fit, sset.lens, m_fold=3, seed=11, n_pad=95, pad_len=45, device="cpu")
    ref, ref_lens = encode.strand_indices(neg, 3, ss, "cpu")
    np.testing.assert_array_equal(nlens, neg.lens)
    assert cidx.dtype == torch.int32 and torch.equal(cidx, ref)
    np.testing.assert_array_equal(ref_lens.numpy(), nlens)


def test_sample_motif_sites_follow_the_motif():
    """Sites drawn from a PWM seed reproduce its columns (within 0.02 at
    20k draws) and are reproducible from the seed."""
    pwm = seeds_mod.iupac_to_pwm(MOTIF, soft=0.7)
    m = seeds_mod.motif_from_pwm(pwm, K=0, f_bg=np.full(4, 0.25))
    sites = seqgen.sample_motif_sites(m, 20_000, seed=5)
    freq = np.stack([np.bincount(sites[:, j], minlength=4) / sites.shape[0] for j in range(m.W)])
    np.testing.assert_allclose(freq, m.v[0].T, atol=0.02)
    np.testing.assert_array_equal(sites, seqgen.sample_motif_sites(m, 20_000, seed=5))


def test_embed_and_mask_motif():
    """Embedded sites raise the scan's maxima; masking removes planted
    sites (the reference's TestSeqGen / TestMaskMotif, on the port)."""
    sset = planted_set(n=150, l=80, motif=MOTIF, q=0.9, noise=0.02)
    bg = BackgroundModel.from_sequence_set(sset, order=2)
    motif = seeds_mod.motif_from_pwm(seeds_mod.iupac_to_pwm(MOTIF, soft=0.8), K=0,
                                     f_bg=sset.base_frequencies())
    neg = seqgen.generate_neg_set(bg, sset.lens, m_fold=1, seed=4, device="cpu")
    emb = seqgen.embed_motif(neg, motif, q=1.0, seed=5)
    assert scan.score_set(motif, bg, emb, device="cpu").max_scores.mean() > \
        scan.score_set(motif, bg, neg, device="cpu").max_scores.mean() + 2.0

    def hits(s):
        # ranked against the negatives' per-sequence maxima, as the
        # reference's test ranks them (a stricter pool than mask_motif's)
        res = scan.score_set(motif, bg, s, device="cpu")
        pool = seqgen.generate_neg_set(bg, s.lens, m_fold=5, seed=3, device="cpu")
        return len(scan.find_occurrences(res, s, scan.score_set(motif, bg, pool, device="cpu").max_scores, 0.01))

    before = hits(sset)
    after = hits(seqgen.mask_motif(sset, motif, bg, pval_cutoff=0.01, m_fold=5, device="cpu"))
    assert before > 100
    assert after < before * 0.1


def _reference_sets():
    """examples/ (500 rows of 80-150 bp) and a 1,000 x 200 bp planted set,
    as the JAX package's SequenceSets."""
    return {"examples": read_fasta(EXAMPLES),
            "planted_1k": test_em.planted_set(n=1_000, l=200, motif=MOTIF, q=0.5, noise=0.3,
                                              seed=21)}


def _assert_rows_match(got: np.ndarray, want: np.ndarray) -> None:
    """The same shape, and at least ROW_SHARE of the rows equal."""
    assert got.shape == want.shape
    same = (got == want).all(axis=1)
    assert same.mean() >= ROW_SHARE, same.mean()


@pytest.mark.parametrize("ss", [False, True], ids=["ds", "ss"])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("which", ["examples", "planted_1k"])
def test_neg_set_matches_jax(which, order, ss):
    """generate_neg_set against the reference's from the same seed and fit,
    at --sOrder 0-3, with and without --ss: the same rows."""
    sset = _reference_sets()[which]
    jbg = JBackgroundModel.from_sequence_set(sset, order=order, alpha=1.0, ss=ss)
    want = jseqgen.generate_neg_set(jbg, sset.lens, m_fold=2, seed=order + 40)
    got = seqgen.generate_neg_set(convert.background(jbg), sset.lens, m_fold=2, seed=order + 40,
                                  device="cpu")
    np.testing.assert_array_equal(got.lens, want.lens)
    _assert_rows_match(got.codes, np.asarray(want.codes))


@pytest.mark.parametrize("ss", [False, True], ids=["ds", "ss"])
def test_neg_data_matches_jax(ss):
    """generate_neg_data's encoded tensors against the reference's on
    examples/ lengths, padded as the FDR fold loop pads them."""
    sset = _reference_sets()["examples"]
    jbg = JBackgroundModel.from_sequence_set(sset, order=2, alpha=1.0, ss=ss)
    n_pad, pad_len = 2 * sset.n + 7, int(sset.lens.max()) + 3
    jcidx, jlens = jseqgen.generate_neg_data(jbg, sset.lens, m_fold=2, seed=9, K=2, ss=ss,
                                             n_pad=n_pad, pad_len=pad_len)
    cidx, lens = seqgen.generate_neg_data(convert.background(jbg), sset.lens, m_fold=2, seed=9,
                                          K=2, ss=ss, n_pad=n_pad, pad_len=pad_len, device="cpu")
    np.testing.assert_array_equal(lens, jlens)
    got, want = cidx.numpy(), np.asarray(jcidx)
    assert got.shape == want.shape
    _assert_rows_match(got.transpose(1, 0, 2).reshape(n_pad, -1),
                       want.transpose(1, 0, 2).reshape(n_pad, -1))


def test_sample_motif_sites_match_jax():
    """sample_motif_sites against the reference's from the same seed: the
    same sites (one categorical key a position, on the host)."""
    pwm = jseeds.iupac_to_pwm(MOTIF, soft=0.7)
    jm = jseeds.motif_from_pwm(pwm, K=2, f_bg=np.full(4, 0.25))
    want = jseqgen.sample_motif_sites(jm, 3_000, seed=6)
    got = seqgen.sample_motif_sites(convert.motif(jm), 3_000, seed=6)
    _assert_rows_match(got, np.asarray(want))
