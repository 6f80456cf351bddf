"""The background fit's k-mer counts (models/background.py): one bincount
of the set's memoised k-mer index (ops/encode.py::strand_indices) gives the
integers a numpy bincount of the host index gave, so the same models and
byte-equal .hbcp/.hbp files; FDR's fold backgrounds are the per-fold fits;
and a CLI job builds the index once for the background fit and EM."""

import os

import numpy as np
import pytest
import torch

from bammmotif2_tpu.models import background as jbackground
from bammmotif2_tpu.utils.fasta import SequenceSet as JSequenceSet
from bammmotif2_tpu_torch import cli, convert
from bammmotif2_tpu_torch.evaluation import fdr
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.ops import encode
from bammmotif2_tpu_torch.refinement import multi
from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from tests.test_torch_encode import ragged_set

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS = os.path.join(ROOT, "examples", "positives.fasta")
MEME = os.path.join(ROOT, "examples", "seed.meme")


def _planted_set() -> JSequenceSet:
    """Rows of one length, no ambiguous base, a motif in half of them."""
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(30)]
    seqs = [s[:20] + "TGACTCAG" + s[28:] if i % 2 else s for i, s in enumerate(seqs)]
    return JSequenceSet.from_sequences(seqs)


# the JAX package's sets; the port reads copies (convert.sequence_set)
SETS = {
    # ragged rows with N bases sprinkled in, row 3 empty and row 7 one base
    "ragged_n_empty": lambda: ragged_set("STANDARD", n=40, seed=2),
    "planted": _planted_set,
    # short rows: empty ones first and between, all-N, one base
    "short_empty_rows": lambda: JSequenceSet.from_sequences(
        ["", "ACGNTTGCA", "", "NNNN", "A", "GATTACA"]),
}


def host_index_counts(sset: SequenceSet, order: int, ss: bool) -> np.ndarray:
    """np.bincount of the host-numpy k-mer index of both strands (the set,
    then its reverse complement unless ss), the count the fit took before
    it counted on the job's device."""
    strands = [np.asarray(sset.codes)]
    if not ss:
        strands.append(encode.revcomp_codes(sset.codes, sset.lens,
                                            encode.comp_table(sset.alphabet)))
    idx = np.stack([encode.combined_kmer_index_np(c, sset.alphabet.size, order)
                    for c in strands])
    return np.bincount(idx.ravel(), minlength=encode.num_rows(sset.alphabet.size, order) + 1)


def read_bytes(paths) -> list:
    out = []
    for p in paths:
        with open(p, "rb") as fh:
            out.append(fh.read())
    return out


@pytest.mark.parametrize("which", sorted(SETS))
@pytest.mark.parametrize("ss", [False, True])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_counts_models_and_files_equal_the_host_index(tmp_path, order, ss, which):
    jset = SETS[which]()
    sset = convert.sequence_set(jset)
    C = BackgroundModel.kmer_counts(sset, order, ss)
    ref = host_index_counts(sset, order, ss)
    assert C.dtype == np.int64 and C.shape == ref.shape
    np.testing.assert_array_equal(C, ref)
    bg = BackgroundModel.from_sequence_set(sset, order=order, alpha=10.0, ss=ss, device="cpu")
    old = BackgroundModel.from_kmer_counts(ref, order, 10.0, sset.alphabet)
    jbg = jbackground.BackgroundModel.from_sequence_set(jset, order=order, alpha=10.0, ss=ss)
    for k in range(order + 1):
        np.testing.assert_array_equal(bg.v[k], old.v[k])
        np.testing.assert_array_equal(bg.counts[k], old.counts[k])
    files = read_bytes(bg.write(str(tmp_path / "new"), "bg"))
    assert files == read_bytes(old.write(str(tmp_path / "old"), "bg"))
    assert files == read_bytes(jbg.write(str(tmp_path / "jax"), "bg"))


@pytest.mark.parametrize("F", [2, 5])
@pytest.mark.parametrize("ss", [False, True])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_fold_backgrounds_equal_the_fits_to_each_folds_training_rows(order, ss, F):
    """Fold by fold, the stacked tables are from_sequence_set of the
    training rows, bit for bit (float32), on ragged rows with N bases and
    an empty row."""
    sset = convert.sequence_set(SETS["ragged_n_empty"]())
    fold_of = np.arange(sset.n) % F
    tables = fdr.fold_backgrounds(sset, fold_of, F, order, 10.0, ss, "cpu")
    assert [t.shape for t in tables] == [(F, 4 ** (o + 1)) for o in range(order + 1)]
    for f in range(F):
        fit = BackgroundModel.from_sequence_set(sset.subset(np.nonzero(fold_of != f)[0]),
                                                order=order, alpha=10.0, ss=ss)
        for o in range(order + 1):
            np.testing.assert_array_equal(tables[o][f], np.asarray(fit.v[o], np.float32).ravel())


def test_index_memo_keeps_the_two_newest_entries():
    sset = convert.sequence_set(SETS["planted"]())
    seen = [encode.strand_indices(sset, K, False, "cpu")[0] for K in (0, 1, 2)]
    memo = sset.__dict__["_torch_strand_indices"]
    assert list(memo) == [(1, False, "cpu"), (2, False, "cpu")]
    assert encode.strand_indices(sset, 2, False, torch.device("cpu"))[0] is seen[2]
    assert encode.strand_indices(sset, 0, False, "cpu")[0] is not seen[0]
    assert list(memo) == [(2, False, "cpu"), (0, False, "cpu")]


def _three_groups(path: str) -> str:
    """examples/seed.meme's motif at widths 8, 7 and 6: three (W, K)
    groups."""
    with open(MEME) as fh:
        head, body = fh.read().split("MOTIF jun_like\n")
    probs = np.array([[float(x) for x in r.split()] for r in body.strip().splitlines()[1:]])
    blocks = []
    for W in (8, 7, 6):
        lines = [f"MOTIF w{W}",
                 f"letter-probability matrix: alength= 4 w= {W} nsites= 100 E= 0"]
        blocks.append("\n".join(lines + [" ".join(f"{x:.6f}" for x in r)
                                         for r in probs[:W]]) + "\n\n")
    with open(path, "w") as fh:
        fh.write(head + "".join(blocks))
    return path


@pytest.mark.parametrize("bg_order, builds, hits", [(2, 1, 3), (1, 2, 2)],
                         ids=["bg_order_equals_motif_order", "bg_order_1"])
def test_em_job_builds_the_index_once_for_background_and_em(tmp_path, monkeypatch, bg_order,
                                                            builds, hits):
    """A CPU --EM job of three (W, K) groups at -k 2: with -K 2 the
    background fit builds the index and the three groups read it (build 1,
    hit 3), and each group's cidx is the tensor the background counted;
    with -K 1 EM builds its own (build 2, hit 2)."""
    counted, prepared = [], []
    bincount, prepare_data = torch.bincount, multi.prepare_data

    def count_of(x, *a, **k):
        counted.append(x._base)
        return bincount(x, *a, **k)

    def prepare(*a, **k):
        data = prepare_data(*a, **k)
        prepared.append(data["cidx"])
        return data

    monkeypatch.setattr(torch, "bincount", count_of)
    monkeypatch.setattr(multi, "prepare_data", prepare)
    params = cli.params_from_args([str(tmp_path / "out"), POS, "--PWMFile",
                                   _three_groups(str(tmp_path / "three.meme")), "--EM", "-k",
                                   "2", "-K", str(bg_order), "--maxEMIterations", "3",
                                   "--single-device"])
    out = cli.run_pipeline(params, "cpu")
    assert len(out["em_results"]) == 3
    groups = [s for s in out["trace"]["spans"] if s["name"] == "em.group"]
    assert sorted(g["attrs"]["W"] for g in groups) == [6, 7, 8]
    counts = dict(out["trace"]["counts"])  # beside them the EM loops' seed passes
    assert counts.pop("em.seed_passes") == sum(r.iterations for r in out["em_results"])
    assert counts.pop("em.seed_passes_skipped") == 0
    # and the numbers written to model files: the background's two tables
    # and the three refined BaMMs' two, 84 rows of W at -k 2
    assert counts.pop("write.values") == (2 * sum(4 ** (k + 1) for k in range(bg_order + 1))
                                          + 2 * 84 * (6 + 7 + 8))
    assert counts == {"kmer_index.build": builds, "kmer_index.hit": hits}
    assert len(counted) == 1 and len(prepared) == 3
    assert all(c is prepared[0] for c in prepared)
    assert (counted[0] is prepared[0]) == (bg_order == 2)
