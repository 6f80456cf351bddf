"""Port parity: the port's own copies of the host modules
(``bammmotif2_tpu_torch/utils/*``, ``io/native.py``) against the JAX
package's: FASTA parsing on the native and the pure-numpy path, the
alphabets, the sequence set, the parameters and the metrics log."""

import dataclasses
import json
import os

import numpy as np
import pytest

from bammmotif2_tpu.io import native as jnative
from bammmotif2_tpu.utils import alphabet as jalphabet
from bammmotif2_tpu.utils import config as jconfig
from bammmotif2_tpu.utils import fasta as jfasta
from bammmotif2_tpu.utils import metrics as jmetrics
from bammmotif2_tpu_torch.io import native
from bammmotif2_tpu_torch.utils import alphabet, config, fasta, metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS = os.path.join(ROOT, "examples", "positives.fasta")

# lower case, N and other ambiguous letters, ';' comments, blank lines,
# CRLF and lone-CR line ends, headerless leading data, an empty record
TRICKY = (
    "acgtNNac\r\n"
    "GGTT\n"
    "; a comment\n"
    ">first  record \r\n"
    "ACGTRYKM\n\n"
    "acgt\r"
    ">empty\n"
    ">last\n"
    "  tttt  \n"
    "cc\n"
)


def _check_same(a, b):
    np.testing.assert_array_equal(a.codes, b.codes)
    assert a.codes.dtype == b.codes.dtype == np.int8
    np.testing.assert_array_equal(a.lens, b.lens)
    assert a.lens.dtype == b.lens.dtype == np.int32
    assert a.headers == b.headers
    assert a.alphabet.name == b.alphabet.name


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "pure"])
@pytest.mark.parametrize("source", ["examples", "tricky"])
@pytest.mark.parametrize("alphabet_type", ["STANDARD", "METHYLC"])
def test_read_fasta_matches_jax(tmp_path, use_native, source, alphabet_type):
    path = POS
    if source == "tricky":
        path = str(tmp_path / "tricky.fasta")
        with open(path, "w", newline="") as fh:
            fh.write(TRICKY)
    if use_native:
        assert native.available() and jnative.available()
    ours = fasta.read_fasta(path, alphabet.Alphabet.from_type(alphabet_type), use_native=use_native)
    theirs = jfasta.read_fasta(path, jalphabet.Alphabet.from_type(alphabet_type), use_native=use_native)
    _check_same(ours, theirs)
    assert isinstance(ours.alphabet, alphabet.Alphabet)
    if source == "tricky":
        assert ours.headers == ["unnamed", "first  record", "empty", "last"]
        assert ours.lens.tolist() == [12, 12, 0, 6]


def test_native_library_lives_in_the_port():
    """The port's codec library is built into its own _build/ directory, not
    beside the JAX package's."""
    path = native._build()
    assert path is not None and os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.commonpath([path, os.path.join(ROOT, "bammmotif2_tpu_torch")]) == \
        os.path.join(ROOT, "bammmotif2_tpu_torch")


def test_read_fasta_rejects_empty_file(tmp_path):
    path = tmp_path / "empty.fasta"
    path.write_text("; only a comment\n\n")
    for use_native in (True, False):
        with pytest.raises(ValueError, match="no sequences"):
            fasta.read_fasta(str(path), use_native=use_native)


def test_write_fasta_matches_jax(tmp_path):
    seqs = ["ACGTNACGT" * 9, "", "ttgca"]
    ours = fasta.SequenceSet.from_sequences(seqs, headers=["a", "b", "c"])
    theirs = jfasta.SequenceSet.from_sequences(seqs, headers=["a", "b", "c"])
    _check_same(ours, theirs)
    fasta.write_fasta(tmp_path / "t.fa", ours, width=20)
    jfasta.write_fasta(tmp_path / "j.fa", theirs, width=20)
    assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
    back = fasta.read_fasta(str(tmp_path / "t.fa"))
    assert back.headers == ["a", "b", "c"] and back.lens.tolist() == [81, 0, 5]
    _check_same(back, jfasta.read_fasta(str(tmp_path / "j.fa")))


def test_sequence_set_methods_match_jax():
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGTN"), size=int(rng.integers(0, 30)))) for _ in range(12)]
    ours = fasta.SequenceSet.from_sequences(seqs)
    theirs = jfasta.SequenceSet.from_sequences(seqs)
    np.testing.assert_array_equal(ours.base_frequencies(), theirs.base_frequencies())
    assert (ours.n, ours.l_max, ours.min_len, ours.max_len) == \
        (theirs.n, theirs.l_max, theirs.min_len, theirs.max_len)
    idx = np.array([5, 0, 7])
    _check_same(ours.subset(idx), theirs.subset(idx))
    assert [ours.sequence_str(i) for i in range(12)] == [theirs.sequence_str(i) for i in range(12)]
    assert fasta.PAD == jfasta.PAD


@pytest.mark.parametrize("name", ["STANDARD", "METHYLC", "HYDROXYMETHYLC"])
def test_alphabet_matches_jax(name):
    a, b = alphabet.Alphabet.from_type(name), jalphabet.Alphabet.from_type(name)
    assert (a.name, a.letters, a.complements, a.size) == (b.name, b.letters, b.complements, b.size)
    text = "ACGTMHNacgtmh-x"
    np.testing.assert_array_equal(a.encode(text), b.encode(text))
    codes = a.encode(text)
    assert a.decode(codes) == b.decode(codes)
    np.testing.assert_array_equal(a.complement_code(codes), b.complement_code(codes))
    np.testing.assert_array_equal(a.revcomp(codes), b.revcomp(codes))
    np.testing.assert_array_equal(a._encode_table(), b._encode_table())
    assert a.kmer_to_index("GTA") == b.kmer_to_index("GTA")
    assert a.index_to_kmer(27, 3) == b.index_to_kmer(27, 3)
    assert alphabet.AMBIG == jalphabet.AMBIG
    with pytest.raises(ValueError):
        alphabet.Alphabet.from_type("RNA")


def test_params_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(config.Params)}
    theirs = {f.name: f.default for f in dataclasses.fields(jconfig.Params)}
    assert ours == theirs
    assert dataclasses.asdict(config.Params()) == dataclasses.asdict(jconfig.Params())
    p, jp = config.Params(modelBeta=5.0, modelGamma=2.0), jconfig.Params(modelBeta=5.0, modelGamma=2.0)
    assert [p.alpha_for_order(k) for k in range(6)] == [jp.alpha_for_order(k) for k in range(6)]


def test_metrics_log_matches_jax(tmp_path):
    logs = {}
    for tag, mod in (("t", metrics), ("j", jmetrics)):
        path = str(tmp_path / f"{tag}.jsonl")
        with mod.MetricsLogger(path) as log:
            log.event("em_done", motif="m1", iterations=np.int64(3), ll=np.float32(1.5),
                      hist=np.arange(3))
        mod.MetricsLogger(None).event("ignored", x=1)  # disabled: a no-op
        with open(path) as fh:
            logs[tag] = [json.loads(ln) for ln in fh]
    for e in logs.values():
        e[0].pop("t")
    assert logs["t"] == logs["j"] == [{"event": "em_done", "motif": "m1", "iterations": 3,
                                       "ll": 1.5, "hist": [0, 1, 2]}]
