"""Port parity: the combined k-mer index (ops/encode.py) against the JAX
package, bit for bit."""

import numpy as np
import pytest
import torch

from bammmotif2_tpu.ops import encode as jencode
from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.fasta import SequenceSet
from bammmotif2_tpu_torch import convert
from bammmotif2_tpu_torch.ops import encode

torch.set_num_threads(1)


def ragged_set(alphabet_name: str, n=25, seed=0) -> SequenceSet:
    """Ragged rows (one of length 0, one of length 1) over the alphabet,
    with ambiguous letters sprinkled in; PAD fills past each length."""
    rng = np.random.default_rng(seed)
    alphabet = Alphabet.from_type(alphabet_name)
    letters = np.array(list(alphabet.letters + "N"))
    p = np.full(len(letters), 0.9 / alphabet.size)
    p[-1] = 0.1
    seqs = ["".join(rng.choice(letters, size=int(rng.integers(2, 40)), p=p)) for _ in range(n)]
    seqs[3], seqs[7] = "", "A"
    return SequenceSet.from_sequences(seqs, alphabet=alphabet)


@pytest.mark.parametrize("alphabet", ["STANDARD", "METHYLC"])
@pytest.mark.parametrize("ss", [False, True])
@pytest.mark.parametrize("K", [0, 1, 2, 3, 4, 5])
def test_strand_indices_match_jax(K, ss, alphabet):
    sset = ragged_set(alphabet, seed=K)
    cidx, lens = encode.strand_indices(convert.sequence_set(sset), K, ss, device="cpu")
    jcidx, jlens = jencode.strand_indices(sset, K, ss)
    assert cidx.dtype == torch.int32 and lens.dtype == torch.int32
    np.testing.assert_array_equal(cidx.numpy(), np.asarray(jcidx))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    # AMBIG and PAD positions land in the sentinel row R
    R = encode.num_rows(sset.alphabet.size, K)
    np.testing.assert_array_equal(cidx[0].numpy() == R, sset.codes < 0)


@pytest.mark.parametrize("alphabet", ["STANDARD", "METHYLC"])
@pytest.mark.parametrize("K", [0, 2, 5])
def test_host_encoders_match_jax(K, alphabet):
    sset = ragged_set(alphabet, seed=10 + K)
    A = sset.alphabet.size
    comp = encode.comp_table(convert.alphabet(sset.alphabet))
    np.testing.assert_array_equal(comp, jencode.comp_table(sset.alphabet))
    rc = encode.revcomp_codes(sset.codes, sset.lens, comp)
    np.testing.assert_array_equal(rc, jencode.revcomp_codes(sset.codes, sset.lens, comp))
    assert rc.dtype == np.int8
    for codes in (sset.codes, rc):
        np.testing.assert_array_equal(
            encode.combined_kmer_index_np(codes, A, K),
            jencode.combined_kmer_index_np(codes, A, K),
        )
    assert np.array_equal(encode.order_offsets(A, K), jencode.order_offsets(A, K))
    assert encode.num_rows(A, K) == jencode.num_rows(A, K)
