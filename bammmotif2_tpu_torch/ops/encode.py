"""k-mer index tensors: the device-side sequence representation.

Port of ``bammmotif2_tpu.ops.encode``.  Every conditional-probability table
of every order k <= K lives in ONE combined LUT with rows grouped by order;
order k's block starts at off[k] = sum_{m<k} A^(m+1).  The index tensor

    cidx[n, t] = off[m(t)] + kmer_code_{m(t)}(n, t)     (int32)

with m(t) = min(t, K, #consecutive unambiguous bases ending just before t)
turns window scoring into a gather against the combined LUT and the EM
M-step into the transposed scatter.  Invalid positions (ambiguous current
base, padding) index the trailing sentinel row ``R``.

The flat-layout passes (``ops.cuda_flat``) read base-(A+1) codes instead
(``base5_kmer_index``, ``strand_base5_indices``), and the static map
``map_base5_to_combined`` takes each to its combined row.

``strand_indices`` memoises a set's index on the set, so the background
fit (``models.background``) and the EM data (``refinement.em.prepare_data``)
count and read one tensor.  The numpy entry points
(``combined_kmer_index_np``, ``revcomp_codes``) run the same torch code on
CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.utils.metrics import count


def order_offsets(A: int, K: int) -> np.ndarray:
    """off[k] for k = 0..K+1; off[K+1] == R == total #rows excl. sentinel."""
    sizes = [A ** (k + 1) for k in range(K + 1)]
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


@functools.cache
def num_rows(A: int, K: int) -> int:
    """R: number of combined-LUT rows excluding the sentinel row (cached:
    the flat wrappers check it on every call)."""
    return int(order_offsets(A, K)[-1])


def combined_kmer_index(codes: torch.Tensor, A: int, K: int) -> torch.Tensor:
    """Compute cidx[n, t] for an integer code tensor [N, L].

    codes: >=0 concrete letter, -1 ambiguous, -2 pad.
    Returns int32 [N, L] on the same device; invalid positions = R.
    """
    codes = codes.to(torch.int32)
    valid = codes >= 0
    base = torch.where(valid, codes, 0)
    N, L = codes.shape
    off = order_offsets(A, K)
    R = int(off[-1])

    # shifted(x, d)[:, t] = x[:, t-d]  (fill before the sequence start)
    def shift(x, d, fill):
        if d == 0:
            return x
        head = torch.full((N, min(d, L)), fill, dtype=x.dtype, device=x.device)
        return torch.cat([head, x[:, : max(L - d, 0)]], dim=1)

    # m(t): longest context of unambiguous bases ending at t-1, capped at K
    # and at t (no context before the sequence start).
    t = torch.arange(L, device=codes.device)[None, :]
    m = torch.zeros((N, L), dtype=torch.int32, device=codes.device)
    ctx_ok = torch.ones((N, L), dtype=torch.bool, device=codes.device)
    for d in range(1, K + 1):
        ctx_ok = ctx_ok & shift(valid, d, False)
        m = torch.where(ctx_ok & (t >= d), d, m)

    # y_k(t): lexicographic (k+1)-mer code for each candidate order
    cidx = int(off[0]) + base
    acc = base
    for k in range(1, K + 1):
        acc = acc + shift(base, k, 0) * (A ** k)
        cidx = torch.where(m >= k, int(off[k]) + acc, cidx)
    return torch.where(valid, cidx, R).to(torch.int32)


def combined_kmer_index_np(codes: np.ndarray, A: int, K: int) -> np.ndarray:
    """Host-numpy combined_kmer_index (the same torch code on the CPU)."""
    return combined_kmer_index(torch.from_numpy(np.asarray(codes)), A, K).numpy()


def base5_kmer_index(codes: torch.Tensor, A: int, K: int) -> torch.Tensor:
    """qidx[n, t]: the (A+1)-ary code of the K+1 bases ending at t.

    Digit d (weight (A+1)^d) is the base at t-d; the extra symbol ``A``
    stands for "no base" (ambiguous, padding, or before the sequence
    start).  Every combined-LUT row is ``map_base5_to_combined(A, K)[qidx]``
    (== combined_kmer_index), so order truncation is a static map rather
    than logic in the kernels (ops.cuda_flat).  Returns int32 [N, L] on
    the codes' device, values in [0, (A+1)^(K+1)).
    """
    codes = codes.to(torch.int32)
    N, L = codes.shape
    sym = torch.where(codes >= 0, codes, A)
    out = sym
    for d in range(1, K + 1):
        head = torch.full((N, min(d, L)), A, dtype=torch.int32, device=codes.device)
        out = out + torch.cat([head, sym[:, : max(L - d, 0)]], dim=1) * (A + 1) ** d
    return out


def map_base5_to_combined(A: int, K: int) -> np.ndarray:
    """Static lookup int32 [(A+1)^(K+1)] -> combined-LUT row in [0, R].

    The order-truncation rule of ``combined_kmer_index`` in the base-(A+1)
    code space: current base absent -> sentinel row R; otherwise the
    effective order m is the longest run of present context digits
    1..m (m <= K), and the row is off[m] + the lexicographic code of the
    (m+1)-mer (the base at t-m most significant).
    """
    B = A + 1
    off = order_offsets(A, K)
    R = int(off[-1])
    c = np.arange(B ** (K + 1), dtype=np.int64)
    digits = [(c // B ** d) % B for d in range(K + 1)]  # digit d = base at t-d
    m = np.zeros_like(c)
    run = np.ones(c.shape, bool)
    for d in range(1, K + 1):
        run &= digits[d] != A
        m += run
    y = np.zeros_like(c)
    for d in range(K + 1):
        y += np.where(d <= m, digits[d] * A ** d, 0)
    return np.where(digits[0] == A, R, off[m] + y).astype(np.int32)


def comp_table(alphabet) -> np.ndarray:
    """int8 complement lookup table for an Alphabet (letter i -> index of
    its complement letter)."""
    return np.array(
        [alphabet.letters.index(c) for c in alphabet.complements],
        dtype=np.int8,
    )


def revcomp_codes_device(
    codes: torch.Tensor, lens: torch.Tensor, comp: torch.Tensor
) -> torch.Tensor:
    """Batch reverse complement on the tensors' device.

    rc[n, t] = complement(codes[n, lens[n]-1-t]) for t < lens[n], PAD after;
    AMBIG (-1) complements to AMBIG.
    """
    N, L = codes.shape
    t = torch.arange(L, device=codes.device)[None, :]
    src = lens.to(torch.int64)[:, None] - 1 - t
    in_range = src >= 0
    gathered = torch.gather(codes, 1, src.clamp(0, max(L - 1, 0)))
    comp_idx = gathered.to(torch.int64).clamp(0, comp.shape[0] - 1)
    rc = torch.where(gathered >= 0, comp.to(codes.dtype)[comp_idx], gathered)
    return torch.where(in_range, rc, -2).to(torch.int8)


def revcomp_codes(codes: np.ndarray, lens: np.ndarray, comp: np.ndarray) -> np.ndarray:
    """Host-side reverse complement of a padded code batch (numpy in/out)."""
    return revcomp_codes_device(
        torch.from_numpy(np.asarray(codes, np.int8)),
        torch.from_numpy(np.asarray(lens)),
        torch.from_numpy(np.asarray(comp, np.int8)),
    ).numpy()


def strand_indices(sset: SequenceSet, K: int, ss: bool, device) -> tuple:
    """Per-strand combined k-mer index tensors for a SequenceSet.

    Returns (cidx [S, N, L] int32, lens [N] int32) on ``device``, with
    S = 1 for single-strand (--ss) or 2 (forward, reverse-complement).
    Memoised on the set under (K, ss, device), keeping the 2 newest
    entries; the counters ``kmer_index.build`` and ``kmer_index.hit`` say
    which.  The memo has its own attribute, apart from the JAX package's,
    so one SequenceSet can feed both packages.  Callers never mutate the
    returned tensors.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cache = sset.__dict__.setdefault("_torch_strand_indices", {})
    key = (K, ss, str(device))
    hit = cache.get(key)
    if hit is not None:
        count("kmer_index.hit")
        return hit
    count("kmer_index.build")
    while len(cache) >= 2:
        cache.pop(next(iter(cache)))
    A = sset.alphabet.size
    strands, lens = _strand_codes(sset, ss, device)
    cidx = torch.stack([combined_kmer_index(c, A, K) for c in strands])
    hit = cache[key] = (cidx, lens)
    return hit


def strand_base5_indices(sset: SequenceSet, K: int, ss: bool, device) -> torch.Tensor:
    """Per-strand base-(A+1) k-mer codes, int32 [S, N, L] on ``device``
    (see base5_kmer_index); S as in strand_indices."""
    A = sset.alphabet.size
    strands, _lens = _strand_codes(sset, ss, device)
    return torch.stack([base5_kmer_index(c, A, K) for c in strands])


def _strand_codes(sset: SequenceSet, ss: bool, device) -> tuple:
    """([forward codes (+ reverse complement unless ss)], lens) on ``device``."""
    codes = torch.as_tensor(np.asarray(sset.codes, np.int8), device=device)
    lens = torch.as_tensor(np.asarray(sset.lens, np.int32), device=device)
    strands = [codes]
    if not ss:
        comp = torch.as_tensor(comp_table(sset.alphabet), device=device)
        strands.append(revcomp_codes_device(codes, lens, comp))
    return strands, lens
