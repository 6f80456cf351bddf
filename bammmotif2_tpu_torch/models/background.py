"""Homogeneous background Markov model.

Port of ``bammmotif2_tpu.models.background``.  Counts all k-mers
(k <= K_bg + 1) over a sequence set with one bincount of the combined
k-mer index on the job's device, then applies on the host (numpy float64)
the interpolated pseudo-count recurrence with a single strength A:

    v_bg^(k)(y) = ( n(y) + A * v_bg^(k-1)(y') ) / ( n(x) + A )

with base case v_bg^(0)(a) = (n(a) + A/|A|) / (N + A).

File IO: ``.hbcp`` (conditional probs, loadable via --bgModelFile) and
``.hbp`` (full k-mer probs); a write adds the numbers it formats to the
run's counter ``write.values`` (``utils.metrics``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.ops import encode
from bammmotif2_tpu_torch.utils.metrics import count

_FLOAT_FMT = "%.6e"


class BackgroundModel:
    """Host-side container; arrays are numpy float64 for IO fidelity."""

    def __init__(
        self,
        order: int,
        alpha: float,
        v: list,
        counts: list | None = None,
        alphabet: Alphabet | None = None,
        name: str = "bg",
    ):
        self.order = order
        self.alpha = float(alpha)
        self.v = [np.asarray(vk, dtype=np.float64) for vk in v]
        self.counts = counts
        self.alphabet = alphabet or Alphabet.standard()
        self.name = name

    @staticmethod
    def from_sequence_set(
        sset: SequenceSet, order: int = 2, alpha: float = 10.0, ss: bool = False,
        device="cpu",
    ) -> "BackgroundModel":
        """Count k-mers over the set (both strands unless ss) on ``device``
        and estimate v on the host."""
        C = BackgroundModel.kmer_counts(sset, order, ss, device)
        return BackgroundModel.from_kmer_counts(C, order, alpha, sset.alphabet)

    @staticmethod
    def kmer_counts(sset: SequenceSet, order: int, ss: bool, device="cpu") -> np.ndarray:
        """int64 [R + 1]: how often each combined k-mer row indexes a
        position of the set (strands: the set, then its reverse complement
        unless ss), the sentinel R last (positions past a row's end or
        ambiguous).  One bincount on ``device`` of the set's memoised
        ``encode.strand_indices``, which EM reads too."""
        R = encode.num_rows(sset.alphabet.size, order)
        cidx, _lens = encode.strand_indices(sset, order, ss, device)
        return torch.bincount(cidx.ravel(), minlength=R + 1).cpu().numpy()

    @staticmethod
    def from_kmer_counts(C: np.ndarray, order: int, alpha: float,
                         alphabet: Alphabet) -> "BackgroundModel":
        """The model of integer counts C [R + 1] of the combined k-mer index
        (the sentinel's last)."""
        A = alphabet.size
        C = np.asarray(C).astype(np.float64)[: encode.num_rows(A, order)]
        counts = _per_order_counts(C, A, order)
        v = _interpolated_v(counts, A, order, alpha)
        return BackgroundModel(order, alpha, v, counts=counts, alphabet=alphabet)

    def full_probs(self) -> list:
        """p^(k)(y): joint probability of each (k+1)-mer (for .hbp)."""
        A = self.alphabet.size
        p = [self.v[0].copy()]
        for k in range(1, self.order + 1):
            p.append(np.repeat(p[k - 1], A) * self.v[k])
        return p

    def conditional_flat(self, K_model: int) -> np.ndarray:
        """Background conditional for every combined-LUT row of a motif of
        order ``K_model``: row (order k, kmer y) gets
        v_bg^(min(k, K_bg))(last base | the min(k, K_bg) preceding bases).
        """
        A = self.alphabet.size
        out = []
        for k in range(K_model + 1):
            kb = min(k, self.order)
            y = np.arange(A ** (k + 1))
            out.append(self.v[kb][y % (A ** (kb + 1))])
        return np.concatenate(out)

    def write(self, outdir: str, basename: str | None = None) -> tuple:
        base = basename or self.name
        os.makedirs(outdir, exist_ok=True)
        p_cond = os.path.join(outdir, base + ".hbcp")
        p_full = os.path.join(outdir, base + ".hbp")
        self._write_file(p_cond, self.v)
        self._write_file(p_full, self.full_probs())
        return p_cond, p_full

    def _write_file(self, path: str, tables: list) -> None:
        with open(path, "w") as fh:
            fh.write(f"# K = {self.order}\n")
            fh.write(f"# A = {self.alpha:.6f}\n")
            for tab in tables:
                fh.write(" ".join(_FLOAT_FMT % x for x in tab) + "\n")
        count("write.values", sum(len(tab) for tab in tables))

    @staticmethod
    def read(path: str, alphabet: Alphabet | None = None) -> "BackgroundModel":
        """Read a ``.hbcp`` file (``--bgModelFile``): two '#'-header lines
        (K, A) followed by one line per order."""
        alphabet = alphabet or Alphabet.standard()
        order, alpha = None, 10.0
        rows = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("#"):
                    body = line.lstrip("#").strip()
                    if "=" in body:
                        key, val = (s.strip() for s in body.split("=", 1))
                        if key.upper() == "K":
                            order = int(val)
                        elif key.upper() == "A":
                            alpha = float(val)
                    continue
                rows.append(np.array([float(x) for x in line.split()]))
        if order is None:
            order = len(rows) - 1
        if len(rows) != order + 1:
            raise ValueError(
                f"{path}: expected {order + 1} probability lines, got {len(rows)}"
            )
        A = alphabet.size
        for k, row in enumerate(rows):
            if row.size != A ** (k + 1):
                raise ValueError(
                    f"{path}: order-{k} line has {row.size} values, want {A ** (k + 1)}"
                )
        return BackgroundModel(order, alpha, rows, alphabet=alphabet)


def _per_order_counts(C_flat: np.ndarray, A: int, K: int) -> list:
    """Split combined-row counts into per-order totals: direct counts of
    exactly order k plus the order-(k+1) counts marginalized over the
    oldest base."""
    off = encode.order_offsets(A, K)
    direct = [C_flat[off[k] : off[k + 1]].copy() for k in range(K + 1)]
    counts = [None] * (K + 1)
    counts[K] = direct[K]
    for k in range(K - 1, -1, -1):
        counts[k] = direct[k] + counts[k + 1].reshape(A, -1).sum(axis=0)
    return counts


def _interpolated_v(counts: list, A: int, K: int, alpha: float) -> list:
    v = []
    n0 = counts[0]
    N = n0.sum()
    v.append((n0 + alpha / A) / (N + alpha))
    for k in range(1, K + 1):
        nk = counts[k]
        ctx = nk.reshape(-1, A).sum(axis=1)  # context counts (sum newest base)
        lower = v[k - 1][np.arange(A ** (k + 1)) % (A ** k)]
        denom = np.repeat(ctx, A) + alpha
        v.append((nk + alpha * lower) / denom)
    return v
