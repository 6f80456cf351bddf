"""Occurrence scanning: log-odds scores, empirical p-values, .occurrence.

Port of ``bammmotif2_tpu.scoring.scan`` (``ScoreSeqSet::calcLogOdds``,
``calcPvalues``, ``write``).  Sequences scan in B-row chunks of a code
tensor uploaded once; each chunk is sliced, reverse-complemented, encoded
and scored by the window-score kernel (``ops.cuda_scores``) for every seed
of a (W, K) group at once, and reduced (ZOOPS maxima, valid-window count) on
the device.  The full [M, S, N, n_win] score tensor is retained only below a
fixed budget (``keep_bytes``); larger sets re-score one seed plane chunk by
chunk on demand, so device memory stays bounded by one chunk.

The data path is the kernel for CUDA tensors unless ``use_pallas`` is False
(``--no-pallas``), and the plain PyTorch version otherwise
(``refinement.em.choose_path``).

p-value convention: for a score s against M sorted negative scores,
p(s) = (M - frac(s) + 1) / (M + 1) with frac = #neg < s, except inside a tie
block, where frac is the block's midpoint rank; e-value = p * (#windows
scanned in the dataset).  One implementation: ``_pvalues_from_ranks``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.device import resolve
from bammmotif2_tpu_torch.utils.fasta import PAD, SequenceSet
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import Motif, log_odds_lut
from bammmotif2_tpu_torch.ops import cuda_scores, encode, escore
from bammmotif2_tpu_torch.refinement.em import choose_path

# retain chunk score tensors on the device only below this total (bytes);
# larger sets stream (re-score on demand) so device memory stays chunk-bounded
KEEP_BYTES = 256 << 20


@dataclasses.dataclass
class ScanResult:
    """Per-sequence reductions + chunked access to window scores.

    ``iter_chunks`` yields ``(row0, scores [S, n, n_win], mask [n, n_win])``
    device tensors: from the retained tensors for small sets, by re-scoring
    for large ones.  Results from one ``score_set_multi`` group SHARE the
    retained stacked [M, S, n, n_win] chunk tensors (``_mi`` selects this
    result's seed plane).
    """

    max_scores: np.ndarray  # [N] best window per sequence (ZOOPS statistic)
    n_windows: int          # total valid windows scanned
    W: int
    _chunks: list | None = None     # retained (row0, scores, mask) triples
    _rescan: object = None          # () -> iterator of (row0, scores, mask)
    _mi: int | None = None          # seed index into shared stacked chunks

    def iter_chunks(self):
        if self._chunks is not None:
            for row0, sc, mk in self._chunks:
                yield row0, (sc if self._mi is None else sc[self._mi]), mk
        else:
            yield from self._rescan()

    @property
    def scores(self) -> np.ndarray:
        """Full [S, N, n_win_max] host score tensor (NEG_INF on invalid).

        An empty chunk list gives S = 2 whenever the set has rows, also for
        a single-strand scan: the reference's convention, kept for parity
        (ROADMAP C).
        """
        chunks = [(r, sc.cpu().numpy(), mk) for r, sc, mk in self.iter_chunks()]
        if not chunks:
            S = 1 if self.max_scores.size == 0 else 2
            return np.zeros((S, self.max_scores.size, 0), np.float32)
        n_win_max = max(c[1].shape[2] for c in chunks)

        def padw(x):
            p = n_win_max - x.shape[-1]
            return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, p)],
                          constant_values=escore.NEG_INF) if p else x

        return np.concatenate([padw(c[1]) for c in chunks], axis=1)

    @property
    def mask(self) -> np.ndarray:
        chunks = [mk.cpu().numpy() for _r, _sc, mk in self.iter_chunks()]
        if not chunks:
            return np.zeros((self.max_scores.size, 0), bool)
        n_win_max = max(c.shape[1] for c in chunks)
        return np.concatenate(
            [np.pad(c, [(0, 0), (0, n_win_max - c.shape[1])]) for c in chunks], axis=0
        )

    def all_window_scores(self) -> np.ndarray:
        """Valid per-window scores pooled over strands (MOPS statistic)."""
        out = [sc[mk[None].expand_as(sc)].cpu().numpy() for _r, sc, mk in self.iter_chunks()]
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def window_pool_device(self):
        """Per-window score pool as a device tensor, never fetched.

        Returns (ascending-sorted f32 tensor whose first ``size - n_windows``
        entries are NEG_INF padding, n_windows).  ``find_occurrences``
        ranks against it on the device.  The pool is allocated once at its
        final size and filled chunk by chunk, so peak memory is the pool plus
        one chunk and the sort's workspace.
        """
        pool, at = None, 0
        for _row0, sc, mk in self.iter_chunks():
            part = torch.where(mk[None], sc, escore.NEG_INF).reshape(-1)
            if pool is None:
                total = sc.shape[0] * self.max_scores.size * sc.shape[2]
                pool = torch.empty(total, dtype=torch.float32, device=sc.device)
            pool[at : at + part.numel()] = part
            at += part.numel()
        if pool is None:
            return torch.zeros(0, dtype=torch.float32), self.n_windows
        return torch.sort(pool[:at]).values, self.n_windows


def _stacked_luts(motifs: list, bg: BackgroundModel, device) -> torch.Tensor:
    """[M, R+1, W] combined log-odds LUTs for a (W, K, A) group."""
    K, W, A = motifs[0].K, motifs[0].W, motifs[0].A
    if not all((m.K, m.W, m.A) == (K, W, A) for m in motifs):
        raise ValueError("score_set_multi needs motifs of one (W, K, alphabet)")
    bg_flat = torch.as_tensor(bg.conditional_flat(K), dtype=torch.float32, device=device)
    return torch.stack([
        log_odds_lut(tuple(torch.as_tensor(v, dtype=torch.float32, device=device) for v in m.v),
                     bg_flat)
        for m in motifs
    ]).contiguous()


def score_fn(path: str):
    """The window-score op of a path: the kernel or its plain version."""
    return cuda_scores.window_scores_multi if path == "cuda" else cuda_scores.window_scores_multi_ref


def _score_chunk_device(s_flat, codes, lens, comp, start: int, *,
                        A: int, K: int, B: int, ss: bool, path: str):
    """Score one B-row chunk of a device-resident code tensor.

    Row slice, reverse complement, combined k-mer encoding, the seed-stacked
    window scores, and the per-chunk reductions.  Returns (scores
    [M, S, B, n_win], mask [B, n_win], maxima [M, B], valid-window count).
    """
    codes_c = codes[start : start + B]
    lens_c = lens[start : start + B]
    strands = [codes_c]
    if not ss:
        strands.append(encode.revcomp_codes_device(codes_c, lens_c, comp))
    cidx = torch.stack([encode.combined_kmer_index(c, A, K) for c in strands])
    sc, mk = score_fn(path)(s_flat, cidx, lens_c)
    return sc, mk, sc.amax(dim=(1, 3)), mk.sum()


def _device_codes(sset: SequenceSet, B: int, device):
    """Upload the set's codes ONCE, padded to a whole number of B-chunks.

    Returns (codes [N_pad, L] int8, lens [N_pad] int32, comp_table,
    n_chunks) on ``device``.  Pad rows are PAD codes with length 0: they
    score NEG_INF, mask False, and count nothing.

    Memoized on the SequenceSet instance under (B, device), keeping the 2
    newest, in an attribute apart from the JAX package's.  Like the
    reference's memo it assumes the set's codes are never mutated (ROADMAP
    C).
    """
    device = torch.device(device)
    cache = sset.__dict__.setdefault("_torch_device_codes_cache", {})
    key = (B, str(device))
    hit = cache.get(key)
    if hit is not None:
        return hit
    while len(cache) >= 2:
        cache.pop(next(iter(cache)))
    N = sset.n
    n_chunks = -(-N // B) if N else 0
    pad = n_chunks * B - N
    codes = np.pad(np.asarray(sset.codes, np.int8), ((0, pad), (0, 0)), constant_values=PAD)
    lens = np.pad(np.asarray(sset.lens, np.int32), (0, pad))
    out = (
        torch.as_tensor(codes, device=device), torch.as_tensor(lens, device=device),
        torch.as_tensor(encode.comp_table(sset.alphabet), device=device), n_chunks,
    )
    cache[key] = out
    return out


def score_set_multi(
    motifs: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    ss: bool = False,
    batch: int = 16384,
    keep_bytes: int = KEEP_BYTES,
    device=None,
    use_pallas: bool = True,
) -> list:
    """score_set for several motifs of equal (W, K) in ONE stacked pass.

    Every chunk's codes are encoded once and scored for all M motifs by one
    window-score launch: the seed-stacked form of the reference driver's
    per-motif ``ScoreSeqSet::calcLogOdds`` loop.  Returns a list of
    ScanResult aligned with ``motifs``.  When the retained-chunk budget is
    exceeded, each result's ``iter_chunks`` re-scores its own seed plane
    (never all M per chunk).  ``device``: None runs on the current CUDA
    device; pass "cpu" for the CPU.
    """
    device = resolve(device)
    M = len(motifs)
    K, W, A = motifs[0].K, motifs[0].W, motifs[0].A
    S = 1 if ss else 2
    N = sset.n
    L_pad = sset.codes.shape[1] if N else 0
    if N == 0 or L_pad < W:
        # no sequence can host a window (or the set is empty)
        return [
            ScanResult(max_scores=np.full(N, escore.NEG_INF, np.float32),
                       n_windows=0, W=W, _chunks=[], _mi=i)
            for i in range(M)
        ]
    s_flat = _stacked_luts(motifs, bg, device)
    path = choose_path(Params(use_pallas=use_pallas), device)
    # the retained tensors' window axis is set by the PADDED length, not by
    # lens.max(): a subset of short rows from a wide-padded set would
    # otherwise under-estimate the budget by orders of magnitude
    n_win_pad = L_pad - W + 1
    retain = 4 * M * S * N * n_win_pad <= keep_bytes

    B = max(1, min(batch, N))
    codes_dev, lens_dev, comp_dev, n_chunks = _device_codes(sset, B, device)
    statics = dict(A=A, K=K, B=B, ss=ss, path=path)

    chunks: list | None = [] if retain else None
    mxs, cnts = [], []
    for ci in range(n_chunks):
        sc, mk, mx, cnt = _score_chunk_device(s_flat, codes_dev, lens_dev, comp_dev,
                                              ci * B, **statics)
        n = min(B, N - ci * B)
        if retain:
            if n < B:
                sc, mk = sc[:, :, :n], mk[:n]
            chunks.append((ci * B, sc, mk))
        mxs.append(mx[:, :n])
        cnts.append(cnt)
    max_scores = torch.cat(mxs, dim=1).cpu().numpy()
    n_valid = int(torch.stack(cnts).sum()) * S

    def make_rescan(i):
        # streamed sets re-score ONLY seed i per chunk: all-M rescans would
        # make the CLI's per-motif occurrence loop O(M^2) scoring passes
        def rescan():
            sf = s_flat[i : i + 1]
            for ci in range(n_chunks):
                sc, mk, _mx, _cnt = _score_chunk_device(sf, codes_dev, lens_dev, comp_dev,
                                                        ci * B, **statics)
                n = min(B, N - ci * B)
                yield ci * B, sc[0, :, :n], mk[:n]

        return rescan

    return [
        ScanResult(
            max_scores=max_scores[i],
            n_windows=n_valid,
            W=W,
            _chunks=chunks if retain else None,
            _rescan=make_rescan(i) if not retain else None,
            _mi=i if retain else None,
        )
        for i in range(M)
    ]


def score_set(
    motif: Motif,
    bg: BackgroundModel,
    sset: SequenceSet,
    ss: bool = False,
    batch: int = 16384,
    keep_bytes: int = KEEP_BYTES,
    device=None,
    use_pallas: bool = True,
) -> ScanResult:
    """Log-odds-score every window of every sequence (ScoreSeqSet::calcLogOdds):
    ``score_set_multi`` with one motif."""
    device = resolve(device)
    return score_set_multi([motif], bg, sset, ss=ss, batch=batch, keep_bytes=keep_bytes,
                           device=device, use_pallas=use_pallas)[0]


def _pvalues_from_ranks(lo: np.ndarray, hi: np.ndarray, M: int) -> np.ndarray:
    """p-values from integer negative-pool ranks, float64 host math.

    ``lo`` = #neg strictly below s, ``hi`` = #neg <= s: frac is lo except
    inside a tie block, where the block's midpoint rank is used so tied
    negatives don't quantize small p-values.
    """
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    frac = np.where(hi > lo, 0.5 * (lo + hi), lo)
    p = (M - frac + 1.0) / (M + 1.0)
    return np.clip(p, 1.0 / (M + 1.0), 1.0)


def empirical_pvalues(scores: np.ndarray, neg_scores: np.ndarray) -> np.ndarray:
    """Empirical p-values by rank against a negative score sample
    (``ScoreSeqSet::calcPvalues``), with the rank convention of
    ``_pvalues_from_ranks``."""
    neg = np.sort(np.asarray(neg_scores, np.float64))
    M = neg.size
    if M == 0:
        return np.full(np.shape(scores), 1.0)
    s = np.asarray(scores, np.float64)
    lo = np.searchsorted(neg, s, side="left")    # #neg strictly below s
    hi = np.searchsorted(neg, s, side="right")   # #neg <= s
    return _pvalues_from_ranks(lo, hi, M)


@dataclasses.dataclass
class Occurrence:
    seq_idx: int
    header: str
    length: int
    strand: str       # '+' or '-'
    start: int        # 0-based inclusive, forward-strand coordinates
    end: int          # 0-based exclusive
    site: str
    score: float
    pvalue: float
    evalue: float


def find_occurrences(
    scan: ScanResult,
    sset: SequenceSet,
    neg_scores,
    pval_cutoff: float = 1e-4,
) -> list:
    """Windows with p-value below the cutoff, as occurrence records.

    ``neg_scores`` is the negatives' PER-WINDOW score pool: a host array
    (``ScanResult.all_window_scores()``) or the negatives' ScanResult itself,
    whose pool then sorts and ranks on the device (``window_pool_device``).
    Streams chunk by chunk: only candidate windows are ranked, and only hit
    rows cross to the host.  Reverse-strand windows are reported in forward
    coordinates (start = len - W - i for rc-window start i).
    """
    W = scan.W
    if isinstance(neg_scores, ScanResult):
        neg, M = neg_scores.window_pool_device()  # pads sort first (asc)
        pad = int(neg.numel()) - M
    else:
        # a host pool sorts on the CPU and moves to the scores' device below
        neg = torch.sort(torch.as_tensor(np.asarray(neg_scores, np.float32))).values
        M = int(neg.numel())
        pad = 0
    if int(neg.numel()) >= 2**31:
        raise ValueError("negative window pool exceeds int32 rank range")

    if M > 0 and pval_cutoff < 1.0 / (M + 1.0):
        return []  # pv is clipped to >= 1/(M+1): nothing can pass

    # conservative score cutoff from the p-value cutoff: pv is monotone
    # non-increasing in score, and pv(s) >= (M - hi(s) + 1) / (M + 1) with
    # hi(s) = #neg <= s, so pv <= cutoff requires hi(s) >= k =
    # M + 1 - cutoff * (M + 1): only windows scoring at or above the k-th
    # smallest negative can pass, and only they are ranked
    if M > 0 and pval_cutoff < 1.0:
        k = int(np.clip(np.ceil((M + 1) * (1.0 - pval_cutoff)), 1, M))
        s_cut = float(neg[pad + k - 1])  # an f32 value, exact as a float
    else:
        # cutoff >= 1 admits pv == 1, and an empty pool gives pv == 1
        # everywhere: no prefilter possible
        s_cut = float("-inf")

    occs: list = []
    for row0, sc, mask in scan.iter_chunks():
        S, n, n_win = sc.shape
        neg = neg.to(sc.device)
        cand = (mask[None].expand_as(sc) & (sc >= s_cut)).reshape(-1)
        flat_dev = torch.nonzero(cand).reshape(-1)
        if flat_dev.numel() == 0:
            continue
        sc_c = sc.reshape(-1)[flat_dev]
        lo = torch.clamp(torch.searchsorted(neg, sc_c, right=False) - pad, 0, M)
        hi = torch.clamp(torch.searchsorted(neg, sc_c, right=True) - pad, 0, M)
        pv_c = _pvalues_from_ranks(lo.cpu().numpy(), hi.cpu().numpy(), M)
        keep = pv_c <= pval_cutoff
        if not keep.any():
            continue
        flat = flat_dev.cpu().numpy()[keep]
        hit_scores = sc_c.cpu().numpy()[keep]
        hit_pv = pv_c[keep]
        s_i, n_i, i_i = np.unravel_index(flat, (S, n, n_win))

        for s, nn, i, score, p in zip(s_i, n_i, i_i, hit_scores, hit_pv):
            gi = row0 + int(nn)
            L = int(sset.lens[gi])
            if s == 0:
                start, strand = int(i), "+"
                site = sset.alphabet.decode(sset.codes[gi, start : start + W])
            else:
                start, strand = L - W - int(i), "-"
                site = sset.alphabet.decode(
                    sset.alphabet.revcomp(sset.codes[gi, start : start + W])
                )
            occs.append(Occurrence(
                seq_idx=gi, header=sset.headers[gi], length=L, strand=strand,
                start=start, end=start + W, site=site, score=float(score),
                pvalue=float(p), evalue=float(p * scan.n_windows),
            ))
    occs.sort(key=lambda o: (o.seq_idx, o.start, o.strand))
    return occs


def write_logodds(path: str | os.PathLike, scan: ScanResult, sset: SequenceSet) -> int:
    """Per-window log-odds dump (``--saveLogOdds`` -> <basename>.logOdds).

    One TSV row per VALID window: sequence header, strand, 1-based
    forward-coordinate start, log-odds score.  Streams chunk by chunk.
    Returns the number of window rows written.
    """
    W = scan.W
    n_rows = 0
    with open(path, "w") as fh:
        fh.write("header\tstrand\tstart\tscore\n")
        for row0, sc, mask in scan.iter_chunks():
            sc_h = sc.cpu().numpy()      # [S, n, n_win]
            ni, wi = np.nonzero(mask.cpu().numpy())
            if ni.size == 0:
                continue
            lens_r = sset.lens[row0 + ni]
            heads = np.asarray(sset.headers, object)[row0 + ni]
            for s in range(sc_h.shape[0]):
                scores = sc_h[s, ni, wi]
                starts = wi if s == 0 else lens_r - W - wi
                strand = "+" if s == 0 else "-"
                lines = [
                    f"{h}\t{strand}\t{int(st) + 1}\t{v:.6g}\n"
                    for h, st, v in zip(heads, starts, scores)
                ]
                fh.writelines(lines)
                n_rows += len(lines)
    return n_rows


def write_occurrences(path: str | os.PathLike, occs: list) -> None:
    """TSV occurrence rows (ScoreSeqSet::write -> <basename>.occurrence).

    Columns: seq header, seq length, strand, start..end (1-based inclusive),
    site string, log-odds score, p-value, e-value.
    """
    with open(path, "w") as fh:
        fh.write("header\tlength\tstrand\tstart..end\tsite\tscore\tp-value\te-value\n")
        for o in occs:
            fh.write(
                f"{o.header}\t{o.length}\t{o.strand}\t{o.start + 1}..{o.end}\t"
                f"{o.site}\t{o.score:.6g}\t{o.pvalue:.4e}\t{o.evalue:.4e}\n"
            )
