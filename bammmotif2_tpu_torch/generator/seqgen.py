"""Artificial sequence generation.

Port of ``bammmotif2_tpu.generator.seqgen`` (``SeqGenerator``): negatives for
FDR and p-value calibration are sampled from a homogeneous Markov model of
order ``--sOrder`` fit to the positive set, at ``--mFold`` times the positive
count; motif-embedded sets support benchmarking.

Every draw comes from the reference's own ``jax.random`` stream: a seed's
key is ``threefry.prng_key(seed)`` (``PRNGKey(seed)``), and a set is one
launch of ``ops.cuda_draws.markov_codes`` (a thread a row, the reference's
``categorical`` at each position), so the port samples the reference's
negatives from the same seed, on the card or on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.device import resolve
from bammmotif2_tpu_torch.utils.fasta import PAD, SequenceSet
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import Motif
from bammmotif2_tpu_torch.ops import cuda_draws, encode, threefry


def _sample_markov_batch(key: torch.Tensor, trans: tuple, lens: torch.Tensor, *,
                         L: int, s_order: int, A: int) -> torch.Tensor:
    """Sample [N, L] int8 codes from a homogeneous Markov chain, as the
    reference's ``_sample_markov_batch`` does from ``key`` ([2] int64 on
    the device of ``lens``): position t of every row is a categorical draw
    of key ``split(key, L)[t]`` (``ops.cuda_draws.markov_codes``).

    trans[m]: [A^(m+1)] conditional probs (flat, lexicographic) for order m,
    on the device of ``lens`` (int32 [N]).  The first s_order positions use
    the lower-order conditionals with a growing context; the rest use the
    order-s_order table.  Positions at or past a row's length are PAD.  No
    host sync and no host-to-device copy, so a CUDA graph can capture it
    (the FDR group program's fold tail does).
    """
    return cuda_draws.markov_codes(key, tuple(t.to(torch.float32) for t in trans), lens,
                                   L=L, s_order=s_order, A=A)


def _neg_lengths(lens: np.ndarray, m_fold: int, n_pad: int | None,
                 pad_len: int | None) -> tuple:
    """(lengths repeated m_fold times, zero-padded to n_pad rows; padded L)."""
    lens_rep = np.tile(np.asarray(lens, np.int32), m_fold)
    if n_pad is not None:
        if n_pad < lens_rep.size:
            raise ValueError(f"n_pad {n_pad} < {lens_rep.size} sampled rows")
        lens_rep = np.concatenate([lens_rep, np.zeros(n_pad - lens_rep.size, np.int32)])
    L = int(lens_rep.max()) if lens_rep.size else 0
    if pad_len is not None:
        if pad_len < L:
            raise ValueError(f"pad_len {pad_len} < max sampled length {L}")
        L = pad_len
    return lens_rep, L


def _sample(bg_fit: BackgroundModel, lens_rep: np.ndarray, L: int, seed: int,
            device) -> torch.Tensor:
    device = torch.device(device)
    trans = tuple(torch.as_tensor(v, dtype=torch.float32, device=device) for v in bg_fit.v)
    return _sample_markov_batch(
        threefry.prng_key(seed, device), trans,
        torch.as_tensor(lens_rep, dtype=torch.int32, device=device),
        L=L, s_order=bg_fit.order, A=bg_fit.alphabet.size,
    )


def generate_neg_set(
    bg_fit: BackgroundModel,
    lens: np.ndarray,
    m_fold: int = 1,
    seed: int = 42,
    name_prefix: str = "neg",
    n_pad: int | None = None,
    pad_len: int | None = None,
    device=None,
) -> SequenceSet:
    """Sample a negative set (``SeqGenerator::generateNegSeqSet``): lengths =
    positive lengths repeated m_fold times, bases from the order-sOrder model
    fit to the positives, sampled on ``device`` from ``PRNGKey(seed)``: the
    reference's set for the same seed.

    ``n_pad`` / ``pad_len``: pad the sequence count (with zero-length rows)
    and the length axis to fixed sizes, as the FDR fold loop does.
    ``device``: None samples on the current CUDA device; pass "cpu" for the
    CPU.
    """
    device = resolve(device)
    lens_rep, L = _neg_lengths(lens, m_fold, n_pad, pad_len)
    codes = _sample(bg_fit, lens_rep, L, seed, device).cpu().numpy()
    headers = [f"{name_prefix}_{i + 1}" for i in range(len(lens_rep))]
    return SequenceSet(codes=codes, lens=lens_rep, headers=headers, alphabet=bg_fit.alphabet)


def sample_encode(key: torch.Tensor, trans: tuple, lens: torch.Tensor, comp: torch.Tensor, *,
                  L: int, s_order: int, A: int, K: int, ss: bool) -> torch.Tensor:
    """Markov sampling + reverse complement + k-mer encoding, on the device
    of ``lens`` (the reference's ``seqgen._sample_encode``): cidx [S, N, L]
    int32.  ``key``, ``trans`` and ``lens`` as ``_sample_markov_batch``
    takes them, ``comp`` the complement table (``encode.comp_table``) on
    that device.  Capturable as ``_sample_markov_batch`` is."""
    codes = _sample_markov_batch(key, trans, lens, L=L, s_order=s_order, A=A)
    strands = [codes]
    if not ss:
        strands.append(encode.revcomp_codes_device(codes, lens, comp))
    return torch.stack([encode.combined_kmer_index(c, A, K) for c in strands])


def _sample_encode(bg_fit: BackgroundModel, lens_rep: np.ndarray, L: int, seed: int, *,
                   K: int, ss: bool, device) -> torch.Tensor:
    """``sample_encode`` from a background fit, host lengths and a seed."""
    device = torch.device(device)
    trans = tuple(torch.as_tensor(v, dtype=torch.float32, device=device) for v in bg_fit.v)
    comp = torch.as_tensor(encode.comp_table(bg_fit.alphabet), device=device)
    return sample_encode(threefry.prng_key(seed, device), trans,
                         torch.as_tensor(lens_rep, dtype=torch.int32, device=device), comp,
                         L=L, s_order=bg_fit.order, A=bg_fit.alphabet.size, K=K, ss=ss)


def generate_neg_data(
    bg_fit: BackgroundModel,
    lens: np.ndarray,
    m_fold: int,
    seed: int,
    K: int,
    ss: bool,
    n_pad: int | None = None,
    pad_len: int | None = None,
    device=None,
):
    """Sampled-negative index tensors on the device.

    The sampling contract of generate_neg_set (the same key, PRNGKey(seed),
    gives the same sequences), but the codes never visit the host.  Returns (cidx
    [S, N, L] int32 on ``device``, lens [N] host int32).  ``device``: None
    samples on the current CUDA device; pass "cpu" for the CPU.
    """
    device = resolve(device)
    lens_rep, L = _neg_lengths(lens, m_fold, n_pad, pad_len)
    cidx = _sample_encode(bg_fit, lens_rep, L, seed, K=K, ss=ss, device=device)
    return cidx, lens_rep


def sample_motif_sites(motif: Motif, n: int, seed: int = 0) -> np.ndarray:
    """Sample n site code arrays [n, W] from the motif's highest-order chain
    (``SeqGenerator::sample_seqset_with_motif``), on the host, as the
    reference does: position j a categorical draw of key ``split(
    PRNGKey(seed), W)[j]`` over the float32 log probabilities."""
    A, K, W = motif.A, motif.K, motif.W
    keys = threefry.split(threefry.prng_key(seed), W)
    out = np.zeros((n, W), np.int8)
    ctx = np.zeros(n, np.int64)  # k-mer context code
    for j in range(W):
        k_eff = min(j, K)
        vk = motif.v[k_eff][:, j].reshape(-1, A)  # [A^k_eff, A]
        probs = vk[ctx % (A ** k_eff)] if k_eff else np.broadcast_to(vk[0], (n, A))
        logits = threefry.xla_log(torch.as_tensor(np.asarray(probs, np.float32)))
        c = threefry.categorical(keys[j], logits).numpy()
        out[:, j] = c
        ctx = ctx * A + c
    return out


def mask_motif(
    sset: SequenceSet,
    motif: Motif,
    bg: BackgroundModel,
    pval_cutoff: float = 1e-3,
    m_fold: int = 10,
    seed: int = 7,
    ss: bool = False,
    device=None,
) -> SequenceSet:
    """Motif-masked positives: resample every significant motif window from
    the background's mono-nucleotide conditionals (``SeqGenerator`` masked
    variant, used to hunt secondary motifs after the primary is found).

    Windows whose log-odds beats the empirical p-value cutoff, ranked
    against the per-window scores of ``m_fold`` sampled negatives, are
    replaced.  ``device``: None runs on the current CUDA device; pass "cpu"
    for the CPU.
    """
    from bammmotif2_tpu_torch.scoring import scan as scan_mod

    device = resolve(device)
    res = scan_mod.score_set(motif, bg, sset, ss=ss, device=device)
    neg = generate_neg_set(bg, sset.lens, m_fold=m_fold, seed=seed, device=device)
    neg_res = scan_mod.score_set(motif, bg, neg, ss=ss, device=device)
    occs = scan_mod.find_occurrences(res, sset, neg_res, pval_cutoff)

    rng = np.random.default_rng(seed)
    f0 = np.asarray(bg.v[0], np.float64)
    f0 = f0 / f0.sum()
    codes = sset.codes.copy()
    for occ in occs:
        i = occ.seq_idx
        end = min(occ.end, int(sset.lens[i]))
        codes[i, occ.start : end] = rng.choice(len(f0), size=end - occ.start, p=f0)
    return SequenceSet(codes=codes, lens=sset.lens.copy(), headers=list(sset.headers),
                       alphabet=sset.alphabet)


def embed_motif(sset: SequenceSet, motif: Motif, q: float = 1.0, seed: int = 1) -> SequenceSet:
    """Implant one sampled motif site at a uniform position in a fraction q
    of the sequences (benchmark-set construction)."""
    rng = np.random.default_rng(seed)
    codes = sset.codes.copy()
    sites = sample_motif_sites(motif, sset.n, seed=seed)
    W = motif.W
    for i in range(sset.n):
        if sset.lens[i] >= W and rng.random() < q:
            pos = rng.integers(0, sset.lens[i] - W + 1)
            codes[i, pos : pos + W] = sites[i]
    return SequenceSet(codes=codes, lens=sset.lens.copy(), headers=list(sset.headers),
                       alphabet=sset.alphabet)
