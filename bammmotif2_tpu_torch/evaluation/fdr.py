"""Cross-validated FDR evaluation of motif quality.

Port of ``bammmotif2_tpu.evaluation.fdr`` (``FDR::evaluateMotif``,
``calculatePR``, ``calculatePvalues``, ``write``):

  for each of --cvFold round-robin folds: refine a copy of each seed on the
  other folds with ZOOPS EM (or CGS), obtain negatives (user-provided via
  --negSeqFile, folded like the positives; otherwise sampled at
  --mFold x |held out| from an order---sOrder background fit to the
  training positives), score the held-out positives and the negatives,
  pool ZOOPS (max-per-sequence) and MOPS (per-window) scores across folds,
  then sweep thresholds for precision/recall and per-score empirical
  p-values.

Folds are masks, not subsets: the set is tensorized once, and a fold's
training rows keep their place while the held-out rows get length 0 (the EM
loop corrects for them through ``n_real``).

``evaluate_motifs`` runs each (W, K, f_bg) seed group as one program, the
counterpart of the reference's ``_group_fdr_program``: every fold table is
built on the host and moved to the device once (``_prepare_group``); each
fold then refines all seeds of the group (the seed-stacked EM loop of
``refinement.multi`` or the stacked CGS chains of ``refinement.gibbs``, each
one loop graph captured once and launched once a fold) and runs the fold
tail:
``log_odds_lut``, one window-score launch over the held-out rows gathered
through a -1-padded index, the fold's negatives sampled from its own
background tables with the key ``PRNGKey(--seed + fold)`` (as the
reference's), encoded and scored in one more launch, the ZOOPS maxima and
MOPS pools into device buffers.  On the card the tail is captured once per
group and replayed for each fold (``refinement.graphs``).  After the folds the per-seed MOPS rank
sweeps run on the pooled buffers, and one fetch brings back the maxima, the
iteration counts and the thinned ranks.  No host read falls between the
first fold and the fetch: each fold's EM loop or CGS sweeps are one
launch of a loop graph, which tests the stop on the device.

``evaluate_motif`` (one seed) and the program's plain version
(``evaluate_motifs(..., program=False)``) run the fold loop
``_evaluate_group_loop``: per fold, host-built masks and row indices, a
background fit and a sampler call, and a read of each fold's maxima.  Every
CGS chain starts from ``PRNGKey(--seed)`` in every fold, whatever the
seed's position, as the reference's FDR does (``cgs_keys``).

Outputs ``.zoops.stats`` / ``.mops.stats`` TSVs.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.device import resolve
from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.utils.metrics import span
from bammmotif2_tpu_torch.evaluation import prcurve
from bammmotif2_tpu_torch.generator import seqgen
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import Motif, log_odds_lut
from bammmotif2_tpu_torch.ops import encode, threefry
from bammmotif2_tpu_torch.refinement import gibbs
from bammmotif2_tpu_torch.refinement import graphs as graphs_mod
from bammmotif2_tpu_torch.refinement.em import choose_path, prepare_data
from bammmotif2_tpu_torch.refinement.multi import count_seed_passes, em_loop, fuses, run_em
from bammmotif2_tpu_torch.scoring.scan import empirical_pvalues, score_fn


@dataclasses.dataclass
class FDRResult:
    zoops: dict  # threshold sweep arrays for max-per-sequence scores
    mops: dict   # threshold sweep arrays for per-window scores
    pos_pvalues: np.ndarray  # per held-out-positive ZOOPS-score p-values
    m_fold: int
    fold_iterations: list = dataclasses.field(default_factory=list)
    # EM iterations or CGS sweeps of each evaluated fold (0 where nothing
    # was refined)
    group_seconds: float = 0.0  # wall-clock of the group evaluation this seed ran in

    def write(self, outdir: str, basename: str) -> list:
        os.makedirs(outdir, exist_ok=True)
        paths = []
        for tag, sweep in (("zoops", self.zoops), ("mops", self.mops)):
            path = os.path.join(outdir, f"{basename}.{tag}.stats")
            _write_stats(path, sweep)
            paths.append(path)
        return paths


MAX_STATS_ROWS = 20_000  # written rows per .stats file (sweep stays full)


def _write_stats(path: str, sweep: dict, max_rows: int = MAX_STATS_ROWS) -> None:
    """One TSV row per sweep point, uniformly thinned past ``max_rows``.

    ZOOPS sweeps stay full-resolution in memory; MOPS sweeps arrive from the
    device already rank-thinned to this row budget.  The reference's
    documented deviation: the C++ tool writes one row per pooled score;
    endpoints are always kept, and AvRec from the thinned curve matches the
    full sweep to ~1e-3.
    """
    n = len(sweep["score"])
    with open(path, "w") as fh:
        fh.write("score\tTP\tFP\tprecision\trecall\tp-value\n")
        for i in prcurve.thin_rows(n, max_rows):
            fh.write(
                f"{sweep['score'][i]:.6g}\t{sweep['tp'][i]:.3f}\t{sweep['fp'][i]:.3f}\t"
                f"{sweep['precision'][i]:.6f}\t{sweep['recall'][i]:.6f}\t"
                f"{sweep['pvalue'][i]:.4e}\n"
            )


def _resolve(params: Params | None, refine: str | None) -> tuple:
    """(params, refine); refine defaults to CGS under params.CGS, else EM.
    An engine other than 'EM' or 'CGS' scores the seeds unrefined, as the
    reference does for any other string."""
    params = params or Params(FDR=True)
    if refine is None:
        refine = "CGS" if params.CGS else "EM"
    return params, refine


def evaluate_motifs(
    seed_motifs: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    refine: str | None = None,
    neg_set: SequenceSet | None = None,
    device=None,
    graphs: bool = True,
    program: bool = True,
) -> list:
    """k-fold CV FDR analysis for a whole MotifSet, seeds of equal
    (W, K, alphabet, f_bg) evaluated as one stacked group.

    Semantically ``[evaluate_motif(m, ...) for m in seed_motifs]`` (same
    folds, same per-fold negatives, same CGS chains, same statistics), each group one program
    (``_evaluate_group_program``): one refinement loop and one fold tail per
    fold for the whole group, one fetch at the end.  Falls back to the
    per-seed path when cvFold < 2 or the set has fewer rows than folds.

    ``refine``: 'EM', 'CGS', or 'none' or any other string (score the seeds
    as-is); None derives it from ``params`` ('CGS' under params.CGS, else
    'EM').  ``device``: None runs on the current CUDA device; pass "cpu" for
    the CPU.  ``graphs``: False runs the refinement loops and the fold tail
    eagerly on a CUDA device too.  ``program``: False runs each group
    through the fold loop ``_evaluate_group_loop`` instead, the program's
    plain version, which gives the same results (tests and chip_smoke.py).
    """
    device = resolve(device)
    params, refine = _resolve(params, refine)
    n_folds = max(1, params.cvFold)
    if n_folds < 2 or sset.n < n_folds:
        return [evaluate_motif(m, bg, sset, params, refine=refine, neg_set=neg_set,
                               device=device, graphs=graphs)
                for m in seed_motifs]
    results: list = [None] * len(seed_motifs)
    groups: dict = {}
    for i, m in enumerate(seed_motifs):
        # f_bg joins the key: the stacked EM update shares one f_bg
        groups.setdefault(
            (m.W, m.K, m.A, np.asarray(m.f_bg, np.float64).tobytes()), []
        ).append(i)
    for idxs in groups.values():
        group = [seed_motifs[i] for i in idxs]
        if program:
            res = _evaluate_group_program(group, bg, sset, params, refine, neg_set, device,
                                          graphs=graphs)
        else:
            res = _evaluate_group_loop(group, bg, sset, params, refine, neg_set, device,
                                       stacked=True, graphs=graphs)
        for i, r in zip(idxs, res):
            results[i] = r
    return results


def evaluate_motif(
    seed_motif: Motif,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    refine: str | None = None,
    neg_set: SequenceSet | None = None,
    device=None,
    graphs: bool = True,
) -> FDRResult:
    """k-fold CV FDR analysis of one seed (``FDR::evaluateMotif``).

    Folds are round-robin by sequence index, so pooled outputs
    (``pos_pvalues``, the sweep pools) are in fold-major order.  Each fold
    refines with the single-seed EM loop (``refinement.multi.run_em``) or CGS
    (``refinement.gibbs.run_gibbs``, its chain from ``PRNGKey(--seed)``).
    ``neg_set``: user-provided negatives, folded round-robin like the positives; when absent,
    negatives are sampled per fold.  ``device``: None runs on the current
    CUDA device; pass "cpu" for the CPU.  ``graphs``: False runs the
    refinement loops eagerly on a CUDA device too.
    """
    device = resolve(device)
    params, refine = _resolve(params, refine)
    if sset.n == 0:
        empty = np.zeros(0)
        sweep = prcurve.threshold_sweep(empty, empty, max(params.mFold, 1))
        return FDRResult(zoops=sweep, mops=dict(sweep), pos_pvalues=empty,
                         m_fold=params.mFold)
    return _evaluate_group_loop([seed_motif], bg, sset, params, refine, neg_set,
                                device, stacked=False, graphs=graphs)[0]


def _score_rows(s_flat, cidx, lens, rows, path) -> tuple:
    """Score rows of a [S, N, L] code tensor for all M seeds in one launch.

    ``rows``: index tensor of the rows to score, -1 for none (a row of
    length 0, all NEG_INF: the reference's ``gather_rows``), or None for
    all.  Returns (ZOOPS maxima [M, n], MOPS pool [M, S*n*n_win] with
    NEG_INF on invalid windows, as the scorer writes them).
    """
    if rows is not None:
        safe = rows.clamp(min=0)
        cidx = cidx.index_select(1, safe)
        lens = torch.where(rows >= 0, lens.index_select(0, safe), 0)
    sc, _mk = score_fn(path)(s_flat, cidx, lens)
    return sc.amax(dim=(1, 3)), sc.reshape(sc.shape[0], -1)


def cgs_keys(seed: int, M: int, device) -> torch.Tensor:
    """The FDR's CGS chains' keys [M, 2]: ``PRNGKey(seed)`` for every seed
    of a group, in every fold.  The reference's FDR gives every chain its
    run key (``bammmotif2_tpu/evaluation/fdr.py``: ``keys0``, and
    ``run_gibbs``'s default in its fold loop), not the input-index keys of
    --CGS alone, so equal seeds sample equal chains; the port matches it."""
    return threefry.prng_key(seed, device).expand(M, 2).contiguous()


def _cgs_fold(group, keys, v0, q0, alphas, f_bg, tdata, n_train, params, path,
              stacked, bg, sset, graphs) -> tuple:
    """One fold's CGS refinement of the group on the train-masked rows:
    stacked chains of ``keys`` (``cgs_keys``), one loop launch on the card,
    or (one seed) ``run_gibbs`` from its default key.  Returns v [M,
    ...]."""
    A, K, W = group[0].A, group[0].K, group[0].W
    dev = tdata["cidx"].device
    if stacked:
        v, _q, _la, _lls = gibbs.gibbs_chains(v0, q0, alphas, f_bg, tdata, float(n_train), keys,
                                              params, A=A, K=K, W=W, path=path, graphs=graphs)
        return v
    m = group[0].copy()
    gibbs.run_gibbs(m, bg, sset, params, data=tdata, n_real=n_train, device=dev,
                    graphs=graphs)
    return tuple(torch.as_tensor(vk, dtype=torch.float32, device=dev)[None] for vk in m.v)


def _evaluate_group_loop(group: list, bg: BackgroundModel, sset: SequenceSet,
                         params: Params, refine: str, neg_set: SequenceSet | None, device, *,
                         stacked: bool, graphs: bool = True) -> list:
    """The fold loop for one (W, K, f_bg) seed group: the per-seed path
    (one seed), and the plain version of ``_evaluate_group_program``.

    ``stacked``: refine all seeds in one batched EM loop or one set of
    stacked CGS chains per fold; else (one seed) with ``run_em`` /
    ``run_gibbs``.  ``graphs``: False runs those loops eagerly on a CUDA
    device too.  The results' ``group_seconds`` are its ``fdr.group``
    span's.
    """
    with span("fdr.group", W=group[0].W, K=group[0].K, M=len(group),
              refine=refine) as group_span:
        results = _fold_loop(group, bg, sset, params, refine, neg_set, device,
                             stacked=stacked, graphs=graphs)
    for r in results:
        r.group_seconds = group_span.seconds
    return results


def _fold_loop(group: list, bg: BackgroundModel, sset: SequenceSet, params: Params,
               refine: str, neg_set: SequenceSet | None, device, *, stacked: bool,
               graphs: bool) -> list:
    """``_evaluate_group_loop``'s folds and sweeps."""
    A, K, W = group[0].A, group[0].K, group[0].W
    M = len(group)
    F = max(1, params.cvFold)
    S = 1 if params.ss else 2
    N = sset.n
    lens_np = np.asarray(sset.lens, np.int32)
    fold_of = np.arange(N) % F

    data = prepare_data(sset, bg, K, params.ss, device)
    dev = data["cidx"].device
    path = choose_path(params, dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    v0 = tuple(f32(np.stack([m.v[k] for m in group])) for k in range(K + 1))
    q0 = torch.full((M,), params.q, dtype=torch.float32, device=dev)
    alphas = f32(np.stack([m.alphas for m in group]))
    f_bg = f32(group[0].f_bg)
    eps = f32(params.epsilon)

    sampled = neg_set is None
    if sampled:
        # every fold samples at one geometry: rows padded to mFold x the
        # largest fold, lengths to the longest positive
        fold_sizes = np.bincount(fold_of, minlength=F)
        n_neg_pad = int(fold_sizes.max()) * max(params.mFold, 1)
        neg_pad_len = int(lens_np.max()) if lens_np.size else 0
    else:
        neg_data = prepare_data(neg_set, bg, K, params.ss, device)
        neg_fold_of = np.arange(neg_set.n) % F

    def idx(rows):
        return torch.as_tensor(rows, dtype=torch.int64, device=dev)

    keys = cgs_keys(params.seed, M, dev)
    pos_z, pos_m, neg_z, neg_m, fold_its = [], [], [], [], []
    n_pos_true = n_neg_true = 0
    for f in range(F):
        test_rows = np.nonzero(fold_of == f)[0]
        train_sel = fold_of != f
        if test_rows.size == 0:
            continue

        v, its = v0, [0] * M
        if train_sel.any() and refine in ("EM", "CGS"):
            tdata = {**data, "lens": torch.as_tensor(
                np.where(train_sel, lens_np, 0).astype(np.int32), device=dev)}
            n_train = int(train_sel.sum())
            if refine == "CGS":
                v = _cgs_fold(group, keys, v0, q0, alphas, f_bg, tdata, n_train,
                              params, path, stacked, bg, sset, graphs)
                its = [params.maxCGSIterations] * M
                graphs_mod.settle()
            elif stacked:
                # every fold's data has one shape (held-out rows have length
                # 0), so the folds replay one captured loop with their lens
                v, _q, _lls, _vds, its_t, _h = em_loop(
                    v0, q0, tdata, alphas, f_bg, n_train, eps, params.maxEMIterations,
                    graphs=graphs, A=A, K=K, W=W, optimize_q=params.optimizeQ, path=path)
                its = [int(x) for x in its_t.cpu()]
                graphs_mod.settle()
                count_seed_passes(its, fuses(tdata, path))
            else:
                m = group[0].copy()
                r = run_em(m, bg, sset, params, data=tdata, n_real=n_train, device=dev,
                           graphs=graphs)
                v = tuple(f32(vk)[None] for vk in m.v)
                its = [r.iterations]
        fold_its.append(its)
        s_flat = log_odds_lut(v, data["bg_flat"]).contiguous()  # [M, R+1, W]

        pz, pm = _score_rows(s_flat, data["cidx"], data["lens"], idx(test_rows), path)
        pos_z.append(pz.cpu().numpy())
        pos_m.append(pm)
        n_pos_true += S * int(np.maximum(lens_np[test_rows].astype(np.int64) - W + 1, 0).sum())

        if sampled:
            train_idx = np.nonzero(train_sel)[0]
            bg_fit = BackgroundModel.from_sequence_set(
                sset.subset(train_idx if train_idx.size else test_rows),
                order=params.sOrder, alpha=params.bgModelAlpha, ss=params.ss, device=dev,
            )
            ncidx, nlens = seqgen.generate_neg_data(
                bg_fit, lens_np[test_rows], m_fold=params.mFold, seed=params.seed + f,
                K=K, ss=params.ss, n_pad=n_neg_pad, pad_len=neg_pad_len, device=dev,
            )
            nz, nm = _score_rows(s_flat, ncidx, torch.as_tensor(nlens, device=dev), None, path)
            # rows with real sampled negatives, BY INDEX: a zero-length
            # positive row tiles into interior zero-length negative rows
            nz = nz[:, idx(np.nonzero(nlens > 0)[0])]
            n_neg_true += S * int(np.maximum(nlens.astype(np.int64) - W + 1, 0).sum())
        else:
            neg_rows = np.nonzero(neg_fold_of == f)[0]
            nz, nm = _score_rows(s_flat, neg_data["cidx"], neg_data["lens"], idx(neg_rows), path)
            n_neg_true += S * int(np.maximum(
                np.asarray(neg_set.lens, np.int64)[neg_rows] - W + 1, 0).sum())
        neg_z.append(nz.cpu().numpy())
        neg_m.append(nm)

    # FP normalization: sampled negatives are an mFold-times oversample of
    # the positives; user-provided negatives count at their true ratio
    m_fold_eff = max(params.mFold, 1) if sampled else neg_set.n / max(N, 1)
    results = []
    for i in range(M):
        pz = np.concatenate([z[i] for z in pos_z])
        nz = np.concatenate([z[i] for z in neg_z]) if neg_z else np.zeros(0)
        results.append(FDRResult(
            zoops=prcurve.threshold_sweep(pz, nz, m_fold_eff),
            mops=prcurve.threshold_sweep_device(
                torch.cat([p[i] for p in pos_m]), torch.cat([p[i] for p in neg_m]),
                m_fold_eff, n_pos_true, n_neg_true, max_rows=MAX_STATS_ROWS,
            ),
            pos_pvalues=empirical_pvalues(pz, nz),
            m_fold=params.mFold,
            fold_iterations=[its[i] for its in fold_its],
        ))
    return results


def fold_backgrounds(sset: SequenceSet, fold_of: np.ndarray, F: int, order: int, alpha: float,
                     ss: bool, device="cpu") -> tuple:
    """The order-``order`` background fits to each fold's training rows,
    stacked: per order o, float32 [F, A^(o+1)] conditionals, row f equal to
    ``BackgroundModel.from_sequence_set(sset.subset(rows not in fold f))``'s
    (the reference fits them on the host too, ``_evaluate_group``).  One
    count on ``device`` of the set's memoised k-mer index keyed by fold
    (``fold_of`` in [0, F)) gives each fold's held-out rows' counts, which
    sum to the set's; each fit takes its fold's off that total: integer
    counts, so each fit is exactly the per-fold one."""
    A = sset.alphabet.size
    n_idx = encode.num_rows(A, order) + 1
    idx, _lens = encode.strand_indices(sset, order, ss, device)  # [S, N, L]
    fold = torch.as_tensor(np.asarray(fold_of, np.int32), device=idx.device)
    held = torch.bincount((fold[None, :, None] * n_idx + idx).ravel(), minlength=F * n_idx)
    held = held.cpu().numpy().reshape(F, n_idx)
    total = held.sum(axis=0)
    tables = tuple(np.zeros((F, A ** (o + 1)), np.float32) for o in range(order + 1))
    for f in range(F):
        fit = BackgroundModel.from_kmer_counts(total - held[f], order, alpha, sset.alphabet)
        for o, t in enumerate(tables):
            t[f] = np.asarray(fit.v[o], np.float32).ravel()
    return tables


@dataclasses.dataclass
class _Group:
    """One group's program inputs, made once before its folds."""

    A: int
    K: int
    W: int
    M: int
    F: int
    S: int
    path: str
    data: dict           # prepare_data of the positives
    v0: tuple            # [M, ...] per order
    q0: torch.Tensor
    alphas: torch.Tensor
    f_bg: torch.Tensor
    keys: torch.Tensor   # the CGS chains' keys [M, 2] (``cgs_keys``)
    eps: torch.Tensor
    train_lens: torch.Tensor  # [F, N] int32: each fold's lengths, held-out rows 0
    n_train: list        # each fold's training rows
    fold_sizes: np.ndarray  # [F] held-out rows
    inputs: dict         # the fold tail's device tables (``_tail``)
    sampled: bool        # negatives sampled (else --negSeqFile's)
    neg_pad_len: int     # sampled negatives' padded length
    s_order: int
    neg_keep: list       # [F] negative rows of each fold kept in the ZOOPS sweep
    n_pos_true: int      # valid positive / negative windows of all folds
    n_neg_true: int
    m_fold_eff: float    # FP normalisation
    rows_thin: torch.Tensor  # the MOPS sweep's thinned ranks, int64 on the device


def _prepare_group(group: list, bg: BackgroundModel, sset: SequenceSet, params: Params,
                   neg_set: SequenceSet | None, device) -> _Group:
    """Every fold table of a group, built on the host and moved to the
    device once (the reference's ``_evaluate_group``, fdr.py:424-523):
    held-out rows [F, n_per] padded with -1, training lengths [F, N], and
    with sampled negatives the per-fold background tables [F, A^(o+1)] per
    order, the negatives' lengths [F, n_neg] (mFold copies of the fold's,
    zero-padded to mFold x the largest fold), their keys [F, 2]
    (``PRNGKey(--seed + fold)``, the reference's) and the rows kept in the
    ZOOPS sweep (those of nonzero length: a zero-length positive tiles into
    interior zero-length negatives); with --negSeqFile the negatives' rows
    [F, ceil(Nn / F)] padded with -1.  Beside them, the CGS chains' keys
    (``cgs_keys``)."""
    A, K, W = group[0].A, group[0].K, group[0].W
    M, F, S, N = len(group), params.cvFold, 1 if params.ss else 2, sset.n
    lens_np = np.asarray(sset.lens, np.int32)
    fold_of = np.arange(N) % F
    fold_sizes = np.bincount(fold_of, minlength=F)
    data = prepare_data(sset, bg, K, params.ss, device)
    dev = data["cidx"].device

    def put(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    rows = np.full((F, int(fold_sizes.max())), -1, np.int64)
    train_lens = np.zeros((F, N), np.int32)
    for f in range(F):
        held = np.nonzero(fold_of == f)[0]
        rows[f, : held.size] = held
        train_lens[f] = np.where(fold_of != f, lens_np, 0)
    inputs = {"cidx": data["cidx"], "lens": data["lens"], "bg_flat": data["bg_flat"],
              "rows": put(rows)}

    def windows(lens):
        return S * int(np.maximum(np.asarray(lens, np.int64) - W + 1, 0).sum())

    sampled = neg_set is None
    if sampled:
        n_neg = int(fold_sizes.max()) * max(params.mFold, 1)
        neg_lens = np.zeros((F, n_neg), np.int32)
        for f in range(F):
            rep = np.tile(lens_np[fold_of == f], params.mFold)
            neg_lens[f, : rep.size] = rep
        trans = fold_backgrounds(sset, fold_of, F, params.sOrder, params.bgModelAlpha, params.ss,
                                 dev)
        inputs.update({f"trans{o}": put(t) for o, t in enumerate(trans)})
        inputs.update(neg_lens=put(neg_lens), comp=put(encode.comp_table(sset.alphabet)),
                      neg_keys=torch.stack([threefry.prng_key(params.seed + f, dev)
                                            for f in range(F)]))
        neg_keep = [np.nonzero(neg_lens[f] > 0)[0] for f in range(F)]
        n_neg_true = windows(neg_lens)
        neg_pad_len = int(lens_np.max()) if lens_np.size else 0
        m_fold_eff = max(params.mFold, 1)
    else:
        neg_data = prepare_data(neg_set, bg, K, params.ss, device)
        neg_fold_of = np.arange(neg_set.n) % F
        neg_rows = np.full((F, -(-neg_set.n // F)), -1, np.int64)
        neg_keep = []
        for f in range(F):
            held = np.nonzero(neg_fold_of == f)[0]
            neg_rows[f, : held.size] = held
            neg_keep.append(np.arange(held.size))
        inputs.update(neg_cidx=neg_data["cidx"], neg_row_lens=neg_data["lens"],
                      neg_rows=put(neg_rows))
        n_neg_true = windows(neg_set.lens)
        neg_pad_len = 0
        m_fold_eff = neg_set.n / max(N, 1)
    n_pos_true = windows(lens_np)
    return _Group(
        A=A, K=K, W=W, M=M, F=F, S=S, path=choose_path(params, dev), data=data,
        v0=tuple(put(np.stack([m.v[k] for m in group]), torch.float32) for k in range(K + 1)),
        q0=torch.full((M,), params.q, dtype=torch.float32, device=dev),
        alphas=put(np.stack([m.alphas for m in group]), torch.float32),
        f_bg=put(group[0].f_bg, torch.float32),
        keys=cgs_keys(params.seed, M, dev),
        eps=put(params.epsilon, torch.float32),
        train_lens=put(train_lens), n_train=[int(N - n) for n in fold_sizes],
        fold_sizes=fold_sizes, inputs=inputs, sampled=sampled, neg_pad_len=neg_pad_len,
        s_order=params.sOrder, neg_keep=neg_keep, n_pos_true=n_pos_true, n_neg_true=n_neg_true,
        m_fold_eff=m_fold_eff,
        rows_thin=put(prcurve.thin_rows(n_pos_true + n_neg_true, MAX_STATS_ROWS)),
    )


def _negatives(g: _Group, inputs: dict, fold: torch.Tensor) -> torch.Tensor:
    """Fold ``fold`` ([1] int64 on the device)'s sampled negatives, cidx
    [S, n_neg, L]: ``seqgen.sample_encode`` from its key, background tables
    and lengths, read on the device.  They are ``seqgen.
    generate_neg_data``'s of the fold (seed ``--seed + fold``), bit for
    bit."""
    def pick(t):
        return t.index_select(0, fold)[0]

    trans = tuple(pick(inputs[f"trans{o}"]) for o in range(g.s_order + 1))
    return seqgen.sample_encode(pick(inputs["neg_keys"]), trans, pick(inputs["neg_lens"]),
                                inputs["comp"], L=g.neg_pad_len, s_order=g.s_order, A=g.A,
                                K=g.K, ss=g.S == 1)


def _tail(g: _Group, graphs: bool) -> graphs_mod.Loop:
    """The fold tail as a ``graphs.Loop`` whose one step is one fold: state
    ``v`` (the fold's refined model) and ``fold`` ([1] int64), outputs the
    fold's ZOOPS maxima and MOPS pools (``pos_z``, ``pos_m``, ``neg_z``,
    ``neg_m``).  ``_run_tail`` runs it."""
    inputs = dict(g.inputs)
    dev = g.data["cidx"].device
    n_per = int(inputs["rows"].shape[1])
    n_win = int(g.data["cidx"].shape[2]) - g.W + 1
    if g.sampled:
        n_neg, n_win_neg = int(inputs["neg_lens"].shape[1]), g.neg_pad_len - g.W + 1
    else:
        n_neg = int(inputs["neg_rows"].shape[1])
        n_win_neg = int(inputs["neg_cidx"].shape[2]) - g.W + 1

    def make(*shape):
        return lambda: torch.empty(shape, dtype=torch.float32, device=dev)

    outputs = {"pos_z": make(g.M, n_per), "pos_m": make(g.M, g.S * n_per * n_win),
               "neg_z": make(g.M, n_neg), "neg_m": make(g.M, g.S * n_neg * n_win_neg)}
    state = {"v": tuple(vk.clone() for vk in g.v0),
             "fold": torch.zeros((1,), dtype=torch.int64, device=dev)}

    def body(s):
        fold = s["fold"]
        s_flat = log_odds_lut(s["v"], inputs["bg_flat"]).contiguous()  # [M, R+1, W]
        pz, pm = _score_rows(s_flat, inputs["cidx"], inputs["lens"],
                             inputs["rows"].index_select(0, fold)[0], g.path)
        if g.sampled:
            nz, nm = _score_rows(s_flat, _negatives(g, inputs, fold),
                                 inputs["neg_lens"].index_select(0, fold)[0], None, g.path)
        else:
            nz, nm = _score_rows(s_flat, inputs["neg_cidx"], inputs["neg_row_lens"],
                                 inputs["neg_rows"].index_select(0, fold)[0], g.path)
        for k, x in (("pos_z", pz), ("pos_m", pm), ("neg_z", nz), ("neg_m", nm)):
            s[k].copy_(x)

    key = ("fold_tail", g.path, g.A, g.K, g.W, g.S, g.sampled, g.neg_pad_len, g.s_order)
    return graphs_mod.Loop("FDR fold tail", key, state, inputs, body, outputs=outputs,
                           graphs=graphs)


def _run_tail(tail: graphs_mod.Loop, v: tuple, fold: int) -> None:
    """One fold's tail: its model and index into the static state, one step
    (a replay)."""
    for a, b in zip(tail.state["v"], v):
        a.copy_(b)
    tail.state["fold"].fill_(fold)
    tail.run(1)


def _mops_ranks(pos_pool: torch.Tensor, neg_pool: torch.Tensor, rows_thin: torch.Tensor,
                n_neg_true: int) -> list:
    """Each seed's MOPS rank sweep on its fold-pooled rows (the reference's
    ``lax.map`` of ``prcurve.thinned_rank_rows``), stacked: (score, tp, fp,
    lo, hi), each [M, n_rows]."""
    per_seed = [prcurve.thinned_rank_rows(p, n, rows_thin, n_neg_true)
                for p, n in zip(pos_pool, neg_pool)]
    return [torch.stack(x) for x in zip(*per_seed)]


def _run_folds(g: _Group, group: list, bg: BackgroundModel, sset: SequenceSet,
               params: Params, refine: str, graphs: bool) -> list:
    """The folds and the MOPS sweeps, all on the device: [pos_z [F, M,
    n_per], neg_z [F, M, n_neg], iterations [F, M] int32, the five rank
    rows of ``_mops_ranks``].  Reads nothing from the device."""
    M, F, dev = g.M, g.F, g.q0.device
    its0 = params.maxCGSIterations if refine == "CGS" else 0
    iters = torch.full((F, M), its0, dtype=torch.int32, device=dev)
    tail = _tail(g, graphs)
    # the folds' outputs: ZOOPS maxima [F, M, n], MOPS pools [M, F, X]
    # (fold-major: each seed's pool is one [F * X] row)
    maxima = {k: tail.state[k].new_empty((F, *tail.state[k].shape))
              for k in ("pos_z", "neg_z")}
    pools = {k: tail.state[k].new_empty((M, F, tail.state[k].shape[1]))
             for k in ("pos_m", "neg_m")}
    for f in range(F):
        v = g.v0
        if refine in ("EM", "CGS"):
            tdata = {**g.data, "lens": g.train_lens[f]}
            if refine == "CGS":
                v = _cgs_fold(group, g.keys, g.v0, g.q0, g.alphas, g.f_bg, tdata,
                              g.n_train[f], params, g.path, True, bg, sset, graphs)
            else:
                v, _q, _lls, _vds, its, _h = em_loop(
                    g.v0, g.q0, tdata, g.alphas, g.f_bg, g.n_train[f], g.eps,
                    params.maxEMIterations, graphs=graphs, A=g.A, K=g.K, W=g.W,
                    optimize_q=params.optimizeQ, path=g.path)
                iters[f].copy_(its)
        _run_tail(tail, v, f)
        for k, x in maxima.items():
            x[f].copy_(tail.state[k])
        for k, x in pools.items():
            x[:, f].copy_(tail.state[k])
    ranks = _mops_ranks(pools["pos_m"].reshape(M, -1), pools["neg_m"].reshape(M, -1),
                        g.rows_thin, g.n_neg_true)
    return [maxima["pos_z"], maxima["neg_z"], iters, *ranks]


def _fetch(tensors: list) -> list:
    """One device-to-host copy of 4-byte tensors (float32, int32): numpy
    arrays of their dtypes and shapes.  Settles the loops' launch counters
    (``graphs.settle``)."""
    flat = torch.cat([t.reshape(-1).view(torch.int32) for t in tensors]).cpu().numpy()
    graphs_mod.settle()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        dtype = np.float32 if t.dtype == torch.float32 else np.int32
        out.append(flat[at : at + n].view(dtype).reshape(tuple(t.shape)))
        at += n
    return out


def _evaluate_group_program(group: list, bg: BackgroundModel, sset: SequenceSet,
                            params: Params, refine: str, neg_set: SequenceSet | None, device, *,
                            graphs: bool = True) -> list:
    """One (W, K, f_bg) group as one program (the reference's
    ``_group_fdr_program`` and ``_evaluate_group``): ``_prepare_group``,
    ``_run_folds``, one ``_fetch``, then the host sweeps.  Needs cvFold >= 2
    and at least cvFold rows.  Its results equal ``_evaluate_group_loop``'s
    (stacked): the MOPS pools hold NEG_INF for a smaller fold's pad rows,
    which the rank sweep counts as it counts invalid windows.

    Spans (``utils.metrics``): ``fdr.group`` (its seconds are the results'
    ``group_seconds``) holds ``fdr.prepare``, ``fdr.folds`` (enqueues the
    folds: the device's work ends inside ``fdr.fetch``), ``fdr.fetch``
    (attr ``iterations``: [F][M], each fold's EM iterations or CGS sweeps)
    and ``fdr.sweeps``."""
    with span("fdr.group", W=group[0].W, K=group[0].K, M=len(group),
              refine=refine) as group_span:
        with span("fdr.prepare"):
            g = _prepare_group(group, bg, sset, params, neg_set, device)
        with span("fdr.folds"):
            outs = _run_folds(g, group, bg, sset, params, refine, graphs)
        with span("fdr.fetch") as fetch_span:
            pos_z, neg_z, iters, *ranks = _fetch(outs)
            fetch_span.attrs["iterations"] = iters.tolist()
            if refine == "EM":
                for its in iters:
                    count_seed_passes(its, fuses(g.data, g.path))
        with span("fdr.sweeps"):
            results = []
            for m in range(g.M):
                pz = np.concatenate([pos_z[f, m, : g.fold_sizes[f]] for f in range(g.F)])
                nz = np.concatenate([neg_z[f, m, g.neg_keep[f]] for f in range(g.F)])
                results.append(FDRResult(
                    zoops=prcurve.threshold_sweep(pz, nz, g.m_fold_eff),
                    mops=prcurve.sweep_from_ranks(*(r[m] for r in ranks), g.m_fold_eff,
                                                  g.n_pos_true, g.n_neg_true),
                    pos_pvalues=empirical_pvalues(pz, nz),
                    m_fold=params.mFold,
                    fold_iterations=[int(x) for x in iters[:, m]],
                ))
    for r in results:
        r.group_seconds = group_span.seconds
    return results
