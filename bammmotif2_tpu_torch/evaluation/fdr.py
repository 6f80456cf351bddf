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
loop corrects for them through ``n_real``).  The held-out rows are gathered
by index for scoring.  The reference fused the fold loop of a seed group
into one device program to save TPU dispatches; here it is a plain Python
loop.  Every fold runs the seed-stacked EM loop (``refinement.multi``) or
the stacked CGS chains (``refinement.gibbs``) for all seeds of a (W, K,
f_bg) group, then scores the held-out positives and the fold's negatives
with one window-score launch each, and the MOPS sweep sorts and ranks on
the device.  A CGS chain is seeded from the seed's input index
(``gibbs.chain_seed``), the same in every fold.

Outputs ``.zoops.stats`` / ``.mops.stats`` TSVs.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.evaluation import prcurve
from bammmotif2_tpu_torch.generator import seqgen
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import Motif, log_odds_lut
from bammmotif2_tpu_torch.refinement import gibbs
from bammmotif2_tpu_torch.refinement.em import choose_path, prepare_data, run_em
from bammmotif2_tpu_torch.refinement.multi import batched_step, batched_while_loop
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
    device="cpu",
) -> list:
    """k-fold CV FDR analysis for a whole MotifSet, seeds of equal
    (W, K, alphabet, f_bg) evaluated as one stacked group.

    Semantically ``[evaluate_motif(m, ..., index=i) for i, m in
    enumerate(seed_motifs)]`` (same folds, same per-fold negatives, same CGS
    chains, same statistics), with one refinement loop and one scoring
    launch per fold for the whole group.  Falls back to the per-seed path
    when cvFold < 2 or the set has fewer rows than folds.

    ``refine``: 'EM', 'CGS', or 'none' or any other string (score the seeds
    as-is); None derives it from ``params`` ('CGS' under params.CGS, else
    'EM').
    """
    params, refine = _resolve(params, refine)
    n_folds = max(1, params.cvFold)
    if n_folds < 2 or sset.n < n_folds:
        return [evaluate_motif(m, bg, sset, params, refine=refine, neg_set=neg_set,
                               device=device, index=i) for i, m in enumerate(seed_motifs)]
    results: list = [None] * len(seed_motifs)
    groups: dict = {}
    for i, m in enumerate(seed_motifs):
        # f_bg joins the key: the stacked EM update shares one f_bg
        groups.setdefault(
            (m.W, m.K, m.A, np.asarray(m.f_bg, np.float64).tobytes()), []
        ).append(i)
    for idxs in groups.values():
        group = [seed_motifs[i] for i in idxs]
        for i, res in zip(idxs, _evaluate_group(group, idxs, bg, sset, params, refine, neg_set,
                                                device, stacked=True)):
            results[i] = res
    return results


def evaluate_motif(
    seed_motif: Motif,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    refine: str | None = None,
    neg_set: SequenceSet | None = None,
    device="cpu",
    index: int = 0,
) -> FDRResult:
    """k-fold CV FDR analysis of one seed (``FDR::evaluateMotif``).

    Folds are round-robin by sequence index, so pooled outputs
    (``pos_pvalues``, the sweep pools) are in fold-major order.  Each fold
    refines with the single-seed EM loop (``refinement.em.run_em``) or CGS
    (``refinement.gibbs.run_gibbs``, its chain seeded from ``index``, the
    seed's position in its MotifSet).  ``neg_set``: user-provided
    negatives, folded round-robin like the positives; when absent,
    negatives are sampled per fold.
    """
    params, refine = _resolve(params, refine)
    if sset.n == 0:
        empty = np.zeros(0)
        sweep = prcurve.threshold_sweep(empty, empty, max(params.mFold, 1))
        return FDRResult(zoops=sweep, mops=dict(sweep), pos_pvalues=empty,
                         m_fold=params.mFold)
    return _evaluate_group([seed_motif], [index], bg, sset, params, refine, neg_set, device,
                           stacked=False)[0]


def _score_rows(s_flat, cidx, lens, rows, path) -> tuple:
    """Score rows of a [S, N, L] code tensor for all M seeds in one launch.

    ``rows``: index tensor of the rows to score, or None for all.  Returns
    (ZOOPS maxima [M, n], MOPS pool [M, S*n*n_win] with NEG_INF on invalid
    windows, as the scorer writes them).
    """
    if rows is not None:
        cidx = cidx.index_select(1, rows)
        lens = lens.index_select(0, rows)
    sc, _mk = score_fn(path)(s_flat, cidx, lens)
    return sc.amax(dim=(1, 3)), sc.reshape(sc.shape[0], -1)


def _cgs_fold(group, indices, v0, q0, alphas, f_bg, tdata, n_train, params, path, stacked,
              bg, sset) -> tuple:
    """One fold's CGS refinement of the group on the train-masked rows:
    stacked chains, or (one seed) ``run_gibbs``.  Returns v [M, ...]."""
    A, K, W = group[0].A, group[0].K, group[0].W
    dev = tdata["cidx"].device
    if stacked:
        gens = gibbs.chain_generators(params.seed, indices, dev)
        v, _q, _la, _lls = gibbs.gibbs_chains(v0, q0, alphas, f_bg, tdata, float(n_train), gens,
                                              params, A=A, K=K, W=W, path=path)
        return v
    m = group[0].copy()
    gibbs.run_gibbs(m, bg, sset, params, data=tdata, n_real=n_train, device=dev,
                    index=indices[0])
    return tuple(torch.as_tensor(vk, dtype=torch.float32, device=dev)[None] for vk in m.v)


def _evaluate_group(group: list, indices: list, bg: BackgroundModel, sset: SequenceSet,
                    params: Params, refine: str, neg_set: SequenceSet | None, device, *,
                    stacked: bool) -> list:
    """The fold loop for one (W, K, f_bg) seed group.

    ``indices``: the seeds' input indices (their CGS chains' seeds).
    ``stacked``: refine all seeds in one batched EM loop or one set of
    stacked CGS chains per fold; else (one seed) with ``run_em`` /
    ``run_gibbs``.
    """
    t0 = time.perf_counter()
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
                v = _cgs_fold(group, indices, v0, q0, alphas, f_bg, tdata, n_train,
                              params, path, stacked, bg, sset)
                its = [params.maxCGSIterations] * M
            elif stacked:
                def step(v, q, tdata=tdata, n_train=n_train):
                    return batched_step(v, q, tdata, alphas, f_bg, n_train, A=A, K=K, W=W,
                                        optimize_q=params.optimizeQ, path=path)

                v, _q, _lls, _vds, its_t, _h = batched_while_loop(
                    step, v0, q0, eps, params.maxEMIterations)
                its = [int(x) for x in its_t.cpu()]
            else:
                m = group[0].copy()
                r = run_em(m, bg, sset, params, data=tdata, n_real=n_train, device=dev)
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
                order=params.sOrder, alpha=params.bgModelAlpha, ss=params.ss,
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
    for r in results:
        r.group_seconds = time.perf_counter() - t0
    return results
