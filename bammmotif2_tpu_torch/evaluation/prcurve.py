"""Precision/recall threshold sweep and ranking metrics.

Port of ``bammmotif2_tpu.evaluation.prcurve`` (``FDR::calculatePR``): pool
positive and negative scores, sweep thresholds over the sorted pool; at
threshold t, TP = #pos >= t, FP = (#neg >= t) / mFold, precision =
TP / (TP + FP), recall = TP / #pos.  Also the average-recall (AvRec)
summary.  The window-scale (MOPS) sweep sorts and ranks on the device and
fetches only a thinned table of integer ranks; the float64 sweep math runs
on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from bammmotif2_tpu_torch.scoring.scan import empirical_pvalues


def thin_rows(n: int, max_rows: int) -> np.ndarray:
    """Uniform rank thinning shared by every sweep writer/fetcher."""
    if n > max_rows:
        return np.unique(np.round(np.linspace(0, n - 1, max_rows)).astype(np.int64))
    return np.arange(max(n, 0), dtype=np.int64)


def thinned_rank_rows(pp: torch.Tensor, nn: torch.Tensor, rows_d: torch.Tensor,
                      n_neg: int) -> tuple:
    """(score, tp, fp, lo, hi) int32 rank rows at thinned descending ranks.

    Rows above a tie block are all > s, and within the s tie block every
    positive precedes every negative, so
        tp(r) = #pos > s_r + clip(r + 1 - #pool > s_r, 0, #pos == s_r)
        fp(r) = (r + 1) - tp(r)
    This needs only value sorts plus searchsorted on the thinned rows.
    Ranks stay int32 on the device (exact; pools < 2^31).  Pads (NEG_INF or
    -inf) sort first ascending, below any real score, so thinned rows < n
    never reach them; ``lo``/``hi`` subtract the negatives' pad count
    before clipping.

    ``pp``/``nn``: positive/negative pooled f32 scores (may carry pads);
    ``rows_d``: descending-rank rows; ``n_neg``: true (unpadded) negative
    count.
    """
    n_tot = int(pp.shape[0] + nn.shape[0])
    if n_tot >= 2**31:
        raise ValueError("pooled window count exceeds int32 rank range")
    rows_d = rows_d.to(device=pp.device, dtype=torch.int64)
    pool_sorted = torch.sort(torch.cat([pp, nn])).values  # ascending
    pos_sorted = torch.sort(pp).values
    neg_sorted = torch.sort(nn).values
    sc_t = pool_sorted[n_tot - 1 - rows_d]  # r-th largest at each row
    n_pool_gt = n_tot - torch.searchsorted(pool_sorted, sc_t, right=True)
    pos_le = torch.searchsorted(pos_sorted, sc_t, right=True)
    pos_lt = torch.searchsorted(pos_sorted, sc_t, right=False)
    n_pos_gt = int(pp.shape[0]) - pos_le
    ties_pos = pos_le - pos_lt
    r1 = rows_d + 1
    tp = n_pos_gt + torch.minimum(torch.clamp(r1 - n_pool_gt, min=0), ties_pos)
    fpc = r1 - tp
    pad_neg = int(nn.shape[0]) - n_neg
    lo = torch.clamp(torch.searchsorted(neg_sorted, sc_t, right=False) - pad_neg, 0, n_neg)
    hi = torch.clamp(torch.searchsorted(neg_sorted, sc_t, right=True) - pad_neg, 0, n_neg)
    i32 = torch.int32
    return sc_t, tp.to(i32), fpc.to(i32), lo.to(i32), hi.to(i32)


def threshold_sweep_device(pos_dev: torch.Tensor, neg_dev: torch.Tensor, m_fold: float,
                           n_pos: int, n_neg: int, max_rows: int = 100_000) -> dict:
    """threshold_sweep computed on the device, fetching only a thinned table.

    ``pos_dev``/``neg_dev`` may carry NEG_INF padding on invalid windows;
    ``n_pos``/``n_neg`` are the true counts.  Tie handling matches the numpy
    sweep up to within-tie row order (cumulative values at tie-block
    boundaries are identical).
    """
    pp = pos_dev.to(torch.float32).reshape(-1)
    nn = neg_dev.to(device=pp.device, dtype=torch.float32).reshape(-1)
    rows_d = torch.as_tensor(thin_rows(n_pos + n_neg, max_rows))
    return sweep_from_ranks(*thinned_rank_rows(pp, nn, rows_d, n_neg), m_fold, n_pos, n_neg)


def sweep_from_ranks(score, tp, fpc, lo, hi, m_fold: float, n_pos: int, n_neg: int) -> dict:
    """float64 host sweep table from fetched integer ranks (tensors or
    arrays).  Tie p-values use the rank-midpoint convention
    (scan._pvalues_from_ranks)."""
    def host(x):
        return (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).astype(np.float64)

    m = m_fold if m_fold > 0 else 1
    tp_h = host(tp)
    fp_h = host(fpc) / m
    lo, hi = host(lo), host(hi)
    frac = np.where(hi > lo, 0.5 * (lo + hi), lo)
    if n_neg > 0:
        pv = np.clip((n_neg - frac + 1.0) / (n_neg + 1.0), 1.0 / (n_neg + 1.0), 1.0)
    else:
        pv = np.ones_like(frac)
    return {
        "score": host(score),
        "tp": tp_h,
        "fp": fp_h,
        "precision": tp_h / np.maximum(tp_h + fp_h, 1e-30),
        "recall": tp_h / max(n_pos, 1),
        "pvalue": pv,
    }


def threshold_sweep(pos: np.ndarray, neg: np.ndarray, m_fold: float) -> dict:
    """Sweep thresholds over pooled descending scores (host float64).

    ``m_fold``: the factor FP counts are divided by, so precision/recall
    refer to the positive-set scale: --mFold for sampled negatives, or
    #neg/#pos for user-provided negatives.  Returns a dict of arrays, one
    entry per pooled score, descending: score, tp, fp, precision, recall,
    pvalue.
    """
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    pool = np.concatenate([pos, neg])
    is_pos = np.concatenate([np.ones(pos.size, bool), np.zeros(neg.size, bool)])
    order = np.argsort(-pool, kind="stable")
    pool, is_pos = pool[order], is_pos[order]
    tp = np.cumsum(is_pos).astype(np.float64)
    fp = np.cumsum(~is_pos).astype(np.float64) / (m_fold if m_fold > 0 else 1)
    return {
        "score": pool,
        "tp": tp,
        "fp": fp,
        "precision": tp / np.maximum(tp + fp, 1e-30),
        "recall": tp / max(pos.size, 1),
        "pvalue": empirical_pvalues(pool, neg),
    }


def average_recall(sweep: dict, fdr_range: tuple = (0.0, 0.5)) -> float:
    """AvRec: mean recall over a false-discovery-rate range (default 0..0.5),
    the quality headline of Ge et al. 2021: the best recall at FDR <= f,
    read at 101 grid points."""
    fdr = 1.0 - sweep["precision"]
    recall = sweep["recall"]
    lo, hi = fdr_range
    order = np.argsort(fdr, kind="stable")
    f_sorted = fdr[order]
    r_best = np.maximum.accumulate(recall[order])  # best recall at FDR <= f
    grid = np.linspace(lo, hi, 101)
    idx = np.searchsorted(f_sorted, grid, side="right") - 1
    best = np.where(idx >= 0, r_best[np.clip(idx, 0, None)], 0.0)
    return float(best.mean())
