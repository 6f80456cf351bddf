"""Compare the output directories of two CLI runs of the same command.

Used by ``tests/test_torch_cli.py`` (the port against the JAX package, on
the CPU) and by ``chip_smoke.py`` (the port's kernel path against its
``--no-pallas`` path, on the card).  Imports no JAX.

``refined`` says whether EM refined the models of the two runs: then they
differ by rounding, and so do every score and what is ranked by it.  The
bars (``compare_dirs``):

- ``.hbcp``/``.hbp``: byte-identical (the background fit is host numpy);
- ``.ihbcp``/``.ihbp``: probabilities within PROB_TOL;
- ``.occurrence``/``.logOdds``: the same rows with scores within SCORE_TOL
  (equal when not refined).  Every score bar adds one unit in the 6th
  significant digit, the precision scores are written with.  Refined, a row may be in one file only where
  its score lies within SCORE_TOL of the lowest score the other file
  reports, that is at the p-value cutoff; p-values and e-values agree to
  PVAL_RTOL (a rank moves only where a negative lies within the score
  change);
- ``.zoops.stats``/``.mops.stats``: the same number of rows, scores within
  SCORE_TOL, TP and FP within RANK_FRAC of the row's rank, AvRec within
  AVREC_TOL (equal when not refined);
- ``.pvalues``: within PVALUES_ATOL (equal when not refined).
"""

from __future__ import annotations

import os

import numpy as np

from bammmotif2_tpu_torch.evaluation.prcurve import average_recall
from bammmotif2_tpu_torch.models.motif import _read_position_blocks

PROB_TOL = 1e-4
SCORE_TOL = 1e-4
PVAL_RTOL = 1e-2
RANK_FRAC = 1e-3
AVREC_TOL = 1e-3
PVALUES_ATOL = 1e-3


def _close(x, y, tol: float):
    """|x - y| <= tol plus one unit in the 6th significant digit (%.6g)."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    return np.abs(x - y) <= tol + 1e-5 * np.maximum(np.abs(x), np.abs(y))


def _lines(path: str) -> list:
    with open(path) as fh:
        return fh.read().splitlines()


def read_probs(path: str) -> np.ndarray:
    return np.concatenate([np.concatenate(b) for b in _read_position_blocks(path)])


def _compare_hits(a: list, b: list, score_col: int, refined: bool, name: str,
                  pval_cols: tuple = ()) -> int:
    """Rows keyed by every column but the score and p-value columns; returns
    how many rows sit in one file only (near the cutoff)."""
    skip = {score_col, *pval_cols}

    def keyed(lines):
        out = {}
        for ln in lines[1:]:
            f = ln.split("\t")
            out[tuple(x for i, x in enumerate(f) if i not in skip)] = f
        return out

    ka, kb = keyed(a), keyed(b)
    if not refined:
        if a != b:
            raise AssertionError(f"{name}: rows differ between unrefined runs")
        return 0
    if a[0] != b[0]:
        raise AssertionError(f"{name}: headers differ")
    low = {
        "a": min((float(f[score_col]) for f in ka.values()), default=np.inf),
        "b": min((float(f[score_col]) for f in kb.values()), default=np.inf),
    }
    only = 0
    for keys, other, tag in ((ka, kb, "b"), (kb, ka, "a")):
        for key, f in keys.items():
            if key in other:
                continue
            if not _close(float(f[score_col]), low[tag], SCORE_TOL):
                raise AssertionError(f"{name}: row {f} in one run only, away from the cutoff")
            only += 1
    for key in ka.keys() & kb.keys():
        fa, fb = ka[key], kb[key]
        if not _close(float(fa[score_col]), float(fb[score_col]), SCORE_TOL):
            raise AssertionError(f"{name}: score {fa} vs {fb}")
        for c in pval_cols:
            pa, pb = float(fa[c]), float(fb[c])
            if abs(pa - pb) > PVAL_RTOL * max(pa, pb):
                raise AssertionError(f"{name}: p/e-value {fa} vs {fb}")
    return only


def _compare_stats(a: list, b: list, refined: bool, name: str, m_fold: float) -> dict:
    A = np.array([ln.split("\t") for ln in a[1:]], float).reshape(-1, 6)
    B = np.array([ln.split("\t") for ln in b[1:]], float).reshape(-1, 6)
    if A.shape != B.shape:
        raise AssertionError(f"{name}: {A.shape[0]} vs {B.shape[0]} rows")
    if not refined and a != b:
        raise AssertionError(f"{name}: rows differ between unrefined runs")
    dscore = float(np.abs(A[:, 0] - B[:, 0]).max()) if A.size else 0.0
    if not _close(A[:, 0], B[:, 0], SCORE_TOL).all():
        raise AssertionError(f"{name}: scores differ by {dscore:.3e}")
    # the written rows are thinned ranks r with TP + FP * m_fold = r + 1; FP
    # is written to 3 decimals after the division by m_fold
    scale = np.array([1.0, m_fold])
    rank = A[:, 1] + A[:, 2] * m_fold
    d = np.abs(A[:, 1:3] - B[:, 1:3]) * scale
    if not (d <= RANK_FRAC * rank[:, None] + 1e-3 * scale).all():
        raise AssertionError(f"{name}: TP/FP differ by more than {RANK_FRAC} of the rank")
    avrec = [average_recall({"precision": X[:, 3], "recall": X[:, 4]}) for X in (A, B)]
    if abs(avrec[0] - avrec[1]) > AVREC_TOL:
        raise AssertionError(f"{name}: AvRec {avrec[0]} vs {avrec[1]}")
    return {"max_dscore": dscore, "avrec": avrec}


def compare_dirs(dir_a: str, dir_b: str, refined: bool, m_fold: float = 1.0) -> dict:
    """Check every file two runs wrote (metrics logs aside) against the bars
    of the module docstring; raises AssertionError on the first miss.
    ``m_fold``: the FDR run's FP divisor (--mFold, or #neg/#pos for user
    negatives), which turns the written TP and FP back into ranks.
    Returns what was measured: largest probability and score differences,
    rows near the cutoff, AvRec per .stats file."""
    names = sorted(n for n in os.listdir(dir_a) if not n.endswith(".metrics.jsonl"))
    other = sorted(n for n in os.listdir(dir_b) if not n.endswith(".metrics.jsonl"))
    if names != other:
        raise AssertionError(f"files differ: {names} vs {other}")
    out: dict = {"files": len(names), "max_dp": 0.0, "rows_near_cutoff": 0, "stats": {}}
    for n in names:
        pa, pb = os.path.join(dir_a, n), os.path.join(dir_b, n)
        if n.endswith((".hbcp", ".hbp")):
            if _lines(pa) != _lines(pb):
                raise AssertionError(f"{n} differs")
        elif n.endswith((".ihbcp", ".ihbp")):
            a, b = read_probs(pa), read_probs(pb)
            if not (np.isfinite(a).all() and np.isfinite(b).all()):
                raise AssertionError(f"{n}: non-finite probabilities")
            out["max_dp"] = max(out["max_dp"], float(np.abs(a - b).max()))
            if out["max_dp"] > (PROB_TOL if refined else 0.0):
                raise AssertionError(f"{n}: |dp| {out['max_dp']:.3e}")
        elif n.endswith(".occurrence"):
            out["rows_near_cutoff"] += _compare_hits(_lines(pa), _lines(pb), 5, refined, n,
                                                     pval_cols=(6, 7))
        elif n.endswith(".logOdds"):
            out["rows_near_cutoff"] += _compare_hits(_lines(pa), _lines(pb), 3, refined, n)
        elif n.endswith(".stats"):
            out["stats"][n] = _compare_stats(_lines(pa), _lines(pb), refined, n, m_fold)
        elif n.endswith(".pvalues"):
            a, b = np.loadtxt(pa, ndmin=1), np.loadtxt(pb, ndmin=1)
            if a.shape != b.shape or np.abs(a - b).max(initial=0.0) > (PVALUES_ATOL if refined else 0.0):
                raise AssertionError(f"{n}: p-values differ")
        else:
            raise AssertionError(f"{n}: no comparison for this file type")
    return out
