"""The comparison that decides ``correct`` for ``--EM --FDR`` jobs: every
seed's cross-validated evaluation (BaMMmotif2's ``FDR::evaluateMotif``) as
the job wrote it, its ``.zoops.stats`` and ``.mops.stats`` tables and the
AvRec of its ``fdr_done`` event, against a plain evaluation of the same
input.

The evaluation, written from BaMMmotif2's description: the rows go to
--cvFold folds round robin (row i to fold i mod F).  For each fold, each
seed (lifted as ``check_em`` lifts it) is refined by ZOOPS EM on the other
folds' rows (``reference.bamm``, float64), following the iterations the
job reports for that fold, over the background the job fits to the whole
set.  The refined model scores the fold's rows and --mFold times as many
negatives: rows of the fold's lengths sampled, with the key
``PRNGKey(--seed + fold)``, from the order --sOrder background fit to the
fold's training rows (``reference.threefry``, bit for bit the JAX
reference's stream).  Pooled over the folds, the rows' best window scores
give the ZOOPS sweep and every window's score the MOPS sweep: at a
threshold t, TP = positives >= t, FP = negatives >= t / mFold, ties
ranking positives first; the MOPS table keeps 20,000 ranks spread
uniformly, as the ZOOPS table does once it is longer; AvRec is the mean,
over FDR 0, 0.005, ..., 0.5, of the best recall at FDR <= f.

Numbers, the largest over the job's seeds and both tables:

  stats_score  |score_job - score_ref| at each written rank (the job writes
               six significant digits);
  stats_rank   how far each written rank lies outside the ranks the
               reference gives the written score (every value that rounds
               to it counted), in windows or rows;
  avrec_abs    |AvRec_job - AvRec_ref| (the job rounds to four digits);
  stop_dll     ``check_em``'s stop test at each fold's last iteration.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from reference import bamm, check_em, files, flags, threefry

NUMBERS = ("stats_score", "stats_rank", "avrec_abs", "stop_dll")
MAX_ROWS = 20_000


def thin(n: int, max_rows: int = MAX_ROWS) -> np.ndarray:
    """The ranks a table of n sweep points keeps: all, or max_rows spread
    uniformly with both ends."""
    if n > max_rows:
        return np.unique(np.round(np.linspace(0, n - 1, max_rows)).astype(np.int64))
    return np.arange(n, dtype=np.int64)


def sweep(pos: torch.Tensor, neg: torch.Tensor, m_fold: float, ranks: np.ndarray) -> dict:
    """The sweep over pooled scores at descending ``ranks``: score, TP, FP,
    precision and recall; within a tie the positives come first."""
    pos, neg = pos.double(), neg.double()
    pool = torch.sort(torch.cat([pos, neg]), descending=True).values
    r = torch.as_tensor(ranks, device=pool.device)
    s = pool[r]
    pos_sorted = torch.sort(pos).values
    pool_asc = torch.flip(pool, [0])
    n_gt = pool.numel() - torch.searchsorted(pool_asc, s, right=True)
    pos_gt = pos.numel() - torch.searchsorted(pos_sorted, s, right=True)
    pos_eq = torch.searchsorted(pos_sorted, s, right=True) - torch.searchsorted(pos_sorted, s)
    tp = pos_gt + torch.minimum(torch.clamp(r + 1 - n_gt, min=0), pos_eq)
    fp = (r + 1 - tp).double() / m_fold
    tp = tp.double()
    return {"score": s.cpu().numpy(), "pool": pool, "tp": tp.cpu().numpy(),
            "fp": fp.cpu().numpy(),
            "precision": (tp / torch.clamp(tp + fp, min=1e-30)).cpu().numpy(),
            "recall": (tp / max(pos.numel(), 1)).cpu().numpy()}


def average_recall(precision: np.ndarray, recall: np.ndarray) -> float:
    fdr = 1.0 - precision
    order = np.argsort(fdr, kind="stable")
    best = np.maximum.accumulate(recall[order])
    at = np.searchsorted(fdr[order], np.linspace(0.0, 0.5, 101), side="right") - 1
    return float(np.where(at >= 0, best[np.clip(at, 0, None)], 0.0).mean())




def negatives(codes: torch.Tensor, held: torch.Tensor, train: torch.Tensor, opts: dict,
              fold: int, n_pad: int) -> torch.Tensor:
    """The fold's negatives int64 [n, L]: mFold copies of its rows'
    lengths, padded with rows of length 0 to ``n_pad`` (the largest fold's
    count), sampled from the background of order --sOrder fit to the
    training rows; the rows of length 0 are dropped."""
    L = codes.shape[1]
    v = bamm.background(codes[train], int(opts["--sOrder"]), float(opts["-A"]))
    lens = torch.zeros(n_pad, dtype=torch.int64, device=codes.device)
    lens[: int(held.sum()) * int(opts["--mFold"])] = L
    sampled = threefry.markov_codes(threefry.prng_key(int(opts["--seed"]) + fold, codes.device),
                                    [x.to(torch.float32) for x in v], lens, L)
    return sampled[lens > 0]


def run(codes: torch.Tensor, meme: str, argv: list, follow: dict | None = None,
        dtype=torch.float64, acc=torch.float64, stop_dtype=torch.float32) -> dict:
    """The evaluation of every seed: {seed index: {"zoops", "mops" (sweeps
    at the tables' ranks), "avrec_zoops", "avrec_mops", "folds" (``bamm.
    em``'s "at" a fold, or with no ``follow`` its "own")}}; ``follow``:
    {W: [F][M] iterations} of the job's groups."""
    opts = flags.parse(argv)
    groups, f_bg, bgr, _rows, K = check_em.models(codes, meme, opts)
    N = codes.shape[0]
    F, m_fold = int(opts["--cvFold"]), float(opts["--mFold"])
    fold_of = torch.arange(N, device=codes.device) % F
    n_pad = int(torch.bincount(fold_of, minlength=F).max()) * int(opts["--mFold"])
    out = {}
    for W, (idx, v0, al) in groups.items():
        M = len(idx)
        pools = [{"pz": [], "nz": [], "pm": [], "nm": []} for _ in range(M)]
        folds: list = [[] for _ in range(M)]
        for f in range(F):
            held, train = fold_of == f, fold_of != f
            r = bamm.em(v0, float(opts["-q"]), bamm.strand_rows(codes[train], K), bgr, al,
                        f_bg, K=K, W=W, eps=float(opts["-e"]),
                        max_iters=int(opts["--maxEMIterations"]), dtype=dtype, acc=acc,
                        stop_dtype=stop_dtype,
                        follow=[follow[W][f][m] for m in range(M)] if follow else None)
            # every window [S, N, L-W+1] of the fold's rows and of its negatives,
            # both strands, as indices into a LUT [R+1, W] read flat
            windex = {side: bamm.window_index(bamm.strand_rows(rows, K), W) for side, rows in
                      (("p", codes[held]), ("n", negatives(codes, held, train, opts, f, n_pad)))}
            for m in range(M):
                snap = r["at"][m] if follow else r["own"][m]
                folds[m].append(snap)
                lut = bamm.log_odds([x.to(codes.device, dtype) for x in snap["v"]], bgr)
                for side, wi in windex.items():
                    sc = lut.reshape(-1)[wi].sum(dim=-1, dtype=acc)
                    pools[m][side + "z"].append(sc.amax(dim=(0, 2)))
                    pools[m][side + "m"].append(sc.reshape(-1))
        for m, i in enumerate(idx):
            res = {"folds": folds[m]}
            for name, tag in (("zoops", "z"), ("mops", "m")):
                pos, neg = torch.cat(pools[m]["p" + tag]), torch.cat(pools[m]["n" + tag])
                n = pos.numel() + neg.numel()
                # the ZOOPS AvRec reads the whole sweep, the MOPS one the table's ranks
                s = sweep(pos, neg, m_fold, np.arange(n) if tag == "z" else thin(n))
                res["avrec_" + name] = average_recall(s["precision"], s["recall"])
                res[name] = s if tag == "m" else {k: x[thin(n)] if k != "pool" else x
                                                  for k, x in s.items()}
            out[i] = res
    return out


def read_stats(path: str) -> np.ndarray:
    """The score column of a ``.stats`` table."""
    with open(path) as fh:
        next(fh)
        return np.array([float(line.split("\t")[0]) for line in fh])


def rank_gap(written: np.ndarray, ranks: np.ndarray, pool: torch.Tensor) -> float:
    """The largest distance of each written rank from the ranks (0-based,
    descending) that the reference's pool gives any value that rounds to
    the written score at six significant digits."""
    mag = np.floor(np.log10(np.maximum(np.abs(written), 1e-300)))
    half = 0.5 * 10.0 ** (mag - 5)
    asc = torch.flip(pool, [0])
    hi = torch.as_tensor(written + half, device=pool.device)
    lo = torch.as_tensor(written - half, device=pool.device)
    first = (pool.numel() - torch.searchsorted(asc, hi, right=True)).cpu().numpy()
    last = (pool.numel() - torch.searchsorted(asc, lo, right=False)).cpu().numpy() - 1
    return float(np.maximum(0, np.maximum(first - ranks, ranks - last)).max(initial=0))


def job_iterations(ev: dict) -> dict:
    """{W: [F][M] fold iterations} from the job's fdr.fetch spans."""
    spans = {s["id"]: s for s in ev.get("span", [])}
    return {spans[s["parent"]]["attrs"]["W"]: s["attrs"]["iterations"]
            for s in spans.values() if s["name"] == "fdr.fetch"}


def judge(job: dict, device) -> dict:
    """The numbers of one job: ``job`` holds its ``codes`` (int8 [N, L]),
    ``meme``, ``argv`` and ``outdir`` (its files, with
    ``<basename>.metrics.jsonl``)."""
    base = os.path.splitext(os.path.basename(job["argv"][1]))[0]
    ev = files.read_events(os.path.join(job["outdir"], f"{base}.metrics.jsonl"))
    opts = flags.parse(job["argv"])
    done = {e["motif"]: e for e in ev.get("fdr_done", [])}
    seeds = check_em.seeds(job["meme"], opts)
    names = [n for n, _p, _s in seeds]
    follow = job_iterations(ev)
    if sorted(done) != sorted(names) or set(follow) != {p.shape[0] for _n, p, _s in seeds}:
        return dict.fromkeys(NUMBERS, float("inf"))
    codes = torch.as_tensor(job["codes"], device=device).to(torch.int64)
    ref = run(codes, job["meme"], job["argv"], follow=follow)
    eps, cap = float(opts["-e"]), int(opts["--maxEMIterations"])
    out = dict.fromkeys(NUMBERS, 0.0)
    for i, n in enumerate(names):
        for tag in ("zoops", "mops"):
            s = ref[i][tag]
            written = read_stats(os.path.join(job["outdir"], f"{base}_{n}.{tag}.stats"))
            if written.size != s["score"].size:
                return dict.fromkeys(NUMBERS, float("inf"))
            ranks = thin(s["pool"].numel())
            out["stats_score"] = max(out["stats_score"],
                                     float(np.abs(written - s["score"]).max(initial=0)))
            out["stats_rank"] = max(out["stats_rank"], rank_gap(written, ranks, s["pool"]))
            out["avrec_abs"] = max(out["avrec_abs"],
                                   abs(float(done[n][f"avrec_{tag}"]) - ref[i][f"avrec_{tag}"]))
        for at in ref[i]["folds"]:
            if at["its"] < cap:
                spacing = float(np.spacing(np.float32(abs(at["ll"]))))
                gap = min(at["vdiff"] / eps, abs(at["dll"]) / max(eps, spacing))
                out["stop_dll"] = max(out["stop_dll"], gap)
    return out
