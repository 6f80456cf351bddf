"""A plain BaMM: background fit, seed lifting and ZOOPS EM, in torch.

The benchmark's reference for the port's refinement (BaMMmotif2's
``EM::optimize``, ``EStep``, ``MStep``, ``optimizeQ``; the interpolated
pseudo-count estimator of Siebert & Soeding, NAR 2016).  Written from the
algorithm, one operation on whole tensors at a time, in the dtype it is
given: float64 as the reference, a lower precision as the control.  It
reads only the benchmark's inputs (the codes it generated, the seed PWMs
as the MEME file states them) and derives everything else again.

Rows are unambiguous and of one length (the benchmark's traffic), both
strands are scanned; A = 4, the complement of code c is 3 - c.

k-mer rows: the combined table holds every order k <= K in one block of
rows each, order k's block at off[k] = sum_{m<k} A^(m+1); a position t's
row is off[m] + the lexicographic code of the bases t-m..t (the oldest
most significant), m = min(t, K); the sentinel row R is always zero.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

A = 4


def offsets(K: int) -> list:
    out = [0]
    for k in range(K + 1):
        out.append(out[-1] + A ** (k + 1))
    return out


def revcomp(codes: torch.Tensor) -> torch.Tensor:
    return (3 - codes).flip(-1)


def kmer_rows(codes: torch.Tensor, K: int) -> torch.Tensor:
    """int64 [N, L]: each position's combined row (context cut at t)."""
    codes = codes.to(torch.int64)
    off = offsets(K)
    out = codes + off[0]
    acc = codes.clone()
    for k in range(1, K + 1):
        acc = acc.clone()
        acc[:, k:] = acc[:, k:] + codes[:, :-k] * A ** k
        out[:, k:] = acc[:, k:] + off[k]
    return out


def strand_rows(codes: torch.Tensor, K: int) -> torch.Tensor:
    """int64 [2, N, L]: the rows of the forward strand and its reverse
    complement."""
    return torch.stack([kmer_rows(codes, K), kmer_rows(revcomp(codes), K)])


def per_order(C: torch.Tensor, K: int) -> list:
    """Combined-row counts [..., R, W] -> per-order counts [..., A^(k+1),
    W]: those at positions of exactly order k plus the order-(k+1) counts
    summed over their oldest base."""
    off = offsets(K)
    lead, W = C.shape[:-2], C.shape[-1]
    out = [None] * (K + 1)
    out[K] = C[..., off[K] : off[K + 1], :]
    for k in range(K - 1, -1, -1):
        up = out[k + 1].reshape(*lead, A, A ** (k + 1), W).sum(dim=-3)
        out[k] = C[..., off[k] : off[k + 1], :] + up
    return out


def background(codes: torch.Tensor, order: int, alpha: float) -> list:
    """The homogeneous background of ``order`` fit to both strands of
    ``codes``, float64 [A^(k+1)] a order: v0 = (n + alpha/A) / (N + alpha),
    v_k(y) = (n(y) + alpha v_(k-1)(y without its oldest base))
             / (n(context of y) + alpha)."""
    R = offsets(order)[-1]
    rows = strand_rows(codes, order).reshape(-1)
    C = torch.bincount(rows, minlength=R).to(torch.float64)
    n = [x[:, 0] for x in per_order(C[:, None], order)]
    v = [(n[0] + alpha / A) / (n[0].sum() + alpha)]
    for k in range(1, order + 1):
        y = torch.arange(A ** (k + 1), device=C.device)
        ctx = n[k].reshape(-1, A).sum(dim=1)
        v.append((n[k] + alpha * v[k - 1][y % A ** k]) / (ctx[y // A] + alpha))
    return v


def base_freqs(codes: torch.Tensor) -> torch.Tensor:
    """Mono-nucleotide frequencies of the forward strand, float64 [A]."""
    n = torch.bincount(codes.reshape(-1).to(torch.int64), minlength=A).to(torch.float64)
    return n / n.sum()


def bg_rows(v_bg: list, K: int) -> torch.Tensor:
    """The background conditional of every combined row of an order-K
    model: row (k, y) takes order min(k, order of the background)."""
    out = []
    for k in range(K + 1):
        kb = min(k, len(v_bg) - 1)
        y = torch.arange(A ** (k + 1), device=v_bg[0].device)
        out.append(v_bg[kb][y % A ** (kb + 1)])
    return torch.cat(out)


def default_alphas(K: int, W: int, alpha: float, beta: float, gamma: float) -> torch.Tensor:
    """alpha_0 = alpha, alpha_k = beta gamma^(k-1), float64 [K+1, W]."""
    return torch.tensor([[alpha if k == 0 else beta * gamma ** (k - 1)] * W
                         for k in range(K + 1)], dtype=torch.float64)


def update_v(counts: list, alphas: torch.Tensor, f_bg: torch.Tensor) -> list:
    """The interpolated estimator over counts [..., A^(k+1), W]:
    v0 = (n + a0 f_bg) / (N_j + a0), v_k(y) = (n(y) + a_k v_(k-1)(y
    without its oldest base)) / (n(context of y) + a_k)."""
    a0 = alphas[..., 0:1, :]
    v = [(counts[0] + a0 * f_bg[:, None]) / (counts[0].sum(dim=-2, keepdim=True) + a0)]
    for k in range(1, len(counts)):
        nk, ak = counts[k], alphas[..., k : k + 1, :]
        y = torch.arange(A ** (k + 1), device=nk.device)
        ctx = nk.reshape(*nk.shape[:-2], A ** k, A, nk.shape[-1]).sum(dim=-2)
        v.append((nk + ak * v[k - 1][..., y % A ** k, :]) / (ctx[..., y // A, :] + ak))
    return v


def lift_pwm(pwm: np.ndarray, K: int, f_bg: torch.Tensor, alphas: torch.Tensor,
             nsites: float = 100.0) -> list:
    """A PWM [W, A] as an order-K model: nsites times its rows are the
    order-0 counts, higher orders start from no counts."""
    W = pwm.shape[0]
    counts = [torch.as_tensor(pwm.T * nsites, dtype=torch.float64, device=f_bg.device)]
    counts += [torch.zeros((A ** (k + 1), W), dtype=torch.float64, device=f_bg.device)
               for k in range(1, K + 1)]
    return update_v(counts, alphas.to(f_bg.device), f_bg)


def log_odds(v: list, bgr: torch.Tensor) -> torch.Tensor:
    """[..., R+1, W]: log(v / v_bg) a combined row, and the zero sentinel."""
    s = torch.log(torch.cat(v, dim=-2)) - torch.log(bgr)[:, None].to(v[0].dtype)
    return torch.cat([s, torch.zeros_like(s[..., :1, :])], dim=-2)


def row_matrix(rows: torch.Tensor, R1: int, acc) -> torch.Tensor:
    """The positions' rows as a sparse 0/1 matrix [R1, S*N*L] (CSR) in
    ``acc``: its product with a weight a position sums the weights by
    row."""
    flat = rows.reshape(-1)
    order = torch.argsort(flat, stable=True)
    crow = torch.zeros(R1 + 1, dtype=torch.int64, device=flat.device)
    crow[1:] = torch.cumsum(torch.bincount(flat, minlength=R1), 0)
    ones = torch.ones(flat.numel(), dtype=acc, device=flat.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(crow, order, ones, size=(R1, flat.numel()),
                                       check_invariants=False)


def window_index(rows: torch.Tensor, W: int) -> torch.Tensor:
    """int64 [S, N, L-W+1, W]: row * W + j of position i + j of every
    window i, the index of its terms in a LUT [R+1, W] read flat."""
    return rows.unfold(-1, W, 1) * W + torch.arange(W, device=rows.device)


def em_step(v: list, q: torch.Tensor, rows: torch.Tensor, windex: torch.Tensor,
            rowmat: torch.Tensor, bgr: torch.Tensor, alphas: torch.Tensor, f_bg: torch.Tensor,
            K: int, W: int, acc) -> tuple:
    """One ZOOPS EM iteration of M models at once: (v, q [M]) ->
    (v', q', ll [M], v_diff [M]).  A row has no site (prior 1 - q) or one
    uniform over its windows on both strands (q / windows); ll is the sum
    over rows of the log of the row's total, against the background.
    Elementwise work runs in q's dtype, sums accumulate in ``acc``.
    ``windex``: ``window_index(rows, W)``; ``rowmat``: ``row_matrix``."""
    M, dt = q.shape[0], q.dtype
    S, N, L = rows.shape
    nw = L - W + 1
    lut = log_odds(v, bgr)
    R1 = lut.shape[1]
    scores = lut.reshape(M, -1)[:, windex].sum(dim=-1)  # [M, S, N, nw]
    log_w = scores + (torch.log(q) - np.log(S * nw))[:, None, None, None]
    log_r0 = torch.log1p(-q)[:, None]
    m = torch.maximum(log_w.amax(dim=(1, 3)), log_r0)
    tot = torch.exp(log_w - m[:, None, :, None]).sum(dim=(1, 3), dtype=acc)
    log_z = m + torch.log(torch.exp(log_r0 - m).to(acc) + tot).to(dt)
    r = torch.exp(log_w - log_z[:, None, :, None]).permute(1, 2, 3, 0).to(acc)  # [S, N, nw, M]
    # position t's weight for column j is r of the window that starts at t - j
    shifted = torch.zeros((S, N, L, M, W), dtype=acc, device=q.device)
    for j in range(W):
        shifted[:, :, j : j + nw, :, j] = r
    C = torch.sparse.mm(rowmat, shifted.reshape(S * N * L, M * W))
    C = C.reshape(R1, M, W).permute(1, 0, 2)
    v2 = update_v(per_order(C[:, : R1 - 1].to(dt), K), alphas, f_bg)
    q2 = torch.clamp((C.sum(dim=1)[:, 0] / N).to(dt), 1e-4, 1 - 1e-4)
    vd = sum((a - b).abs().sum(dim=(-2, -1), dtype=acc) for a, b in zip(v2, v))
    return v2, q2, log_z.sum(dim=1, dtype=acc), vd


def em(v0: list, q0: float, rows: torch.Tensor, bgr: torch.Tensor, alphas: torch.Tensor,
       f_bg: torch.Tensor, *, K: int, W: int, eps: float, max_iters: int, dtype=torch.float64,
       acc=torch.float64, stop_dtype=torch.float32, follow: list | None = None) -> dict:
    """EM of the models v0 (float64 [M, A^(k+1), W] a order) from q0:
    elementwise in ``dtype``, sums in ``acc``.  Each model stops at the
    first iteration where its v_diff or |ll - previous ll|, both rounded
    to ``stop_dtype``, falls under eps: ``own``[m] holds its iterations,
    v, q and ll then.  With ``follow`` (an iteration count a model) every
    model also runs on to its count, and ``at``[m] holds its v, q and ll
    after that many iterations, with that iteration's v_diff and its
    change of ll (``dll``) unrounded."""
    M, dev = v0[0].shape[0], rows.device
    v = [x.to(dtype) for x in v0]
    q = torch.full((M,), q0, dtype=dtype, device=dev)
    rowmat = row_matrix(rows, offsets(K)[-1] + 1, acc)
    args = (rows, window_index(rows, W), rowmat, bgr.to(dtype), alphas.to(dtype),
            f_bg.to(dtype), K, W, acc)
    eps_s = torch.tensor(eps, dtype=stop_dtype)
    prev = torch.full((M,), float("-inf"), dtype=stop_dtype)
    prev_ll = [float("-inf")] * M
    own: list = [None] * M
    at: list = [None] * M
    last = max(follow) if follow else 0

    def snap(m, it, v2, q2, ll, vd):
        return {"its": it, "v": [x[m].double().cpu() for x in v2], "q": float(q2[m]),
                "ll": float(ll[m]), "vdiff": float(vd[m]), "dll": float(ll[m]) - prev_ll[m]}

    for it in range(1, max_iters + 1):
        if all(o is not None for o in own) and it > last:
            break
        v2, q2, ll, vd = em_step(v, q, *args)
        ll_s, vd_s = ll.to(stop_dtype).cpu(), vd.to(stop_dtype).cpu()
        stop = torch.minimum(vd_s, (ll_s - prev).abs()) < eps_s
        prev = ll_s
        for m in range(M):
            if own[m] is None and (bool(stop[m]) or it == max_iters):
                own[m] = snap(m, it, v2, q2, ll, vd)
            if follow and follow[m] == it:
                at[m] = snap(m, it, v2, q2, ll, vd)
        prev_ll = ll.double().cpu().tolist()
        v, q = v2, q2
    return {"own": own, "at": at}
