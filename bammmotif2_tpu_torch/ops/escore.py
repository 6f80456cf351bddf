"""Window scoring, ZOOPS responsibilities, and M-step count collection.

Port of ``bammmotif2_tpu.ops.escore``: the plain PyTorch versions of the
math the fused CUDA kernel (``ops.cuda_em``) computes in one pass.  They run
on any device and in the dtype of their inputs (float32 on the main path).

  - ``window_scores``: score[s, n, i] = sum_j s_flat[cidx[s, n, i+j], j],
    W shifted gathers against the [R+1, W] combined log-odds LUT.
  - ``zoops_posterior``: log-space ZOOPS E-step over {no occurrence} + all
    windows of all strands, and the total log-likelihood.
  - ``mstep_counts``: the transposed op, one ``index_add_`` per motif
    offset j.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps reductions NaN-free


def window_mask(lens: torch.Tensor, n_windows: int, W: int) -> torch.Tensor:
    """[N, n_windows] bool: window start i is valid iff i + W <= len."""
    i = torch.arange(n_windows, device=lens.device)[None, :]
    return i + W <= lens[:, None]


def window_scores(s_flat: torch.Tensor, cidx: torch.Tensor, lens: torch.Tensor, W: int):
    """Per-window motif-vs-background log-odds.

    s_flat [R+1, W] (row R = zero sentinel), cidx int32 [S, N, L],
    lens int32 [N].  Returns (scores [S, N, L-W+1] with NEG_INF on
    invalid windows, mask bool [N, L-W+1]).
    """
    S, N, L = cidx.shape
    n_win = L - W + 1
    if n_win <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {L}")
    idx = cidx.to(torch.int64)
    scores = torch.zeros((S, N, n_win), dtype=s_flat.dtype, device=cidx.device)
    for j in range(W):
        scores = scores + s_flat[:, j][idx[:, :, j : j + n_win]]
    mask = window_mask(lens, n_win, W)
    return torch.where(mask[None], scores, NEG_INF), mask


def zoops_posterior(scores: torch.Tensor, mask: torch.Tensor, q: torch.Tensor) -> tuple:
    """ZOOPS E-step in log space.

    Each sequence has no occurrence (prior 1-q) or exactly one occurrence
    uniform over its valid windows across all strands (prior q / n_win).

    Returns (r [S, N, n_win] with 0 on invalid windows, r0 [N], ll [] the
    total ZOOPS log-likelihood relative to background).
    """
    S = scores.shape[0]
    n_win_per_seq = S * mask.sum(dim=1)  # [N]
    log_prior = torch.where(
        n_win_per_seq > 0,
        torch.log(q) - torch.log(n_win_per_seq.clamp(min=1).to(scores.dtype)),
        NEG_INF,
    )  # [N]
    log_w = scores + log_prior[None, :, None]
    log_r0 = torch.log1p(-q)
    m = torch.maximum(log_w.amax(dim=(0, 2)), log_r0)  # [N]
    denom = torch.exp(log_r0 - m) + torch.exp(log_w - m[None, :, None]).sum(dim=(0, 2))
    log_z = m + torch.log(denom)
    r = torch.exp(log_w - log_z[None, :, None])
    r = torch.where(mask[None], r, 0.0)
    r0 = torch.exp(log_r0 - log_z)
    return r, r0, log_z.sum()


def mstep_counts(r: torch.Tensor, cidx: torch.Tensor, R: int, W: int) -> torch.Tensor:
    """C[row, j] = sum over (s, n, i) of r[s, n, i] * 1[cidx[s, n, i+j] == row].

    Returns [R+1, W] in r's dtype; row R collects the sentinel/invalid mass.
    The sums run in float64 and are rounded once: on a GPU, index_add_ adds
    ~1e5 responsibilities per cell with float atomics, which in float32 left
    a 1e-4 relative error per EM iteration (0.9 at |C| ~ 8000 on an H100),
    and slowly converging EM accumulates such errors ~30-fold.
    """
    return mstep_counts_f64(r, cidx, R, W).to(r.dtype)


def mstep_counts_f64(r: torch.Tensor, cidx: torch.Tensor, R: int, W: int) -> torch.Tensor:
    """``mstep_counts``' float64 sums before their rounding, [R+1, W]."""
    n_win = r.shape[-1]
    rf = r.reshape(-1).to(torch.float64)
    C = torch.zeros((R + 1, W), dtype=torch.float64, device=r.device)
    for j in range(W):
        idx = cidx[:, :, j : j + n_win].reshape(-1).to(torch.int64)
        C[:, j].index_add_(0, idx, rf)
    return C
