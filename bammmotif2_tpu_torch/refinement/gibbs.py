"""Collapsed Gibbs sampling refinement with pseudo-count (alpha) learning.

Port of ``bammmotif2_tpu.refinement.gibbs`` (``GibbsSampling::optimize``,
``CollapsedGibbsSampling``, ``updateAlphas``).  As in the reference, the
sweep is batch-synchronous: every z_n is sampled from the current model,
then the counts are rebuilt once.  One stacked implementation serves M
chains (the seeds of a (W, K, f_bg) group); ``gibbs_step`` and
``run_gibbs`` are its M=1 views.

One sweep, for every chain m:
  1. window scores for all M LUTs in one launch (``ops.cuda_scores``);
  2. the flat logits [N, 1 + S*n_win]: log(1-q) for "no occurrence", then
     score + log(q / (S * n_win_n)) per window (NEG_INF for rows with no
     valid window);
  3. z_n by the inverse CDF of the row's softmax (argmax under
     --noZSampling);
  4. the 0/1 occupancy r [M, S, N, L], scattered into a zeroed buffer;
  5. counts from r for all M chains in one launch (``ops.cuda_counts``),
     split into per-order counts;
  6. q ~ Beta(n_occ + 1, n_real - n_occ + 1), clipped to [1e-4, 1 - 1e-4]
     (kept under --noQSampling);
  7. one gradient-ascent step on the collapsed log posterior of log alpha
     (``torch.autograd``), clipped (--noAlphaOptimization skips it);
  8. v from the counts and the new alphas (``models.motif.update_v``);
  9. the ZOOPS ll with the sweep's old q, for monitoring.

Randomness.  The chain of the motif at global input index i owns one
``torch.Generator`` on the data's device, seeded ``chain_seed(params.seed,
i)`` (numpy's SeedSequence of the pair, so chains of different indices or
run seeds are independent).  Each sweep draws one uniform per sequence row
[N] for z, then q as the ratio of two gamma draws.  So a stacked chain
reproduces its solo run exactly, and the kernel and plain paths draw the
same numbers on one device.  Streams differ from ``jax.random``'s: the
deterministic path (--noZSampling --noQSampling) is compared with the
reference, the sampled path by distribution.

The sweep loop makes no host sync: CGS has a fixed number of sweeps and no
stop test, and the ll history stays on the device until the end.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import (
    Motif, counts_from_combined, log_odds_lut, tile_rows, update_v,
)
from bammmotif2_tpu_torch.ops import cuda_counts, cuda_scores, encode
from bammmotif2_tpu_torch.ops.escore import NEG_INF
from bammmotif2_tpu_torch.refinement.em import choose_path, prepare_data, synchronize
from bammmotif2_tpu_torch.scoring.scan import score_fn

ALPHA_LR = 0.05
GRAD_CLIP = 10.0
# log-alpha bounds, as float32 values (the reference clips at jnp.log(1e-2),
# jnp.log(1e4) in float32)
LOG_ALPHA_MIN = float(np.log(np.float32(1e-2)))
LOG_ALPHA_MAX = float(np.log(np.float32(1e4)))
Q_MIN, Q_MAX = 1e-4, 1 - 1e-4


@dataclasses.dataclass
class GibbsResult:
    iterations: int
    ll: float
    q: float
    seconds: float       # sweep loop time (kernel build excluded); in
                         # batched group runs: this seed's equal share of
                         # the group wall clock
    ll_history: list
    alphas: np.ndarray
    compile_seconds: float = 0.0  # kernel build/load time (0 when cached)
    group_seconds: float = 0.0    # raw wall-clock of the batched group
                                  # this seed ran in (0 = solo run)


def chain_seed(seed: int, index: int) -> int:
    """The generator seed of the chain of the motif at global input index
    ``index`` in a run seeded ``seed``: numpy's SeedSequence of the pair,
    as one 64-bit integer."""
    ss = np.random.SeedSequence([seed % 2 ** 64, index])
    return int(ss.generate_state(1, np.uint64)[0])


def chain_generators(seed: int, indices, device) -> list:
    """One ``torch.Generator`` on ``device`` per chain index."""
    device = torch.device(device)
    return [torch.Generator(device=device).manual_seed(chain_seed(seed, i)) for i in indices]


def counts_fn(path: str):
    """The count op of a path: the kernel or its plain version."""
    return cuda_counts.counts_from_r_multi if path == "cuda" else cuda_counts.counts_from_r_multi_ref


def build_seconds(path: str) -> float:
    """Build/load the path's kernels now, so sweep timings exclude it."""
    if path != "cuda":
        return 0.0
    t0 = time.perf_counter()
    cuda_scores.library()
    cuda_counts.library()
    return time.perf_counter() - t0


def _log_alpha_posterior(log_alphas, counts, f_bg, default_alphas):
    """Collapsed log posterior of log(alpha) given hard counts, summed over
    every leading (seed) index.

    log_alphas, default_alphas [..., K+1, W]; counts tuple of [...,
    A^(k+1), W]; f_bg [A].  Returns a scalar; its gradient w.r.t.
    log_alphas is every seed's gradient at once.  The prior means of order
    k are v^(k-1) from these counts, and v depends on log alpha.
    """
    K = len(counts) - 1
    A = f_bg.shape[0]
    v = update_v(counts, torch.exp(log_alphas), f_bg)
    total = torch.zeros((), dtype=log_alphas.dtype, device=log_alphas.device)
    for k in range(K + 1):
        a = torch.exp(log_alphas[..., k : k + 1, :])  # [..., 1, W]
        nk = counts[k]
        lower = f_bg[:, None] if k == 0 else tile_rows(v[k - 1], A)
        am = a * lower  # prior pseudo-counts per (y, j)
        # sum over k-mers y: log Gamma(n + a v') - log Gamma(a v')
        total = total + (torch.lgamma(nk + am) - torch.lgamma(am)).sum()
        # sum over contexts x: log Gamma(a) - log Gamma(n_x + a)
        ctx = nk.reshape(*nk.shape[:-2], -1, A, nk.shape[-1]).sum(dim=-2)
        total = total + (torch.lgamma(a) - torch.lgamma(ctx + a)).sum()
        # InvGamma(1, scale) prior on alpha, plus the log-alpha Jacobian
        scale = default_alphas[..., k : k + 1, :]
        total = total + (-2.0 * torch.log(a) - scale / a + torch.log(a)).sum()
    return total


def alpha_step(log_alphas, counts, f_bg, default_alphas, lr: float = ALPHA_LR):
    """One clipped gradient-ascent step on log alpha [..., K+1, W]."""
    with torch.enable_grad():
        la = log_alphas.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(_log_alpha_posterior(la, counts, f_bg, default_alphas), la)
    la = log_alphas + lr * grad.clamp(-GRAD_CLIP, GRAD_CLIP)
    return la.clamp(LOG_ALPHA_MIN, LOG_ALPHA_MAX)


def flat_logits(scores: torch.Tensor, mask: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-row ZOOPS logits [M, N, 1 + S*n_win] from scores [M, S, N, n_win],
    mask [N, n_win] and q [M]: column 0 is log(1-q), column 1 + s*n_win + i
    the window (s, i)."""
    M, S, N, n_win = scores.shape
    n_win_per_seq = S * mask.sum(dim=1)  # [N]
    log_prior = torch.where(
        (n_win_per_seq > 0)[None],
        torch.log(q)[:, None] - torch.log(n_win_per_seq.clamp(min=1).to(scores.dtype))[None],
        NEG_INF,
    )  # [M, N]
    log_w = scores + log_prior[:, None, :, None]
    absent = torch.log1p(-q)[:, None, None].expand(M, N, 1)
    return torch.cat([absent, log_w.permute(0, 2, 1, 3).reshape(M, N, S * n_win)], dim=2)


def draw_z(flat: torch.Tensor, gens: list, sample: bool) -> torch.Tensor:
    """z [M, N] int64: 0 = no occurrence, else 1 + the flat window index.

    Sampled: the inverse CDF of each row's softmax at one uniform per row
    from the chain's generator (the CDF in float64, so the target u * total
    stays below the total and never lands on a zero-probability column).
    Else the argmax (first on ties).
    """
    if not sample:
        return flat.argmax(dim=-1)
    M, N, _ = flat.shape
    u = torch.stack([torch.rand(N, generator=g, device=flat.device) for g in gens])
    p = torch.exp(flat - flat.amax(dim=-1, keepdim=True))
    cdf = torch.cumsum(p.to(torch.float64), dim=-1)
    target = (u.to(torch.float64) * cdf[..., -1]).unsqueeze(-1)
    return torch.searchsorted(cdf, target, right=True).squeeze(-1)


def draw_beta(a: torch.Tensor, b: torch.Tensor, gens: list) -> torch.Tensor:
    """Beta(a[m], b[m]) per chain, as X / (X + Y) with X ~ Gamma(a[m]) and
    Y ~ Gamma(b[m]) drawn in that order from chain m's generator."""
    out = []
    for m, g in enumerate(gens):
        x = torch._standard_gamma(a[m : m + 1], generator=g)
        y = torch._standard_gamma(b[m : m + 1], generator=g)
        out.append(x / (x + y))
    return torch.cat(out)


def occupancy(z: torch.Tensor, S: int, L: int, n_win: int) -> torch.Tensor:
    """The 0/1 responsibilities r [M, S, N, L] of the draws z [M, N]: one
    at the chosen window of each occupied row, zero elsewhere (a scatter
    into a zeroed buffer, one write per (m, n))."""
    M, N = z.shape
    occupied = z > 0
    zi = (z - 1).clamp(min=0)
    s, i = zi // n_win, zi % n_win
    m = torch.arange(M, device=z.device)[:, None]
    n = torch.arange(N, device=z.device)[None, :]
    idx = ((m * S + s) * N + n) * L + i
    r = torch.zeros(M * S * N * L, dtype=torch.float32, device=z.device)
    r.scatter_(0, idx.reshape(-1), occupied.reshape(-1).to(torch.float32))
    return r.reshape(M, S, N, L)


def gibbs_step_multi(
    v: tuple,
    q: torch.Tensor,
    log_alphas: torch.Tensor,
    gens: list,
    data: dict,
    f_bg: torch.Tensor,
    default_alphas: torch.Tensor,
    n_real: float,
    *,
    A: int,
    K: int,
    W: int,
    sample_z: bool,
    sample_q: bool,
    learn_alpha: bool,
    path: str = "plain",
    alpha_lr: float = ALPHA_LR,
):
    """One batch-synchronous CGS sweep for M chains.

    v: tuple of [M, A^(k+1), W]; q [M]; log_alphas, default_alphas
    [M, K+1, W]; gens: one generator per chain; data: {cidx, lens,
    bg_flat} (``refinement.em.prepare_data``); n_real: the number of real
    rows (zero-length mask rows excluded).

    Returns (v, q, log_alphas, ll [M], n_occ [M], counts tuple of
    [M, A^(k+1), W]).
    """
    cidx, lens = data["cidx"], data["lens"]
    R = encode.num_rows(A, K)
    L = cidx.shape[2]
    s_flat = log_odds_lut(v, data["bg_flat"]).contiguous()  # [M, R+1, W]
    scores, mask = score_fn(path)(s_flat, cidx, lens)
    _M, S, N, n_win = scores.shape

    flat = flat_logits(scores, mask, q)
    z = draw_z(flat, gens, sample_z)
    occupied = z > 0
    n_occ = occupied.sum(dim=1).to(torch.float32)
    C = counts_fn(path)(occupancy(z, S, L, n_win), cidx, R, W)
    counts = counts_from_combined(C[:, :R], A, K)

    if sample_q:
        # zero-length mask rows can never be occupied and are not in n_real
        q_new = draw_beta(n_occ + 1.0, n_real - n_occ + 1.0, gens).clamp(Q_MIN, Q_MAX)
    else:
        q_new = q
    if learn_alpha:
        log_alphas = alpha_step(log_alphas, counts, f_bg, default_alphas, alpha_lr)
    v_new = update_v(counts, torch.exp(log_alphas), f_bg)

    # the ZOOPS ll with this sweep's q; each zero-length row adds log(1-q)
    ll = torch.logsumexp(flat, dim=-1).sum(dim=-1) - (N - n_real) * torch.log1p(-q)
    return v_new, q_new, log_alphas, ll, n_occ, counts


def gibbs_step(v, q, log_alphas, gen, data, f_bg, default_alphas, n_real, **kw):
    """``gibbs_step_multi`` for one chain: v tuple of [A^(k+1), W], q [],
    log_alphas and default_alphas [K+1, W], one generator.  Returns
    (v, q, log_alphas, ll, n_occ, counts) without the seed axis."""
    out = gibbs_step_multi(
        tuple(vk[None] for vk in v), q.reshape(1), log_alphas[None], [gen], data,
        f_bg, default_alphas[None], n_real, **kw,
    )
    v, q, la, ll, n_occ, counts = out
    return tuple(vk[0] for vk in v), q[0], la[0], ll[0], n_occ[0], tuple(c[0] for c in counts)


def gibbs_optimize(
    v: tuple,
    q: torch.Tensor,
    log_alphas: torch.Tensor,
    gens: list,
    data: dict,
    f_bg: torch.Tensor,
    default_alphas: torch.Tensor,
    n_real: float,
    *,
    A: int,
    K: int,
    W: int,
    sample_z: bool,
    sample_q: bool,
    learn_alpha: bool,
    path: str,
    n_iters: int,
    burn_in: int = 0,
):
    """The whole CGS run of M chains: ``n_iters`` sweeps, no host sync.

    Returns (v, q, log_alphas, ll_history [n_iters, M], n_occ_history
    [n_iters, M], avg_counts), all on the device; avg_counts averages the
    per-order counts of sweeps i >= burn_in (used when burn_in > 0).
    """
    M = q.shape[0]
    acc = tuple(
        torch.zeros((M, A ** (k + 1), W), dtype=torch.float32, device=q.device)
        for k in range(K + 1)
    )
    lls, n_occs = [], []
    for i in range(n_iters):
        v, q, log_alphas, ll, n_occ, counts = gibbs_step_multi(
            v, q, log_alphas, gens, data, f_bg, default_alphas, n_real,
            A=A, K=K, W=W, sample_z=sample_z, sample_q=sample_q,
            learn_alpha=learn_alpha, path=path,
        )
        if i >= burn_in:
            acc = tuple(a + c for a, c in zip(acc, counts))
        lls.append(ll)
        n_occs.append(n_occ)
    n_avg = max(n_iters - burn_in, 1)
    acc = tuple(a / n_avg for a in acc)
    empty = torch.zeros((0, M), dtype=torch.float32, device=q.device)
    return (v, q, log_alphas, torch.stack(lls) if lls else empty,
            torch.stack(n_occs) if n_occs else empty, acc)


def gibbs_chains(v, q, alphas, f_bg, data, n_real, gens, params: Params, *,
                 A: int, K: int, W: int, path: str):
    """CGS for M stacked chains as the flags say: log alpha starts at
    log(alphas), the InvGamma prior is centred on ``alphas``, and with
    --cgsBurnIn the model is the Rao-Blackwell mean over the kept sweeps.
    Returns (v, q, log_alphas, ll_history [n_iters, M]) on the device."""
    n_iters = params.maxCGSIterations
    burn_in = min(params.cgsBurnIn, max(n_iters - 1, 0))
    v, q, la, lls, _n_occs, acc = gibbs_optimize(
        v, q, torch.log(alphas), gens, data, f_bg, alphas, n_real,
        A=A, K=K, W=W,
        sample_z=not params.noZSampling, sample_q=not params.noQSampling,
        learn_alpha=not params.noAlphaOptimization,
        path=path, n_iters=n_iters, burn_in=burn_in,
    )
    if burn_in > 0:
        v = update_v(acc, torch.exp(la), f_bg)
    return v, q, la, lls


def _run_group(group: list, indices: list, data: dict, n_real: int, params: Params,
               solo: bool) -> list:
    """Refine the motifs of one (W, K, f_bg) group in place; returns their
    GibbsResults.  ``indices``: the motifs' global input indices, which
    seed their chains."""
    A, K, W = group[0].A, group[0].K, group[0].W
    M = len(group)
    dev = data["cidx"].device

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    v = tuple(f32(np.stack([m.v[k] for m in group])) for k in range(K + 1))
    q = torch.full((M,), params.q, dtype=torch.float32, device=dev)
    alphas = f32(np.stack([m.alphas for m in group]))
    f_bg = f32(group[0].f_bg)
    path = choose_path(params, dev)
    compile_seconds = build_seconds(path)
    gens = chain_generators(params.seed, indices, dev)

    t0 = time.perf_counter()
    v, q, la, lls = gibbs_chains(v, q, alphas, f_bg, data, float(n_real), gens, params,
                                 A=A, K=K, W=W, path=path)
    synchronize(dev)
    seconds = time.perf_counter() - t0

    lls_h = lls.cpu().numpy()  # [n_iters, M]
    q_h = q.cpu().numpy()
    alphas_h = torch.exp(la).cpu().numpy()
    results = []
    for gi, m in enumerate(group):
        m.v = [v[k][gi].cpu().numpy().astype(np.float64) for k in range(K + 1)]
        m.alphas = alphas_h[gi].astype(np.float64)
        hist = [float(x) for x in lls_h[:, gi]]
        results.append(GibbsResult(
            iterations=len(hist),
            ll=hist[-1] if hist else float("nan"),
            q=float(q_h[gi]),
            # every chain sweeps the same n_iters, so each is charged an
            # equal share of the group's wall clock
            seconds=seconds / M,
            ll_history=hist,
            alphas=alphas_h[gi],
            compile_seconds=compile_seconds,
            group_seconds=0.0 if solo else seconds,
        ))
    return results


def run_gibbs(
    motif: Motif,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    data: dict | None = None,
    n_real: int | None = None,
    device="cpu",
    index: int = 0,
) -> GibbsResult:
    """Refine ``motif`` in place by CGS (``GibbsSampling::optimize``).

    ``n_real``: number of real sequences when ``data`` rows are masked out
    with length 0 (CV fold masking).  ``index``: the motif's global input
    index, which seeds its chain (``chain_seed(params.seed, index)``), so
    ``run_gibbs(motifs[i], ..., index=i)`` reproduces member i of
    ``run_gibbs_multi``.
    """
    params = params or Params(CGS=True)
    if data is None:
        data = prepare_data(sset, bg, motif.K, params.ss, device)
    if n_real is None:
        n_real = int(data["lens"].shape[0])
    return _run_group([motif], [index], data, n_real, params, solo=True)[0]


def run_gibbs_multi(
    motifs: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    device="cpu",
) -> list:
    """Batched CGS over a MotifSet; refines every motif in place.

    Seeds of equal (W, K, f_bg) sweep together, one score and one count
    launch per sweep for the whole group.  The motif at input position i
    samples from ``chain_seed(params.seed, i)``: global, not group-local,
    indices, so the m-th members of two groups are independent chains.
    Returns a list of GibbsResult aligned with ``motifs``.
    """
    params = params or Params(CGS=True)
    results: list = [None] * len(motifs)
    groups: dict = {}
    for i, m in enumerate(motifs):
        # f_bg joins the key: the stacked update shares one f_bg
        groups.setdefault(
            (m.W, m.K, np.asarray(m.f_bg, np.float64).tobytes()), []
        ).append(i)
    for (_W, K, _fbg), idxs in groups.items():
        data = prepare_data(sset, bg, K, params.ss, device)
        group = [motifs[i] for i in idxs]
        res = _run_group(group, idxs, data, int(data["lens"].shape[0]), params,
                         solo=len(idxs) == 1)
        for i, r in zip(idxs, res):
            results[i] = r
    return results
