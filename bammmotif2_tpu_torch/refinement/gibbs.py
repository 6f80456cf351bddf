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
  3. z_n ~ the row's categorical (argmax under --noZSampling);
  4. the 0/1 occupancy r [M, S, N, L], scattered into a zeroed buffer;
  5. counts from r for all M chains in one launch (``ops.cuda_counts``),
     split into per-order counts;
  6. q ~ Beta(n_occ + 1, n_real - n_occ + 1), clipped to [1e-4, 1 - 1e-4]
     (kept under --noQSampling);
  7. one gradient-ascent step on the collapsed log posterior of log alpha
     (``torch.autograd``), clipped (--noAlphaOptimization skips it);
  8. v from the counts and the new alphas (``models.motif.update_v``);
  9. the ZOOPS ll with the sweep's old q, for monitoring.

Randomness: the reference's own ``jax.random`` streams (``ops/threefry.py``).
A chain carries a key [2] on the device, as the reference's scan carries
it: ``run_gibbs`` starts from ``PRNGKey(params.seed)`` unless given one,
and ``run_gibbs_multi`` keys the motif at global input index i by
``fold_in(PRNGKey(params.seed), i)`` (``input_keys``).  A sweep that
samples z, q or both splits the key twice: (key, sub) = split(key) for z,
row n drawn by ``categorical`` from ``fold_in(sub, n)`` (``ops.cuda_draws.
cgs_z``, one launch for all chains), then (key, sub_q) = split(key) for q
~ ``beta(sub_q, ...)`` (``cuda_draws.cgs_beta``, one launch, which also
writes the advanced keys in place).  So the port's chains are the
reference's, draw for draw, wherever the two compute the same logits; a
stacked chain reproduces its solo run, a row's draw depends on its global
index and not on the shard layout, and the kernel and plain paths draw the
same numbers.

The sweep loop makes no host sync: CGS has a fixed number of sweeps, and
the ll history stays on the device until the end.  On the card with no
mesh the whole run is one launch of a graph whose CUDA WHILE node repeats
the captured sweep until the sweep counter reaches n_iters
(``refinement.graphs``, ``gibbs_optimize``), the counterpart of the
reference's ``lax.scan``.

With a mesh (``parallel.mesh``) each rank scores and counts its block of
rows, and one all-reduce a sweep sums the counts, the occupied-row counts
and the ll over the data group (sums of 0/1 occupancies, exact in float32).
Each rank draws z for its own block's global rows, so z does not depend on
the layout; every rank then draws q and takes the alpha step from the same
sums and the same keys.  The seed axis does not split
the chains: the ranks of other seed indices run the same chains on their
own data blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import (
    Motif, counts_from_combined, log_odds_lut, tile_rows, update_v,
)
from bammmotif2_tpu_torch.ops import (
    cuda_counts, cuda_draws, cuda_scores, cuda_while, encode, threefry,
)
from bammmotif2_tpu_torch.ops.escore import NEG_INF
from bammmotif2_tpu_torch.parallel import mesh as mesh_mod
from bammmotif2_tpu_torch.refinement import graphs as graphs_mod
from bammmotif2_tpu_torch.refinement.em import choose_path, prepare_data, synchronize
from bammmotif2_tpu_torch.refinement.multi import UNTIL
from bammmotif2_tpu_torch.scoring.scan import score_fn
from bammmotif2_tpu_torch.utils.device import resolve
from bammmotif2_tpu_torch.utils.metrics import span

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
    group_seconds: float = 0.0    # raw wall-clock of the batched group
                                  # this seed ran in (its cgs.loop span;
                                  # 0 = solo run)


def input_keys(seed: int, indices, device) -> torch.Tensor:
    """The keys [M, 2] int64 on ``device`` of the chains of the motifs at
    global input ``indices`` in a run seeded ``seed``: ``fold_in(
    PRNGKey(seed), i)``, as the reference's ``run_gibbs_multi`` keys them."""
    i = torch.as_tensor(list(indices), dtype=torch.int64).reshape(-1)
    return threefry.fold_in(threefry.prng_key(seed)[None], i).to(device)


def counts_fn(path: str):
    """The count op of a path: the kernel or its plain version."""
    return cuda_counts.counts_from_r_multi if path == "cuda" else cuda_counts.counts_from_r_multi_ref


def load_kernels(path: str, device) -> None:
    """Build/load the kernels a run on ``device`` takes now, so sweep
    timings exclude it: on a CUDA device the draws and the loop's stop
    test, and on the kernel path the score and count kernels."""
    if torch.device(device).type != "cuda":
        return
    cuda_draws.library()
    cuda_while.library()
    if path == "cuda":
        cuda_scores.library()
        cuda_counts.library()


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


def draw_z(flat: torch.Tensor, keys, sample: bool, row0: int = 0) -> torch.Tensor:
    """z [M, N] int64: 0 = no occurrence, else 1 + the flat window index.

    Sampled: each row's ``categorical`` draw of the key ``fold_in(sub,
    row0 + n)``, (key, sub) = split of the chains' carried ``keys``
    (``ops.cuda_draws.cgs_z``, which leaves the keys as they are).
    ``flat`` holds the rows row0.. of the set (a shard's block), each drawn
    from its global row index; rows with no window (shard padding) take 0
    whatever the draw.  Else the argmax (first on ties).
    """
    if not sample:
        return flat.argmax(dim=-1)
    return cuda_draws.cgs_z(flat, keys, row0)


def draw_beta(a: torch.Tensor, b: torch.Tensor, keys, sample: bool):
    """The sweep's q draw and key advance: with (key', sub_q) = split(
    split(key)[0]), q = Beta(a[m], b[m]) of sub_q per chain, clipped to
    [Q_MIN, Q_MAX], where ``sample``; every chain's key becomes key' in
    place either way (``ops.cuda_draws.cgs_beta``).  Returns q or None."""
    return cuda_draws.cgs_beta(a, b, keys, Q_MIN, Q_MAX, draw=sample)


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
    keys,
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
    mesh=None,
):
    """One batch-synchronous CGS sweep for M chains.

    v: tuple of [M, A^(k+1), W]; q [M]; log_alphas, default_alphas
    [M, K+1, W]; keys: the chains' carried keys [M, 2] int64 on the data's
    device, advanced in place by the sweep's two splits (unused, and may be
    None, when nothing is sampled); data: {cidx, lens, bg_flat}
    (``refinement.em.prepare_data``, or with ``mesh`` this rank's block
    from ``parallel.mesh.shard_em_data``); n_real: the number of real rows
    (zero-length mask rows excluded).

    Returns (v, q, log_alphas, ll [M], n_occ [M], counts tuple of
    [M, A^(k+1), W]).
    """
    cidx, lens = data["cidx"], data["lens"]
    R = encode.num_rows(A, K)
    L = cidx.shape[2]
    s_flat = log_odds_lut(v, data["bg_flat"]).contiguous()  # [M, R+1, W]
    scores, mask = score_fn(path)(s_flat, cidx, lens)
    _M, S, N, n_win = scores.shape

    sampled = sample_z or sample_q
    if sampled and keys is None:
        raise ValueError("a sampled sweep needs the chains' keys")
    flat = flat_logits(scores, mask, q)
    z = draw_z(flat, keys, sample_z, data.get("row0", 0))
    n_occ = (z > 0).sum(dim=1).to(torch.float32)
    C = counts_fn(path)(occupancy(z, S, L, n_win), cidx, R, W)
    ll = torch.logsumexp(flat, dim=-1).sum(dim=-1)
    if mesh is not None:
        M = q.shape[0]
        buf = mesh_mod.all_reduce(torch.cat([C.reshape(-1), n_occ, ll]), mesh.data_group)
        C, n_occ, ll = buf[: -2 * M].reshape(C.shape), buf[-2 * M : -M], buf[-M:]
    counts = counts_from_combined(C[:, :R], A, K)

    q_new = q
    if sampled:
        # zero-length mask rows can never be occupied and are not in n_real
        drawn = draw_beta(n_occ + 1.0, n_real - n_occ + 1.0, keys, sample_q)
        if sample_q:
            q_new = drawn
    if learn_alpha:
        log_alphas = alpha_step(log_alphas, counts, f_bg, default_alphas, alpha_lr)
    v_new = update_v(counts, torch.exp(log_alphas), f_bg)

    # the ZOOPS ll with this sweep's q; each zero-length row adds log(1-q)
    ll = ll - (data.get("n_padded", N) - n_real) * torch.log1p(-q)
    return v_new, q_new, log_alphas, ll, n_occ, counts


def gibbs_step(v, q, log_alphas, key, data, f_bg, default_alphas, n_real, **kw):
    """``gibbs_step_multi`` for one chain: v tuple of [A^(k+1), W], q [],
    log_alphas and default_alphas [K+1, W], the chain's key [2] (or None;
    advanced in place).
    Returns (v, q, log_alphas, ll, n_occ, counts) without the seed axis."""
    out = gibbs_step_multi(
        tuple(vk[None] for vk in v), q.reshape(1), log_alphas[None],
        None if key is None else key.reshape(1, 2), data, f_bg, default_alphas[None], n_real,
        **kw,
    )
    v, q, la, ll, n_occ, counts = out
    return tuple(vk[0] for vk in v), q[0], la[0], ll[0], n_occ[0], tuple(c[0] for c in counts)


def gibbs_optimize(
    v: tuple,
    q: torch.Tensor,
    log_alphas: torch.Tensor,
    keys,
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
    mesh=None,
    graphs: bool = True,
):
    """The whole CGS run of M chains: ``n_iters`` sweeps, no host sync.

    ``keys``: the chains' keys [M, 2] (None when nothing is sampled),
    carried in the loop's state and advanced by each sweep on the device.
    The sweep is one in-place body (``refinement.graphs.Loop``), the
    reference's ``lax.scan`` body: a sweep counter ``i`` on the device
    indexes the ll and occupied-row histories, and the burn-in mean adds
    ``counts * (i >= burn_in)``.  The
    loop's stop test (``multi.UNTIL``) is the scan's length: ``its``
    counts sweeps against the cap n_iters, and ``vds`` stays +inf, so no
    ll (a NaN one included) stops it.  On a CUDA device with no mesh the
    run is one launch of a WHILE-node graph after the first sweep
    (``graphs.device_loop``; ``graphs.settle`` counts its launches where
    the caller reads the results); on an NCCL mesh the captured sweep is
    replayed n_iters - 1 times; eagerly where ``graphs`` is False or the
    mesh's data group runs gloo (``graphs.enabled``).  A captured loop's
    key holds n_iters through the histories' shapes.

    Returns (v, q, log_alphas, ll_history [n_iters, M], n_occ_history
    [n_iters, M], avg_counts), all on the device; avg_counts averages the
    per-order counts of sweeps i >= burn_in (used when burn_in > 0).
    """
    M = q.shape[0]
    dev = q.device
    state = {
        "v": tuple(vk.clone() for vk in v),
        "q": q.clone(),
        "la": log_alphas.clone(),
        "acc": tuple(torch.zeros((M, A ** (k + 1), W), dtype=torch.float32, device=dev)
                     for k in range(K + 1)),
        "i": torch.zeros((1,), dtype=torch.int64, device=dev),
        "lls": torch.zeros((n_iters, M), dtype=torch.float32, device=dev),
        "n_occs": torch.zeros((n_iters, M), dtype=torch.float32, device=dev),
        # the stop test: n_iters sweeps
        "its": torch.zeros((M,), dtype=torch.int32, device=dev),
        "vds": torch.full((M,), float("inf"), dtype=torch.float32, device=dev),
        "cap": torch.full((), n_iters, dtype=torch.int32, device=dev),
        "eps": torch.zeros((), dtype=torch.float32, device=dev),
    }
    state["running"] = cuda_while.condition_ref(*(state[k] for k in UNTIL[1:]))
    if keys is not None:
        state["keys"] = keys.clone()
    tensors, consts = graphs_mod.split(data)
    inputs = {**tensors, "f_bg": f_bg, "default_alphas": default_alphas}
    statics = dict(A=A, K=K, W=W, sample_z=sample_z, sample_q=sample_q,
                   learn_alpha=learn_alpha, path=path)

    def body(s):
        v2, q2, la2, ll, n_occ, counts = gibbs_step_multi(
            s["v"], s["q"], s["la"], s.get("keys"), {**data, **inputs}, inputs["f_bg"],
            inputs["default_alphas"], n_real, mesh=mesh, **statics,
        )
        take = (s["i"] >= burn_in).to(torch.float32)
        for a, c in zip(s["acc"], counts):
            a.add_(take * c)
        s["lls"].index_copy_(0, s["i"], ll[None])
        s["n_occs"].index_copy_(0, s["i"], n_occ[None])
        for a, b in zip(s["v"], v2):
            a.copy_(b)
        s["q"].copy_(q2)
        s["la"].copy_(la2)
        s["i"].add_(1)
        s["its"].add_(1)

    key = ("gibbs_step_multi", float(n_real), burn_in, consts, tuple(sorted(statics.items())))
    loop = graphs_mod.Loop("CGS sweep loop", key, state, inputs, body, mesh=mesh, graphs=graphs,
                           until=UNTIL)
    if loop.on_device:
        if n_iters > 0:
            loop.run_while()
    else:
        loop.run(n_iters)
    s = loop.state
    n_avg = max(n_iters - burn_in, 1)
    return (tuple(vk.clone() for vk in s["v"]), s["q"].clone(), s["la"].clone(),
            s["lls"].clone(), s["n_occs"].clone(), tuple(a / n_avg for a in s["acc"]))


def gibbs_chains(v, q, alphas, f_bg, data, n_real, keys, params: Params, *,
                 A: int, K: int, W: int, path: str, mesh=None, graphs: bool = True):
    """CGS for M stacked chains as the flags say: log alpha starts at
    log(alphas), the InvGamma prior is centred on ``alphas``, and with
    --cgsBurnIn the model is the Rao-Blackwell mean over the kept sweeps.
    Returns (v, q, log_alphas, ll_history [n_iters, M]) on the device."""
    n_iters = params.maxCGSIterations
    burn_in = min(params.cgsBurnIn, max(n_iters - 1, 0))
    v, q, la, lls, _n_occs, acc = gibbs_optimize(
        v, q, torch.log(alphas), keys, data, f_bg, alphas, n_real,
        A=A, K=K, W=W,
        sample_z=not params.noZSampling, sample_q=not params.noQSampling,
        learn_alpha=not params.noAlphaOptimization,
        path=path, n_iters=n_iters, burn_in=burn_in, mesh=mesh, graphs=graphs,
    )
    if burn_in > 0:
        v = update_v(acc, torch.exp(la), f_bg)
    return v, q, la, lls


def _run_group(group: list, keys: torch.Tensor, data: dict, n_real: int, params: Params,
               solo: bool, mesh=None, graphs: bool = True) -> list:
    """Refine the motifs of one (W, K, f_bg) group in place; returns their
    GibbsResults.  ``keys``: their chains' keys [M, 2] int64.  With
    ``mesh``, ``data`` is the whole set and each rank sweeps its block of
    it."""
    A, K, W = group[0].A, group[0].K, group[0].W
    M = len(group)
    with span("cgs.group", W=W, K=K, M=M):
        if mesh is not None:
            data = mesh_mod.shard_em_data(mesh, data, encode.num_rows(A, K))
        dev = data["cidx"].device

        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

        v = tuple(f32(np.stack([m.v[k] for m in group])) for k in range(K + 1))
        q = torch.full((M,), params.q, dtype=torch.float32, device=dev)
        alphas = f32(np.stack([m.alphas for m in group]))
        f_bg = f32(group[0].f_bg)
        path = choose_path(params, dev)
        load_kernels(path, dev)
        keys = keys.to(dev)

        with span("cgs.loop") as loop_span:
            v, q, la, lls = gibbs_chains(v, q, alphas, f_bg, data, float(n_real), keys, params,
                                         A=A, K=K, W=W, path=path, mesh=mesh, graphs=graphs)
            synchronize(dev)
        seconds = loop_span.seconds
        graphs_mod.settle()

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
    device=None,
    key: torch.Tensor | None = None,
    graphs: bool = True,
) -> GibbsResult:
    """Refine ``motif`` in place by CGS (``GibbsSampling::optimize``).

    ``device``: None runs on the current CUDA device; pass "cpu" for the
    CPU (``data``, when given, keeps its own).  ``n_real``: number of real
    sequences when ``data`` rows are masked out with length 0 (CV fold
    masking).  ``key``: the chain's key [2] int64, by default
    ``PRNGKey(params.seed)`` as the reference's; ``run_gibbs(motifs[i],
    ..., key=input_keys(params.seed, [i], "cpu")[0])`` reproduces member i
    of ``run_gibbs_multi``.  ``graphs``: False runs the sweeps eagerly on a
    CUDA device too (``gibbs_optimize``).
    """
    params = params or Params(CGS=True)
    device = resolve(device)
    if data is None:
        data = prepare_data(sset, bg, motif.K, params.ss, device)
    if n_real is None:
        n_real = int(data["lens"].shape[0])
    key = threefry.prng_key(params.seed) if key is None else key
    return _run_group([motif], key.reshape(1, 2), data, n_real, params, solo=True,
                      graphs=graphs)[0]


def run_gibbs_multi(
    motifs: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    device=None,
    mesh=None,
    graphs: bool = True,
) -> list:
    """Batched CGS over a MotifSet; refines every motif in place.

    Seeds of equal (W, K, f_bg) sweep together, one score and one count
    launch per sweep for the whole group.  The motif at input position i
    samples from ``fold_in(PRNGKey(params.seed), i)`` (``input_keys``), as
    the reference's does: global, not group-local, indices, so the m-th
    members of two groups are independent chains.
    ``device``: None runs on the current CUDA device; pass "cpu" for the
    CPU.  ``mesh``: rows shard over its data axis, with the same draws as
    one process.  ``graphs``: False runs the sweeps eagerly on a CUDA
    device too.  Returns a list of GibbsResult aligned with ``motifs``.
    """
    params = params or Params(CGS=True)
    device = resolve(device)
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
        res = _run_group(group, input_keys(params.seed, idxs, device), data,
                         int(data["lens"].shape[0]), params, solo=len(idxs) == 1, mesh=mesh,
                         graphs=graphs)
        for i, r in zip(idxs, res):
            results[i] = r
    return results
