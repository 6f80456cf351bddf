"""ZOOPS EM refinement — the hot loop.

Port of ``bammmotif2_tpu.refinement.em`` (``EM::optimize``, ``EStep``,
``MStep``, ``optimizeQ``).  One EM iteration:

    E: rebuild the [R+1, W] log-odds LUT, score every window, log-space
       ZOOPS posterior
    M: fractional combined count rows, marginalize to per-order counts,
       apply the interpolated pseudo-count estimator, optionally update q

Two data paths produce the same counts and likelihood:
  * ``"cuda"``: the fused CUDA kernel (``ops.cuda_em.em_counts_multi``);
  * ``"plain"``: the PyTorch escore ops, on the CPU or on the card
    (``--no-pallas``).

The convergence loop is ``refinement.multi.batched_while_loop`` with one
seed: on the card one launch of a CUDA graph whose WHILE node repeats the
captured iteration until the stop test fails, with no host read until the
results are read (``--verbose`` prints, so reads, every iteration; with a
mesh the host reads the stop flag once per ``multi.SYNC_EVERY``
iterations).

With a mesh (``parallel.mesh``) the rows shard over the data axis: each
rank runs the data pass on its block, and one all-reduce an iteration sums
the float64 counts and the likelihoods over the data group, which are
rounded to float32 once, as a single process rounds its sums.  Every rank
then holds the same sums and takes the same stop decision.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.models import motif as motif_mod
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import Motif
from bammmotif2_tpu_torch.ops import cuda_em, encode
from bammmotif2_tpu_torch.parallel import distributed
from bammmotif2_tpu_torch.parallel import mesh as mesh_mod
from bammmotif2_tpu_torch.refinement import graphs as graphs_mod
from bammmotif2_tpu_torch.utils.device import resolve
from bammmotif2_tpu_torch.utils.metrics import span


@dataclasses.dataclass
class EMResult:
    iterations: int
    ll: float
    q: float
    v_diff: float
    converged: bool
    ll_history: list
    seconds: float       # execution time of the EM loop (kernel build
                         # excluded); in batched group runs: this seed's
                         # iteration share of the group wall-clock
    windows_scored: int  # total windows scored across all iterations
    group_seconds: float = 0.0    # raw wall-clock of the batched group
                                  # this seed ran in (its em.loop span;
                                  # 0 = solo run)

    @property
    def windows_per_sec(self) -> float:
        return self.windows_scored / self.seconds if self.seconds > 0 else 0.0


def prepare_data(sset: SequenceSet, bg: BackgroundModel, K: int, ss: bool, device) -> dict:
    """One-time tensorization for EM: {cidx [S, N, L], lens [N], bg_flat [R]}.

    (cidx, lens) are the set's memoised ``encode.strand_indices``, which
    the background fit may have built already.  Callers never mutate the
    returned tensors.
    """
    device = torch.device(device)
    cidx, lens = encode.strand_indices(sset, K, ss, device)
    return {
        "cidx": cidx,
        "lens": lens,
        "bg_flat": torch.as_tensor(bg.conditional_flat(K), dtype=torch.float32, device=device),
    }


def counts_fn(path: str):
    """The E+M data pass of a path: the kernel or its plain version."""
    return cuda_em.em_counts_multi if path == "cuda" else cuda_em.em_counts_multi_ref


def data_pass(path: str, s_flat, data: dict, q, mesh=None) -> tuple:
    """(C f32 [M, R+1, W], ll f32 [M]) of the E+M data pass for M seeds.

    With a mesh: this rank's rows, then one all-reduce over the data group
    of the float64 counts and the likelihoods, rounded to float32 once.
    """
    if mesh is None:
        return counts_fn(path)(s_flat, data["cidx"], data["lens"], q)
    Cd, ll = counts_fn(path)(s_flat, data["cidx"], data["lens"], q, unrounded=True)
    M = q.shape[0]
    buf = mesh_mod.all_reduce(torch.cat([Cd.reshape(-1), ll.to(torch.float64)]),
                              mesh.data_group)
    return buf[:-M].reshape(Cd.shape).to(torch.float32), buf[-M:].to(torch.float32)


def em_step(
    v: tuple,
    q: torch.Tensor,
    data: dict,
    alphas: torch.Tensor,
    f_bg: torch.Tensor,
    n_real: float | None = None,
    *,
    A: int,
    K: int,
    W: int,
    optimize_q: bool,
    path: str = "plain",
    mesh=None,
):
    """One EM iteration. Returns (v_new, q_new, ll, v_diff), all tensors.

    ``n_real``: number of real sequences when some rows of ``data`` are
    masked with length 0; each such row contributes exactly log(1-q) to the
    likelihood and 1 to the q denominator, both corrected here.  With a
    ``mesh``, ``data`` is this rank's block (``parallel.mesh.shard_em_data``)
    and the counts and ll are the whole set's.
    """
    R = encode.num_rows(A, K)
    n_rows = data.get("n_padded", data["lens"].shape[0])
    s_flat = motif_mod.log_odds_lut(v, data["bg_flat"])
    C, ll = data_pass(path, s_flat[None], data, q.reshape(1), mesh)
    C, ll = C[0], ll[0]
    counts = motif_mod.counts_from_combined(C[:R], A, K)
    v_new = motif_mod.update_v(counts, alphas, f_bg)
    if optimize_q:
        # every window deposits one count at motif position 0 (possibly in
        # the sentinel row), so column 0 of the full count tensor is the
        # total occurrence responsibility (EM::optimizeQ)
        denom = n_rows if n_real is None else n_real
        q_new = torch.clamp(C.sum(dim=0)[0] / denom, 1e-4, 1.0 - 1e-4)
    else:
        q_new = q
    if n_real is not None:
        ll = ll - (n_rows - n_real) * torch.log1p(-q)
    # parameter-change convergence statistic: L1 change over all orders
    v_diff = sum((vn - vo).abs().sum() for vn, vo in zip(v_new, v))
    return v_new, q_new, ll, v_diff


def em_optimize(
    v: tuple,
    q: torch.Tensor,
    data: dict,
    alphas: torch.Tensor,
    f_bg: torch.Tensor,
    n_real: float,
    epsilon: torch.Tensor,
    ll0: torch.Tensor,
    *,
    A: int,
    K: int,
    W: int,
    optimize_q: bool,
    path: str,
    max_iters: int,
    mesh=None,
    graphs: bool = True,
):
    """The EM convergence loop: stop when v_diff < eps or |dll| < eps
    (EM::optimize), capped at ``max_iters``.  The comparison is in float32
    on the device, as in the JAX loop.  ``refinement.multi.
    batched_while_loop`` runs ``multi.group_step``'s iteration, which is
    ``em_step``'s, with one seed: on the card one launch of its loop graph,
    which tests the stop on the device (with a mesh, or ``graphs`` False,
    the host reads the stop flag once per ``multi.SYNC_EVERY``
    iterations).

    ``ll0``: the likelihood the first iteration's dll compares against
    (-inf for a fresh run; the previous chunk's ll under --checkpointEvery).

    Returns (v, q, ll, v_diff, iterations).
    """
    from bammmotif2_tpu_torch.refinement.multi import batched_while_loop, group_step

    step, inputs, key = group_step(data, alphas[None], f_bg, n_real, A=A, K=K, W=W,
                                   optimize_q=optimize_q, path=path, mesh=mesh)
    v, q, lls, vds, its, _hist = batched_while_loop(
        step, tuple(vk[None] for vk in v), q.reshape(1), epsilon, max_iters,
        inputs=inputs, key=key, ll0=ll0.reshape(1), mesh=mesh, graphs=graphs,
    )
    its = int(its[0])
    graphs_mod.settle()
    return tuple(vk[0] for vk in v), q[0], lls[0], vds[0], its


def choose_path(params: Params, device) -> str:
    """``"cuda"`` for data on a CUDA device unless --no-pallas; else
    ``"plain"``."""
    if params.use_pallas and torch.device(device).type == "cuda":
        return "cuda"
    return "plain"


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_kernels(path: str) -> None:
    """Build/load the path's kernel now, so EM timings exclude it."""
    if path == "cuda":
        cuda_em.library()


def run_em(
    motif: Motif,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    data: dict | None = None,
    verbose: bool | None = None,
    checkpoint_fn=None,
    n_real: int | None = None,
    device=None,
    mesh=None,
    graphs: bool = True,
) -> EMResult:
    """Refine ``motif`` in place with ZOOPS EM (``EM::optimize``).

    ``device``: where it runs (None: the current CUDA device; pass "cpu"
    for the CPU).  ``n_real``: number of real sequences in ``data`` when
    some rows are masked out with length 0; defaults to the row count.

    With ``mesh`` (``parallel.mesh.Mesh``): the rows shard over its data
    axis and every iteration sums the counts over the data group; every
    rank ends with the same model.  Only rank 0 prints under ``verbose``.

    ``graphs``: False runs the loop eagerly on a CUDA device too
    (``em_optimize``).

    ``checkpoint_fn(motif=, iteration=)``: when set together with
    ``params.checkpointEvery > 0``, the loop runs in chunks of that many
    iterations and the callback fires after each chunk with the refreshed
    motif (the written model file is a valid ``--BaMMFile`` resume point).
    """
    params = params or Params(EM=True)
    verbose = params.verbose if verbose is None else verbose
    A, K, W = motif.A, motif.K, motif.W
    device = resolve(device)
    with span("em.group", W=W, K=K, M=1) as group_span:
        if data is None:
            data = prepare_data(sset, bg, K, params.ss, device)
        device = data["cidx"].device

        n_real = int(data["lens"].shape[0]) if n_real is None else int(n_real)
        lens_np = data["lens"].cpu().numpy()
        n_win = int(data["cidx"].shape[0]) * int(np.maximum(lens_np - W + 1, 0).sum())
        if mesh is not None:
            data = mesh_mod.shard_em_data(mesh, data, encode.num_rows(A, K))

        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

        v = tuple(f32(vk) for vk in motif.v)
        q = f32(params.q)
        alphas = f32(motif.alphas)
        f_bg = f32(motif.f_bg)
        eps = f32(params.epsilon)
        path = choose_path(params, device)
        load_kernels(path)
        statics = dict(A=A, K=K, W=W, optimize_q=params.optimizeQ, path=path, mesh=mesh)
        ll_hist: list = []
        seconds = 0.0

        def _sync_motif():
            motif.v = [vk.cpu().numpy().astype(np.float64) for vk in v]

        ckpt_every = params.checkpointEvery if checkpoint_fn else 0
        if not verbose and ckpt_every > 0:
            # chunks of checkpointEvery iterations; the previous chunk's final
            # ll carries into the next (ll0) so the |dll| stop criterion spans
            # chunk boundaries exactly as in a one-shot run
            it, ll, v_diff = 0, float("-inf"), float("inf")
            converged = False
            ll_carry = f32(float("-inf"))
            while it < params.maxEMIterations and not converged:
                chunk = min(ckpt_every, params.maxEMIterations - it)
                with span("em.loop") as loop_span:
                    v, q, ll_dev, vd_dev, it_chunk = em_optimize(
                        v, q, data, alphas, f_bg, n_real, eps, ll_carry,
                        max_iters=chunk, graphs=graphs, **statics,
                    )
                    synchronize(device)
                seconds += loop_span.seconds
                it += it_chunk
                ll, v_diff = float(ll_dev), float(vd_dev)
                ll_carry = ll_dev
                ll_hist.append(ll)
                converged = v_diff < params.epsilon or it_chunk < chunk
                _sync_motif()
                checkpoint_fn(motif=motif, iteration=it)
        elif not verbose:
            with span("em.loop") as loop_span:
                v, q, ll_dev, vd_dev, it = em_optimize(
                    v, q, data, alphas, f_bg, n_real, eps, f32(float("-inf")),
                    max_iters=params.maxEMIterations, graphs=graphs, **statics,
                )
                synchronize(device)
            seconds = loop_span.seconds
            ll, v_diff = float(ll_dev), float(vd_dev)
            ll_hist.append(ll)
            converged = v_diff < params.epsilon
        else:
            # the host reads every iteration: the loop's seconds hold the
            # prints (and checkpoints) too
            it, ll, v_diff = 0, float("-inf"), float("inf")
            converged = False
            with span("em.loop") as loop_span:
                for it in range(1, params.maxEMIterations + 1):
                    ll_prev = ll
                    v, q, ll_dev, vd_dev = em_step(v, q, data, alphas, f_bg, n_real, **statics)
                    ll, v_diff = float(ll_dev), float(vd_dev)
                    ll_hist.append(ll)
                    if distributed.is_main():
                        print(f"  EM iter {it:4d}  ll={ll:.4f}  dv={v_diff:.3e}  "
                              f"q={float(q):.4f}")
                    if ckpt_every > 0 and it % ckpt_every == 0:
                        _sync_motif()
                        checkpoint_fn(motif=motif, iteration=it)
                    if v_diff < params.epsilon or abs(ll - ll_prev) < params.epsilon:
                        converged = True
                        break
            seconds = loop_span.seconds

        _sync_motif()
        group_span.attrs.update(iterations=[it], windows=n_win)
    return EMResult(
        iterations=it,
        ll=ll,
        q=float(q),
        v_diff=v_diff,
        converged=converged,
        ll_history=ll_hist,
        seconds=seconds,
        windows_scored=n_win * it,
    )
