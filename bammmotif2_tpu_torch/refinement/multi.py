"""Multi-seed refinement: all seeds of a group step together.

Port of ``bammmotif2_tpu.refinement.multi``.  Seeds of equal (W, K, f_bg)
form a group; every EM iteration of a group runs ONE E+M data pass for all
its seeds (``ops.cuda_em.em_counts_multi`` stacks the M LUTs into one
kernel launch), and the model update runs batched over the seed axis.
The loop steps until every seed froze (v_diff or |dll| under epsilon) or
the iteration cap hits; a frozen seed keeps its state and iteration count,
and on the fused kernel path (``FusedStep``) costs no data pass: the
counters ``em.seed_passes`` and ``em.seed_passes_skipped`` count the
passes run and skipped (``count_seed_passes``).

``em_loop`` runs a group's loop, and is the only caller of ``group_step``
and ``batched_while_loop``: ``run_em_multi`` runs it once a group, FDR once
a fold, and ``run_em`` (one seed, the reference's ``EM::optimize``) is its
view at M=1, once or in --checkpointEvery chunks, or steps
``batched_step`` at M=1 eagerly under --verbose.

With a mesh (``parallel.mesh``) the rows shard over the data axis as in
``refinement.em``, and the seeds over the seed axis: the group pads to a
multiple of the seed axis by repeating its last member, each seed index
refines its slice, and after the loop every rank gathers the whole group.
"""

from __future__ import annotations

import numpy as np
import torch

from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.fasta import SequenceSet
from bammmotif2_tpu_torch.models import motif as motif_mod
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.models.motif import Motif
from bammmotif2_tpu_torch.ops import cuda_em, cuda_update, cuda_while, encode
from bammmotif2_tpu_torch.parallel import distributed
from bammmotif2_tpu_torch.parallel import mesh as mesh_mod
from bammmotif2_tpu_torch.refinement import graphs as graphs_mod
from bammmotif2_tpu_torch.refinement.em import (
    EMResult, choose_path, data_pass, load_kernels, prepare_data, synchronize,
)
from bammmotif2_tpu_torch.utils.device import resolve
from bammmotif2_tpu_torch.utils.metrics import count, span

# ll-trace slots kept per seed; longer runs record every stride-th iteration
HIST_CAP = 256
# EM iterations the host runs between two reads of the loop's stop flag
# where the loop does not run on the device (the eager loop, a mesh).  On
# an H100 at bench's geometry, graphed, 4 against 8: 1-1.5% fewer
# iterations/s at a fixed budget, 1-16% more on a run that converges in 20
# iterations, whose masked overshoot costs more than the reads save
# (PERF.md, PR 9)
SYNC_EVERY = 4
# the loop state's stop test (graphs.Loop's ``until``): running, its, vds, cap, eps
UNTIL = ("running", "its", "vds", "cap", "eps")


def run_em_multi(
    motifs: list,
    bg: BackgroundModel,
    sset: SequenceSet,
    params: Params | None = None,
    device=None,
    mesh=None,
    graphs: bool = True,
) -> list:
    """Batched EM over a MotifSet; refines every motif in place.

    ``device``: None runs on the current CUDA device; pass "cpu" for the
    CPU.  ``mesh``: shard rows over its data axis and seeds over its seed
    axis; every rank ends with every refined motif.  ``graphs``: False
    runs the loop eagerly on a CUDA device too (``em_loop``).
    Returns a list of EMResult aligned with ``motifs``.
    """
    params = params or Params(EM=True)
    device = resolve(device)
    results: list = [None] * len(motifs)

    groups: dict = {}
    for i, m in enumerate(motifs):
        # f_bg joins the key: the batched update shares one f_bg
        groups.setdefault(
            (m.W, m.K, np.asarray(m.f_bg, np.float64).tobytes()), []
        ).append(i)

    for (W, K, _fbg), idxs in groups.items():
        group = [motifs[i] for i in idxs]
        with span("em.group", W=W, K=K, M=len(group)) as group_span:
            _refine_group(group, idxs, results, sset, bg, params, device, mesh, graphs,
                          group_span)
    return results


def _stack(group: list, sset, bg, params: Params, device, mesh, data=None,
           n_real=None) -> tuple:
    """What a group's loop starts from: (v, q [M], alphas [M, ...], f_bg,
    eps, data, n_real, n_win, statics).  v holds the seeds' models stacked,
    a tensor an order; ``data`` (``prepare_data``'s unless given) is
    sharded over a mesh's data axis; ``n_real`` defaults to its rows;
    ``n_win`` counts the windows of one data pass over the whole set; the
    statics are the step's constants, with the path's kernel loaded."""
    A, K, W, M = group[0].A, group[0].K, group[0].W, len(group)
    if data is None:
        data = prepare_data(sset, bg, K, params.ss, device)
    dev = data["cidx"].device
    n_real = int(data["lens"].shape[0]) if n_real is None else int(n_real)
    n_win = int(data["cidx"].shape[0]) * int(
        np.maximum(data["lens"].cpu().numpy() - W + 1, 0).sum()
    )
    if mesh is not None:
        data = mesh_mod.shard_em_data(mesh, data, encode.num_rows(A, K))

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    v = tuple(f32(np.stack([m.v[k] for m in group])) for k in range(K + 1))
    q = torch.full((M,), params.q, dtype=torch.float32, device=dev)
    alphas = f32(np.stack([m.alphas for m in group]))
    path = choose_path(params, dev)
    load_kernels(path)
    statics = dict(A=A, K=K, W=W, optimize_q=params.optimizeQ, path=path, mesh=mesh)
    return v, q, alphas, f32(group[0].f_bg), f32(params.epsilon), data, n_real, n_win, statics


def _refine_group(group: list, idxs: list, results: list, sset, bg, params, device, mesh,
                  graphs, group_span) -> None:
    """One (W, K, f_bg) group of ``run_em_multi``: refines ``group`` (the
    motifs at ``idxs``) in place and sets their ``results``; the seeds'
    iterations, the windows of one data pass and ``plan_attrs`` join
    ``group_span``'s attrs."""
    K, M = group[0].K, len(group)
    with span("em.prepare"):
        v, q, alphas, f_bg, eps, data, n_real, n_win, statics = _stack(
            group, sset, bg, params, device, mesh)
        dev = q.device
        if mesh is not None:
            # pad to a multiple of the seed axis with copies of the last
            # member (they step as it does; sliced off below); keep this
            # seed index's slice
            per = -(-M // mesh.n_seed)
            keep = torch.arange(mesh.seed_index * per, (mesh.seed_index + 1) * per, device=dev)
            keep = keep.clamp(max=M - 1)
            v = tuple(vk[keep] for vk in v)
            q, alphas = q[keep], alphas[keep]
    with span("em.loop") as loop_span:
        v, q, lls, vds, its, hist = em_loop(v, q, data, alphas, f_bg, n_real, eps,
                                            params.maxEMIterations, graphs=graphs, **statics)
        if mesh is not None:
            *v, q, lls, vds, its, hist = mesh_mod.all_gather_seeds(
                mesh, *v, q, lls, vds, its, hist.T)
            hist = hist.T
        synchronize(dev)
    seconds = loop_span.seconds

    with span("em.fetch"):
        graphs_mod.settle()
        # The group is one loop, so only its wall-clock is observable: each
        # seed is charged its iteration share, and its windows_per_sec then
        # equals the group's aggregate throughput (do not sum over seeds).
        # ll_history holds one entry per trace_stride iterations.
        stride = trace_stride(params.maxEMIterations)
        its = its.cpu().numpy()
        lls, vds, q = lls.cpu().numpy(), vds.cpu().numpy(), q.cpu().numpy()
        hist = hist.cpu().numpy()
        total_its = max(int(its[:M].sum()), 1)
        for gi, i in enumerate(idxs):
            group[gi].v = [v[k][gi].cpu().numpy().astype(np.float64) for k in range(K + 1)]
            n_rec = -(-int(its[gi]) // stride)
            results[i] = EMResult(
                iterations=int(its[gi]),
                ll=float(lls[gi]),
                q=float(q[gi]),
                v_diff=float(vds[gi]),
                converged=float(vds[gi]) < params.epsilon,
                ll_history=[float(x) for x in hist[:n_rec, gi]],
                seconds=seconds * int(its[gi]) / total_its,
                windows_scored=n_win * int(its[gi]),
                group_seconds=seconds,
            )
    group_span.attrs.update(iterations=[int(x) for x in its[:M]], windows=n_win,
                            **plan_attrs(statics["A"], K, statics["W"], M, data["cidx"].shape))
    count_seed_passes(its[:M], fuses(data, statics["path"], mesh))


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
    """Refine ``motif`` in place with ZOOPS EM (``EM::optimize``): the
    group loop (``em_loop``) at M=1.

    ``device``: where it runs (None: the current CUDA device; pass "cpu"
    for the CPU).  ``n_real``: number of real sequences in ``data`` when
    some rows are masked out with length 0; defaults to the row count.

    With ``mesh`` (``parallel.mesh.Mesh``): the rows shard over its data
    axis and every iteration sums the counts over the data group; every
    rank ends with the same model.  Only rank 0 prints under ``verbose``.

    ``graphs``: False runs the loop eagerly on a CUDA device too.

    ``checkpoint_fn(motif=, iteration=)``: when set together with
    ``params.checkpointEvery > 0``, the loop runs in chunks of that many
    iterations and the callback fires after each chunk with the refreshed
    motif (the written model file is a valid ``--BaMMFile`` resume point).
    ``verbose`` steps ``batched_step`` one iteration at a time on the host
    instead, printing each iteration's ll, raw v_diff and q, and stops
    where v_diff or |dll| falls under epsilon; the checkpoints fire every
    checkpointEvery iterations.
    """
    params = params or Params(EM=True)
    verbose = params.verbose if verbose is None else verbose
    device = resolve(device)
    with span("em.group", W=motif.W, K=motif.K, M=1) as group_span:
        v, q, alphas, f_bg, eps, data, n_real, n_win, statics = _stack(
            [motif], sset, bg, params, device, mesh, data, n_real)
        args = (data, alphas, f_bg, n_real)
        ll_hist: list = []
        seconds = 0.0
        it, ll, v_diff, converged = 0, float("-inf"), float("inf"), False

        def checkpoint():
            motif.v = [vk[0].cpu().numpy().astype(np.float64) for vk in v]
            checkpoint_fn(motif=motif, iteration=it)

        def loop(cap, ll0=None):
            """One em_loop of at most ``cap`` iterations from (v, q):
            (lls [1], v_diff, iterations)."""
            nonlocal v, q, seconds
            with span("em.loop") as loop_span:
                v, q, lls, vds, its, _hist = em_loop(v, q, *args, eps, cap, ll0, graphs=graphs,
                                                     **statics)
                its = int(its[0])
                graphs_mod.settle()
                synchronize(q.device)
            seconds += loop_span.seconds
            ll_hist.append(float(lls[0]))
            return lls, float(vds[0]), its

        ckpt_every = params.checkpointEvery if checkpoint_fn else 0
        if verbose:
            # the host reads every iteration: the loop's seconds hold the
            # prints (and checkpoints) too
            with span("em.loop") as loop_span:
                for it in range(1, params.maxEMIterations + 1):
                    ll_prev = ll
                    v, q, ll_dev, vd_dev = batched_step(v, q, *args, **statics)
                    ll, v_diff = float(ll_dev[0]), float(vd_dev[0])
                    ll_hist.append(ll)
                    if distributed.is_main():
                        print(f"  EM iter {it:4d}  ll={ll:.4f}  dv={v_diff:.3e}  "
                              f"q={float(q[0]):.4f}")
                    if ckpt_every > 0 and it % ckpt_every == 0:
                        checkpoint()
                    if v_diff < params.epsilon or abs(ll - ll_prev) < params.epsilon:
                        converged = True
                        break
            seconds = loop_span.seconds
        elif ckpt_every > 0:
            # chunks of checkpointEvery iterations; the previous chunk's final
            # ll carries into the next (ll0) so the |dll| stop criterion spans
            # chunk boundaries exactly as in a one-shot run
            lls = None
            while it < params.maxEMIterations and not converged:
                chunk = min(ckpt_every, params.maxEMIterations - it)
                lls, v_diff, it_chunk = loop(chunk, lls)
                it += it_chunk
                ll = ll_hist[-1]
                converged = v_diff < params.epsilon or it_chunk < chunk
                checkpoint()
        else:
            _lls, v_diff, it = loop(params.maxEMIterations)
            ll = ll_hist[-1]
            converged = v_diff < params.epsilon

        motif.v = [vk[0].cpu().numpy().astype(np.float64) for vk in v]
        group_span.attrs.update(iterations=[it], windows=n_win,
                                **plan_attrs(motif.A, motif.K, motif.W, 1, data["cidx"].shape))
        count_seed_passes([it], False)  # one seed: no pass to skip
    return EMResult(
        iterations=it,
        ll=ll,
        q=float(q[0]),
        v_diff=v_diff,
        converged=converged,
        ll_history=ll_hist,
        seconds=seconds,
        windows_scored=n_win * it,
    )


def trace_stride(max_iters: int) -> int:
    """Iterations a slot of ``em_loop``'s ll trace: 1 up to HIST_CAP
    iterations, else as many as keep the trace within HIST_CAP slots."""
    return max(1, -(-max_iters // HIST_CAP))


def em_loop(v0, q0, data, alphas, f_bg, n_real, epsilon, max_iters: int, ll0=None, *,
            graphs: bool = True, **statics) -> tuple:
    """A group's EM convergence loop: ``batched_while_loop`` of
    ``group_step``'s step from the stacked (v0, q0), at most ``max_iters``
    iterations, with an ll trace of one slot per ``trace_stride``
    iterations.  ``ll0`` [M]: the likelihoods the first dll compares
    against (default -inf; a --checkpointEvery chunk carries the previous
    one's).  The caller calls ``graphs.settle`` where it reads the results.

    Returns (v, q, lls, vds, its, hist), as ``batched_while_loop``.
    """
    stride = trace_stride(max_iters)
    step, inputs, key = group_step(data, alphas, f_bg, n_real, **statics)
    return batched_while_loop(step, v0, q0, epsilon, max_iters, -(-max_iters // stride), stride,
                              inputs=inputs, key=key, ll0=ll0, mesh=statics.get("mesh"),
                              graphs=graphs)


def group_step(data, alphas, f_bg, n_real, **statics) -> tuple:
    """(step, inputs, key) of ``batched_step`` on ``data`` for
    ``batched_while_loop``: step(v, q) reads the tensors of ``data``,
    ``alphas`` and ``f_bg`` through ``inputs``, and ``key`` holds the rest
    (``n_real``, the data's row bounds, ``statics``).  Where the data pass
    is the kernel's on a CUDA device with no mesh, ``step.fused`` is the
    same iteration as two kernels (``FusedStep``), which the loop runs
    instead; elsewhere it is None."""
    tensors, consts = graphs_mod.split(data)
    inputs = {**tensors, "alphas": alphas, "f_bg": f_bg}

    def step(v, q):
        return batched_step(v, q, {**data, **inputs}, inputs["alphas"], inputs["f_bg"], n_real,
                            **statics)

    step.fused = None
    if fuses(data, statics["path"], statics.get("mesh")):
        step.fused = FusedStep(inputs, n_real, A=statics["A"], K=statics["K"],
                               optimize_q=statics["optimize_q"])
    key = ("batched_step", float(n_real), consts,
           tuple(sorted((k, x) for k, x in statics.items() if k != "mesh")))
    return step, inputs, key


def fuses(data, path: str, mesh=None) -> bool:
    """Whether a group loop on ``data`` runs ``FusedStep``: the data pass is
    the kernel's, on a CUDA device, with no mesh."""
    return path == "cuda" and mesh is None and data["cidx"].device.type == "cuda"


def plan_attrs(A: int, K: int, W: int, M: int, cidx_shape) -> dict:
    """What the kernels of a fused group loop take at a group's shapes
    (codes [S, N, L]), as its ``em.group`` span's attributes: ``R1``, the
    combined rows with the sentinel; ``update_table``, where
    ``cuda_update.em_update`` keeps a seed's count table ("smem" or
    "device"); and B1's ``cuda_em.launch_plan``: ``seeds_per_block``,
    ``smem_lut`` and ``counts`` ("fixed", "float" or "global")."""
    S, _N, L = cidx_shape
    R1 = encode.num_rows(A, K) + 1
    plan = cuda_em.launch_plan(M, R1, W, S, L)
    return {"R1": R1, "update_table": "smem" if cuda_update.table_in_smem(R1, W) else "device",
            "seeds_per_block": plan.seeds_per_block, "smem_lut": plan.smem_lut,
            "counts": ("global", "float", "fixed")[plan.counts]}


def count_seed_passes(its, fused: bool) -> None:
    """Counts a group loop whose seeds ran ``its`` iterations: its seeds'
    data passes, sum(its), in ``em.seed_passes``, and in
    ``em.seed_passes_skipped`` those B1 no longer runs because the loop went
    on past a seed's stop, M * max(its) - sum(its) where the loop is
    ``fused`` (B1 deals its blocks to the active seeds), else 0 (every seed
    is scored every iteration)."""
    its = [int(x) for x in its]
    passes = sum(its)
    count("em.seed_passes", passes)
    count("em.seed_passes_skipped", len(its) * max(its) - passes if fused and its else 0)


def batched_step(v, q, data, alphas, f_bg, n_real, *, A, K, W, optimize_q, path, mesh=None):
    """One EM iteration for a seed-stacked group: (v, q) with a leading seed
    axis M -> (v_new, q_new, ll [M], v_diff [M]).  One E+M data pass serves
    all M seeds (with a mesh: this rank's rows, summed over the data group);
    the model update (``update``) runs batched over the seed axis."""
    n_rows = data.get("n_padded", data["lens"].shape[0])
    s_flat = motif_mod.log_odds_lut(v, data["bg_flat"])  # [M, R+1, W]
    C, ll = data_pass(path, s_flat, data, q, mesh)
    return update(C, ll, v, q, alphas, f_bg, n_real, n_rows, A=A, K=K, optimize_q=optimize_q)


def update(C, ll, v, q, alphas, f_bg, n_real, n_rows, *, A, K, optimize_q) -> tuple:
    """The model update after the data pass of M seeds (C f32 [M, R+1, W],
    ll f32 [M]) from (v, q): (v_new, q_new, ll, v_diff), ll taking the
    log(1-q) of each of the n_rows - n_real rows of length 0.
    ``ops.cuda_update.em_update`` computes the same in one kernel."""
    R = encode.num_rows(A, K)
    counts = motif_mod.counts_from_combined(C[:, :R], A, K)
    v_new = motif_mod.update_v(counts, alphas, f_bg)
    if optimize_q:
        q_new = torch.clamp(C.sum(dim=1)[:, 0] / n_real, 1e-4, 1 - 1e-4)
    else:
        q_new = q
    vd = sum((a - b).abs().sum(dim=(-2, -1)) for a, b in zip(v_new, v))
    # zero-length pad rows each contribute log(1-q)
    ll = ll - (n_rows - n_real) * torch.log1p(-q)
    return v_new, q_new, ll, vd


def advance(s: dict, v2, q2, ll2, vd2, n_hist_slots: int, hist_stride: int) -> None:
    """The loop state's step after an iteration that gave (v2, q2, ll2,
    vd2): the seeds still active (the group running, the seed not frozen:
    the reference's ``cond`` and its per-seed ``where``) take them, their
    effective v_diff min(vd2, |dll|) and one more iteration; ll2 goes to
    the history slot its // hist_stride (the last slot past the end)."""
    M, dev = s["q"].shape[0], s["q"].device
    active = s["running"] & (s["vds"] >= s["eps"])
    vd_eff = torch.minimum(vd2, (ll2 - s["lls"]).abs())
    for a, b in zip(s["v"], v2):
        a.copy_(torch.where(active[:, None, None], b, a))
    if n_hist_slots > 0:
        slot = torch.clamp(s["its"] // hist_stride, max=n_hist_slots - 1).long()
        seeds = torch.arange(M, device=dev)
        s["hist"][slot, seeds] = torch.where(active, ll2, s["hist"][slot, seeds])
    s["q"].copy_(torch.where(active, q2, s["q"]))
    s["lls"].copy_(torch.where(active, ll2, s["lls"]))
    s["vds"].copy_(torch.where(active, vd_eff, s["vds"]))
    s["its"].add_(active.to(torch.int32))


class FusedStep:
    """``batched_step`` and ``advance`` as two kernels, for a group whose
    data pass is the kernel's on one CUDA device with no mesh: B1's pass
    (``cuda_em.em_pass``, its blocks dealt to the seeds still active, read
    from the loop state on the device), then the model update, the loop
    state's step and the next iteration's LUT in one launch
    (``cuda_update.em_update``).
    Its loop state (``state``) keeps v stacked [M, R, W] beside the LUT
    ``s_flat``, B1's float64 counts ``Cd`` (zero between iterations) and
    ``logz``.  It reads the data, ``alphas`` and ``f_bg`` through
    ``inputs``, as ``group_step``'s step does."""

    def __init__(self, inputs: dict, n_real, *, A: int, K: int, optimize_q: bool):
        self.inputs, self.n_real = inputs, n_real
        self.A, self.K, self.optimize_q = A, K, optimize_q

    def state(self, v0: tuple) -> dict:
        """The loop state's tensors of its own, from the seeds' v0."""
        bg_flat, dev = self.inputs["bg_flat"], v0[0].device
        M, W = v0[0].shape[0], v0[0].shape[-1]
        return {"v": motif_mod.combined_v(v0), "s_flat": motif_mod.log_odds_lut(v0, bg_flat),
                "Cd": torch.zeros((M, bg_flat.shape[0] + 1, W), dtype=torch.float64, device=dev),
                "logz": torch.empty((M, self.inputs["lens"].shape[0]), device=dev)}

    def split(self, v: torch.Tensor) -> tuple:
        """The stacked v [M, R, W] as one tensor an order."""
        off = encode.order_offsets(self.A, self.K)
        return tuple(v[:, off[k]:off[k + 1]].clone() for k in range(self.K + 1))

    def __call__(self, s: dict, n_hist_slots: int, hist_stride: int) -> None:
        i = self.inputs
        cuda_em.em_pass(s["s_flat"], i["cidx"], i["lens"], s["q"], s["Cd"], s["logz"],
                        activity=(s["running"], s["vds"], s["eps"]))
        cuda_update.em_update(s["Cd"], s["logz"], s["v"], s["s_flat"], s["q"], s["lls"],
                              s["vds"], s["its"], s["hist"], s["running"], s["eps"],
                              i["alphas"], i["f_bg"], i["bg_flat"], n_real=self.n_real,
                              optimize_q=self.optimize_q, hist_slots=n_hist_slots,
                              hist_stride=hist_stride)


def batched_while_loop(step, v0, q0, epsilon, max_iters: int,
                       n_hist_slots: int = 0, hist_stride: int = 1, *, inputs=None, key=None,
                       ll0=None, mesh=None, graphs: bool = True):
    """The batched EM convergence loop (the reference's ``lax.while_loop``).

    ``step(v, q) -> (v, q, ll, v_diff)`` with a leading seed axis.  A seed
    freezes once v_diff OR |dll| drops under epsilon; the loop exits when
    all froze or the cap hits.  ``n_hist_slots > 0`` keeps an ll trace, one
    slot per ``hist_stride`` iterations (last write wins).  ``ll0`` [M]: the
    likelihoods the first dll compares against (default -inf).

    The iteration is one in-place body (``graphs.Loop``): every seed steps,
    and only those still active (the group running, the seed not frozen:
    the reference's ``cond`` and its per-seed ``where``) take the new
    state (``advance``), so a step past a seed's exit, or past the group's
    inside a chunk, changes nothing.  A ``step`` of ``group_step`` whose
    ``fused`` is set runs as that ``FusedStep`` instead, two kernels an
    iteration (counted once a loop in ``em.update_fused``).  The stop test
    (``_running``) follows each iteration.  On a CUDA device with no mesh
    the loop runs on the device to its end, as the reference's does: one
    launch of a graph whose WHILE node repeats the captured iteration while
    the test's kernel (``ops.cuda_while``) holds, with no host read
    (``graphs.device_loop``; the caller calls ``graphs.settle`` where it
    reads the results).
    Elsewhere the host runs SYNC_EVERY iterations, then reads one flag:
    eagerly, or as replays of a CUDA graph where the mesh's data group runs
    NCCL (``graphs.enabled``); ``graphs`` False runs it eagerly.  ``step``
    reads the tensors of ``inputs`` (name -> tensor) through that dict, and
    ``key`` holds every constant ``step`` depends on: together they let a
    later loop of the same key reuse the same graph, with its own cap, ll0
    and state.  Without ``key`` the loop runs eagerly.

    Returns (v, q, lls, vds, its, hist [n_hist_slots, M]).
    """
    M = q0.shape[0]
    dev = q0.device
    fused = getattr(step, "fused", None)
    state = {
        "v": tuple(vk.clone() for vk in v0),
        "q": q0.clone(),
        "lls": torch.full((M,), float("-inf"), dtype=torch.float32, device=dev)
        if ll0 is None else ll0.to(torch.float32).clone(),
        "vds": torch.full((M,), float("inf"), dtype=torch.float32, device=dev),
        "its": torch.zeros((M,), dtype=torch.int32, device=dev),
        "hist": torch.full((max(n_hist_slots, 1), M), float("nan"), dtype=torch.float32,
                           device=dev),
        "eps": torch.as_tensor(epsilon, dtype=torch.float32, device=dev).clone(),
        "cap": torch.full((), max_iters, dtype=torch.int32, device=dev),
    }
    state["running"] = _running(state)
    if fused is not None:
        state.update(fused.state(v0))
        count("em.update_fused")

    def body(s):
        if fused is not None:
            fused(s, n_hist_slots, hist_stride)
        else:
            advance(s, *step(s["v"], s["q"]), n_hist_slots, hist_stride)

    loop = graphs_mod.Loop("EM loop", key, state, inputs or {}, body, mesh=mesh,
                           graphs=graphs and key is not None, until=UNTIL)
    s = loop.state
    if loop.on_device:
        if max_iters > 0:
            loop.run_while()
    else:
        done = 0
        # past the cap every step is a no-op, so no chunk runs beyond it
        while done < max_iters:
            n = min(SYNC_EVERY, max_iters - done)
            loop.run(n)
            done += n
            if done < max_iters and not bool(s["running"]):  # the chunk's one host read
                break
    v = fused.split(s["v"]) if fused is not None else tuple(vk.clone() for vk in s["v"])
    return (v, s["q"].clone(), s["lls"].clone(), s["vds"].clone(), s["its"].clone(),
            s["hist"].clone())


def _running(s: dict) -> torch.Tensor:
    """The group's loop condition (the reference's ``cond``), on the device:
    the plain version of ``ops.cuda_while.condition``."""
    return cuda_while.condition_ref(s["its"], s["vds"], s["cap"], s["eps"])
