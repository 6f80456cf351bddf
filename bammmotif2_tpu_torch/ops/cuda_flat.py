"""The three passes on base-(A+1) codes: the CUDA kernels' bindings.

Port of ``tools/pallas_flat.py`` (the Pallas TPU kernels ``_em_kernel``,
``_scores_kernel`` and ``_counts_kernel``), with its three public functions'
signatures and layouts, minus ``interpret``:

  - ``em_counts``: the fused E+M data pass of one ZOOPS EM iteration, M=1;
  - ``window_scores``: window log-odds scores with the validity mask;
  - ``counts_from_r``: counts from an explicit responsibility tensor.

They read base-(A+1) codes ``qidx`` (``encode.strand_base5_indices``) and
the static map ``map5`` (``encode.map_base5_to_combined``) instead of the
combined rows ``cidx``: ``map5[qidx] == cidx``, so order truncation is a
lookup.  Each kernel (``csrc/flat.cu``) runs its combined-layout
counterpart's pass (``csrc/em.cuh``, ``scores.cuh``, ``counts.cuh``) and maps
each code through ``map5`` where the pass stages it, so the LUT is ``s_flat``
[R+1, W] itself and the counts land in the combined rows: no gather of the
LUT, no fold of the counts.  Their launch plans are the counterparts' for
one seed (``em_plan``, ``scores_plan``, ``counts_plan``).  The E+M kernel
reads ``map5`` through L1; the scores kernel stages it in shared memory
where that costs an SM no resident block, and the counts kernel beside its
counts where both fit.
A call enqueues its kernel and nothing else (the E+M call also zeroes its
float64 counts and runs the counterpart's rounding and fixed-order ll
kernels), and the launchers make the tensors' device current themselves.
On CPU tensors each function runs its plain PyTorch version (``*_ref``); on
CUDA tensors it launches its kernel or raises.

Not ported: the TPU module's layout helpers (``_geometry``, ``supported``,
``_split_terms_xla``, ``_lhs_terms``, ``_prep``, ``_skew_bits``,
``_escore_group``, ``_window_sums``, ``_mstep_group``).  The G-row lane
flattening, the log-skew rolls, the bf16 term splits of the LUT and r and
the VMEM budget all exist because the TPU has no fast gather; Hopper
gathers from shared memory, so there is no block padding (hence no pad-row
correction of ll).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bammmotif2_tpu_torch.ops import _build, cuda_counts, cuda_em, cuda_scores, encode, escore
from bammmotif2_tpu_torch.ops.cuda_em import SMEM_MAX, SMEM_TARGET


def em_plan(R1: int, W: int, S: int, L: int):
    """The E+M kernel's plan for codes [S, N, L]: the combined kernel's for
    one seed (``cuda_em.launch_plan(1, R1, W, S, L)``).  map5 takes no shared
    memory: the kernel reads it through L1."""
    return cuda_em.launch_plan(1, R1, W, S, L)


@functools.cache
def scores_plan(Q: int, R1: int, W: int) -> tuple:
    """(smem_lut, map_fits) of the window-score kernel: the combined
    kernel's plan for one seed (``cuda_scores.launch_plan(1, R1, W)``), and
    whether map5 ([Q] int32) fits in shared memory beside it under SMEM_MAX.
    Where it fits, the launcher stages it if that costs an SM no resident
    block (by the CUDA occupancy query), else reads it through L1."""
    _spb, smem_lut = cuda_scores.launch_plan(1, R1, W)
    return smem_lut, cuda_scores.smem_bytes(1, smem_lut, R1, W) + 4 * Q <= SMEM_MAX


@functools.cache
def counts_plan(Q: int, R1: int, W: int) -> tuple:
    """(smem_counts, smem_map) of the counts-from-r kernel: the combined
    [R1, W] counts privatised in shared memory as ``cuda_counts.launch_plan``
    decides, and map5 ([Q] int32) staged beside them while both fit in
    SMEM_TARGET, else read through L1 (A=4: staged up to K=3; every block
    reads the whole map to stage it, 62.5 KB at K=5)."""
    smem_counts = cuda_counts.launch_plan(R1, W)
    return smem_counts, (R1 * W * 4 if smem_counts else 0) + Q * 4 <= SMEM_TARGET


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load("flat")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flat_em_launch.argtypes = [p] * 9 + [i] * 10 + [p]
    lib.flat_em_launch.restype = i
    lib.flat_scores_launch.argtypes = [p] * 6 + [i] * 10 + [p]
    lib.flat_scores_launch.restype = i
    lib.flat_counts_launch.argtypes = [p] * 6 + [ctypes.c_longlong] + [i] * 7 + [p]
    lib.flat_counts_launch.restype = i
    lib.flat_error_string.argtypes = [i]
    lib.flat_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.flat_error_string(err).decode()}")


def _check(named: tuple, A: int, K: int, W: int, R: int | None, s_flat=None, map5=None) -> None:
    """Device, dtype, contiguity and shape checks shared by the wrappers;
    ``named`` holds (name, tensor, dtype) triples, all on one CUDA device.
    The kernels index the combined tables through map5, so R, where given,
    and s_flat's rows must be those of (A, K)."""
    dev = named[0][1].device
    for name, t, dtype in named:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}; all inputs must share one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if A < 1 or K < 0 or W < 1:
        raise ValueError(f"want A >= 1, K >= 0, W >= 1, got A={A}, K={K}, W={W}")
    Q, rows = (A + 1) ** (K + 1), encode.num_rows(A, K)
    if R is not None and R != rows:
        raise ValueError(f"want R = {rows} for A={A}, K={K}, got R={R}")
    if map5 is not None and tuple(map5.shape) != (Q,):
        raise ValueError(f"want map5 [{Q}] for A={A}, K={K}, got {tuple(map5.shape)}")
    if s_flat is not None and tuple(s_flat.shape) != (rows + 1, W):
        raise ValueError(f"want s_flat [{rows + 1}, {W}], got {tuple(s_flat.shape)}")


def _fold(Cq: torch.Tensor, map5: torch.Tensor, R: int) -> torch.Tensor:
    """Base-(A+1) counts [Q, W] (float64) summed into combined rows
    [R+1, W] in float64 and rounded once to float32 (the plain versions)."""
    C = torch.zeros((R + 1, Cq.shape[1]), dtype=torch.float64, device=Cq.device)
    return C.index_add_(0, map5.to(torch.int64), Cq).to(torch.float32)


def _lut(s_flat: torch.Tensor, map5: torch.Tensor) -> torch.Tensor:
    """s5 = s_flat[map5]: the LUT on base-(A+1) codes, [Q, W] (the plain
    versions)."""
    return s_flat[map5.to(torch.int64)].contiguous()


def em_counts(s_flat: torch.Tensor, qidx: torch.Tensor, lens: torch.Tensor, q,
              map5: torch.Tensor, *, A: int, K: int, W: int, R: int) -> tuple:
    """Fused E+M data pass on base-(A+1) codes; same contract as
    ``cuda_em.em_counts_multi`` with M=1.

    Args:
      s_flat: f32 [R+1, W] combined log-odds LUT, zero sentinel row R.
      qidx: int32 [S, N, L] base-(A+1) codes in [0, (A+1)^(K+1)).
      lens: int32 [N].
      q: the ZOOPS prior (a float or a 0-d/1-element f32 tensor).
      map5: int32 [(A+1)^(K+1)] (encode.map_base5_to_combined).

    Returns (C f32 [R+1, W] with the sentinel row's mass kept, ll f32 []).
    ``em_counts.launches`` counts kernel launches.
    """
    q = torch.as_tensor(q, dtype=torch.float32, device=qidx.device).reshape(1)
    if all(t.device.type == "cpu" for t in (s_flat, qidx, lens, q, map5)):
        return em_counts_ref(s_flat, qidx, lens, q, map5, A=A, K=K, W=W, R=R)
    _check((("s_flat", s_flat, torch.float32), ("qidx", qidx, torch.int32),
            ("lens", lens, torch.int32), ("map5", map5, torch.int32)), A, K, W, R, s_flat, map5)
    S, N, L = qidx.shape
    if tuple(lens.shape) != (N,):
        raise ValueError(f"want lens [{N}], got {tuple(lens.shape)}")
    if L - W + 1 <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {L}")
    dev, R1 = qidx.device, R + 1
    if N == 0:
        return (torch.zeros((R1, W), dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.float32, device=dev))
    C = torch.empty((R1, W), dtype=torch.float32, device=dev)
    ll = torch.empty((1,), dtype=torch.float32, device=dev)
    Cd = torch.zeros((R1, W), dtype=torch.float64, device=dev)
    logz = torch.empty((N,), dtype=torch.float32, device=dev)
    plan = em_plan(R1, W, S, L)
    lib = library()
    err = lib.flat_em_launch(
        qidx.data_ptr(), lens.data_ptr(), s_flat.data_ptr(), q.data_ptr(), map5.data_ptr(),
        C.data_ptr(), Cd.data_ptr(), logz.data_ptr(), ll.data_ptr(), S, N, L, W, R1,
        int(plan.smem_lut), plan.counts, plan.team, plan.codes_cap, dev.index,
        cuda_counts.current_stream(dev.index),
    )
    _raise_on(lib, err, "flat em_counts")
    em_counts.launches += 1
    return C, ll[0]


em_counts.launches = 0


def em_counts_ref(s_flat: torch.Tensor, qidx: torch.Tensor, lens: torch.Tensor, q,
                  map5: torch.Tensor, *, A: int, K: int, W: int, R: int) -> tuple:
    """The plain PyTorch version of ``em_counts`` (escore ops on s5 and
    qidx, counts summed and folded in float64); same arguments and results,
    on any device."""
    q = torch.as_tensor(q, dtype=torch.float32, device=qidx.device).reshape(())
    Q = (A + 1) ** (K + 1)
    scores, mask = escore.window_scores(_lut(s_flat, map5), qidx, lens, W)
    r, _r0, ll = escore.zoops_posterior(scores, mask, q)
    Cq = escore.mstep_counts(r.double(), qidx, Q - 1, W)
    return _fold(Cq, map5, R), ll


def window_scores(s_flat: torch.Tensor, qidx: torch.Tensor, lens: torch.Tensor,
                  map5: torch.Tensor, *, A: int, K: int, W: int) -> tuple:
    """Window scores on base-(A+1) codes; same contract as
    ``cuda_scores.window_scores``.

    Returns (scores f32 [S, N, L-W+1] with escore.NEG_INF on invalid
    windows, mask bool [N, L-W+1]).  ``window_scores.launches`` counts
    kernel launches.
    """
    if all(t.device.type == "cpu" for t in (s_flat, qidx, lens, map5)):
        return window_scores_ref(s_flat, qidx, lens, map5, A=A, K=K, W=W)
    _check((("s_flat", s_flat, torch.float32), ("qidx", qidx, torch.int32),
            ("lens", lens, torch.int32), ("map5", map5, torch.int32)), A, K, W, None, s_flat, map5)
    S, N, L = qidx.shape
    if tuple(lens.shape) != (N,):
        raise ValueError(f"want lens [{N}], got {tuple(lens.shape)}")
    n_win = L - W + 1
    if n_win <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {L}")
    if W + 16 > cuda_scores.ROWS_CAP:
        raise ValueError(f"motif width {W} exceeds the kernel's tile of {cuda_scores.ROWS_CAP} codes")
    dev, R1, Q = qidx.device, s_flat.shape[0], map5.shape[0]
    scores = torch.empty((S, N, n_win), dtype=torch.float32, device=dev)
    if N == 0:
        return scores, escore.window_mask(lens, n_win, W)
    mask = torch.empty((N, n_win), dtype=torch.bool, device=dev)
    smem_lut, map_fits = scores_plan(Q, R1, W)
    lib = library()
    err = lib.flat_scores_launch(
        qidx.data_ptr(), lens.data_ptr(), s_flat.data_ptr(), map5.data_ptr(), scores.data_ptr(),
        mask.data_ptr(), S, N, L, W, R1, Q, int(smem_lut), int(map_fits), cuda_scores.ROWS_CAP,
        dev.index, cuda_counts.current_stream(dev.index),
    )
    _raise_on(lib, err, "flat window_scores")
    window_scores.launches += 1
    return scores, mask


window_scores.launches = 0


def window_scores_ref(s_flat: torch.Tensor, qidx: torch.Tensor, lens: torch.Tensor,
                      map5: torch.Tensor, *, A: int, K: int, W: int) -> tuple:
    """The plain PyTorch version of ``window_scores`` (escore.window_scores
    on s5 and qidx); same arguments and results, on any device."""
    return escore.window_scores(_lut(s_flat, map5), qidx, lens, W)


def counts_from_r(r_snl: torch.Tensor, qidx: torch.Tensor, map5: torch.Tensor, *,
                  A: int, K: int, W: int, R: int) -> torch.Tensor:
    """Counts from responsibilities on base-(A+1) codes; the contract of
    ``cuda_counts.counts_from_r`` (M=1) with r in the TPU function's layout.

    Args:
      r_snl: f32 [S, N, L] responsibilities laid out like qidx.  Only window
        starts i < L-W+1 are read, and the contract requires r = 0 there:
        the TPU kernel reads all L positions and rolls mass at i >= L-W+1
        into the next strand's or row's lanes.
      qidx: int32 [S, N, L] base-(A+1) codes; map5 as for em_counts.

    Returns C f32 [R+1, W] with C[map5[qidx[s, n, i+j]], j] += r[s, n, i]
    and the sentinel row's mass kept, summed in float64 and rounded once:
    one kernel, as ``cuda_counts.counts_from_r_multi``.
    ``counts_from_r.launches`` counts kernel launches.
    """
    if all(t.device.type == "cpu" for t in (r_snl, qidx, map5)):
        return counts_from_r_ref(r_snl, qidx, map5, A=A, K=K, W=W, R=R)
    _check((("r_snl", r_snl, torch.float32), ("qidx", qidx, torch.int32),
            ("map5", map5, torch.int32)), A, K, W, R, None, map5)
    if tuple(r_snl.shape) != tuple(qidx.shape) or qidx.dim() != 3:
        raise ValueError(f"want r_snl and qidx [S, N, L], got {tuple(r_snl.shape)} and "
                         f"{tuple(qidx.shape)}")
    if R < 0:
        raise ValueError(f"want R >= 0, got R={R}")
    S, N, L = qidx.shape
    if L - W + 1 <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {L}")
    dev, R1, Q = qidx.device, R + 1, map5.shape[0]
    if S * N == 0:
        return torch.zeros((R1, W), dtype=torch.float32, device=dev)
    C = torch.empty((R1, W), dtype=torch.float32, device=dev)
    smem_counts, smem_map = counts_plan(Q, R1, W)
    lib = library()
    stream = cuda_counts.current_stream(dev.index)
    acc, ticket = cuda_counts.workspace(dev, stream, R1 * W, 1)
    err = lib.flat_counts_launch(
        r_snl.data_ptr(), qidx.data_ptr(), map5.data_ptr(), C.data_ptr(), acc.data_ptr(),
        ticket.data_ptr(), S * N * L, L, W, R1, Q, int(smem_counts), int(smem_map), dev.index,
        stream,
    )
    _raise_on(lib, err, "flat counts_from_r")
    counts_from_r.launches += 1
    return C


counts_from_r.launches = 0


def counts_from_r_ref(r_snl: torch.Tensor, qidx: torch.Tensor, map5: torch.Tensor, *,
                      A: int, K: int, W: int, R: int) -> torch.Tensor:
    """The plain PyTorch version of ``counts_from_r`` (escore.mstep_counts
    on the window starts in float64, then the fold); same arguments and
    result, on any device."""
    n_win = qidx.shape[2] - W + 1
    if n_win <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {qidx.shape[2]}")
    Cq = escore.mstep_counts(r_snl[:, :, :n_win].double(), qidx, (A + 1) ** (K + 1) - 1, W)
    return _fold(Cq, map5, R)
