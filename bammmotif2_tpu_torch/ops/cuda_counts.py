"""Counts from external responsibilities for M seeds: the CUDA kernel's binding.

Port of ``bammmotif2_tpu.ops.pallas_em.counts_from_r_multi`` (the Pallas TPU
kernel ``_counts_kernel``).  ``counts_from_r_multi`` scatters responsibility
tensors r [M, S, N, L] into combined count rows, in one launch
(``csrc/counts_from_r.cu``): the count pass of a collapsed Gibbs sweep,
whose r is the sampler's 0/1 occupancy.  On CPU tensors it runs the plain
PyTorch version ``counts_from_r_multi_ref``; on CUDA tensors it launches the
kernel or raises.

All M seeds go in that one launch, a seed's blocks beside the others' on
grid y: at M = 4-33 it was 2-13% faster than the best split into
consecutive balanced launches of 16, 8 or 4 seeds and up to 2.2x faster
than a launch a seed (bench's set, 0/1 r, K=2 and 4; PERF.md §6, the
seed-stack sweep).

A call enqueues exactly one kernel and no other device operation: the
kernel sums across its blocks in a float64 accumulator that it leaves zero,
held in a per-stream ``workspace`` (shared with ``cuda_flat.counts_from_r``).
After the first call at a shape on a stream a call allocates nothing on the
device but its output and makes no host query, so it may be captured in a
CUDA graph.  The launcher makes the tensors' device current itself, and the
stream's handle comes from ``current_stream``: a Python device context and a
``torch.cuda.Stream`` object cost more host time than the launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bammmotif2_tpu_torch.ops import _build, escore
from bammmotif2_tpu_torch.ops.cuda_em import SMEM_MAX

# static shared memory of the counts kernels (csrc/counts.cuh: eight warps'
# queues of 648 32-bit offsets, and a flag), rounded up
STATIC_SMEM = 21 * 1024

# (device index, stream handle) -> [acc f64, tickets int32, retired buffers]
_WORKSPACES: dict = {}


def workspace(device: torch.device, stream: int, n_acc: int, n_tickets: int) -> tuple:
    """(acc, tickets) of the counts kernels on ``stream`` (a handle on
    ``device``): a float64 accumulator of at least ``n_acc`` entries and at
    least ``n_tickets`` int32 ticket counters, all zero between launches
    (each launch leaves them zero).

    One per (device, stream), never shared between two streams; the
    launches on one stream are ordered, so both counts wrappers share it.
    It grows (zeroed, on ``stream``) when a call needs more, and keeps the
    buffers it outgrew alive, since a captured CUDA graph may still hold
    their addresses.
    """
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < n_acc or ws[1].numel() < n_tickets:
        retired = [] if ws is None else [*ws[2], ws[0], ws[1]]
        n_acc = max(n_acc, 0 if ws is None else ws[0].numel())
        n_tickets = max(n_tickets, 0 if ws is None else ws[1].numel())
        ws = [torch.zeros(n_acc, dtype=torch.float64, device=device),
              torch.zeros(n_tickets, dtype=torch.int32, device=device), retired]
        _WORKSPACES[key] = ws
    return ws[0], ws[1]


@functools.cache
def launch_plan(R1: int, W: int) -> bool:
    """Whether each block privatises one seed's [R1, W] f32 counts in
    shared memory, beside the kernel's STATIC_SMEM.  Above SMEM_MAX (A=4,
    K=5 at W=12 needs 262 KB) every responsibility adds to the float64
    accumulator directly."""
    return R1 * W * 4 + STATIC_SMEM <= SMEM_MAX


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load("counts_from_r")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.counts_from_r_launch.argtypes = [p] * 5 + [ctypes.c_longlong] + [i] * 6 + [p]
    lib.counts_from_r_launch.restype = i
    lib.counts_from_r_error_string.argtypes = [i]
    lib.counts_from_r_error_string.restype = ctypes.c_char_p
    return lib


def current_stream(index: int) -> int:
    """The handle of CUDA device ``index``'s current stream (the capture
    stream under CUDA-graph capture), without building a
    ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)


def _check(r, cidx, R: int, W: int) -> None:
    dev = cidx.device
    for name, t, dtype in (("r", r, torch.float32), ("cidx", cidx, torch.int32)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}; all inputs must share one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dim() != 4 or cidx.dim() != 3 or tuple(r.shape[1:]) != tuple(cidx.shape):
        raise ValueError(f"want r [M, S, N, L] and cidx [S, N, L], got "
                         f"{tuple(r.shape)} and {tuple(cidx.shape)}")
    if R < 0 or W < 1:
        raise ValueError(f"want R >= 0 and W >= 1, got R={R}, W={W}")
    if cidx.shape[2] - W + 1 <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {cidx.shape[2]}")
    if r.shape[0] > 65535:
        raise ValueError(f"at most 65535 seeds a launch, got {r.shape[0]}")


def counts_from_r_multi(r: torch.Tensor, cidx: torch.Tensor, R: int, W: int) -> torch.Tensor:
    """Seed-stacked counts from responsibilities.

    Args:
      r: f32 [M, S, N, L] per-seed window responsibilities laid out like
        cidx; only window starts i < L-W+1 are read.
      cidx: int32 [S, N, L] combined-row codes in [0, R]
        (encode.strand_indices).
      R: the sentinel row (``encode.num_rows(A, K)``).
      W: motif width.

    Returns C f32 [M, R+1, W] with C[m, cidx[s, n, i+j], j] += r[m, s, n, i]
    and the sentinel row's mass kept.  No ``lens``: mass on a window past a
    row's end lands in the row cidx holds there.  ``counts_from_r_multi.
    launches`` counts kernel launches: one a call.
    """
    if r.device.type == "cpu" and cidx.device.type == "cpu":
        return counts_from_r_multi_ref(r, cidx, R, W)
    _check(r, cidx, R, W)
    M = r.shape[0]
    S, N, L = cidx.shape
    R1 = R + 1
    dev = cidx.device
    if M == 0 or S * N == 0:
        return torch.zeros((M, R1, W), dtype=torch.float32, device=dev)
    C = torch.empty((M, R1, W), dtype=torch.float32, device=dev)
    lib = library()
    stream = current_stream(dev.index)
    acc, tickets = workspace(dev, stream, M * R1 * W, M)
    err = lib.counts_from_r_launch(
        r.data_ptr(), cidx.data_ptr(), C.data_ptr(), acc.data_ptr(), tickets.data_ptr(),
        S * N * L, L, W, R1, M, int(launch_plan(R1, W)), dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"counts_from_r launch failed: {lib.counts_from_r_error_string(err).decode()}"
        )
    counts_from_r_multi.launches += 1
    return C


counts_from_r_multi.launches = 0


def counts_from_r(r: torch.Tensor, cidx: torch.Tensor, R: int, W: int) -> torch.Tensor:
    """``counts_from_r_multi`` with M=1: r [S, N, L] -> C [R+1, W]."""
    return counts_from_r_multi(r[None], cidx, R, W)[0]


def counts_from_r_multi_ref(r: torch.Tensor, cidx: torch.Tensor, R: int, W: int) -> torch.Tensor:
    """The plain PyTorch version of ``counts_from_r_multi``
    (``escore.mstep_counts`` on the window starts, one seed at a time, in
    float64 sums); same arguments and result, on any device."""
    M = r.shape[0]
    L = cidx.shape[2]
    n_win = L - W + 1
    if n_win <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {L}")
    if M == 0:
        return torch.zeros((0, R + 1, W), dtype=r.dtype, device=r.device)
    return torch.stack([escore.mstep_counts(r[m, :, :, :n_win], cidx, R, W) for m in range(M)])
