"""Counts from external responsibilities for M seeds: the CUDA kernel's binding.

Port of ``bammmotif2_tpu.ops.pallas_em.counts_from_r_multi`` (the Pallas TPU
kernel ``_counts_kernel``).  ``counts_from_r_multi`` scatters responsibility
tensors r [M, S, N, L] into combined count rows, in one launch
(``csrc/counts_from_r.cu``): the count pass of a collapsed Gibbs sweep,
whose r is the sampler's 0/1 occupancy.  On CPU tensors it runs the plain
PyTorch version ``counts_from_r_multi_ref``; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from bammmotif2_tpu_torch.ops import _build, escore
from bammmotif2_tpu_torch.ops.cuda_em import SMEM_MAX, SMEM_TARGET


def launch_plan(M: int, R1: int, W: int) -> tuple:
    """(seeds_per_block, smem_counts) for counts of shape [M, R1, W].

    Counts are privatised per block in shared memory when one seed's
    [R1, W] f32 table fits; as many seeds share a block's copy as fit in
    SMEM_TARGET (at least one).  Above SMEM_MAX (A=4, K=5 needs 262 KB)
    every seed gets its own blocks and adds to the float64 global counts
    directly.
    """
    per_seed = R1 * W * 4
    if per_seed > SMEM_MAX:
        return 1, False
    return max(1, min(M, SMEM_TARGET // per_seed)), True


def library() -> ctypes.CDLL:
    lib = _build.load("counts_from_r")
    if lib.counts_from_r_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.counts_from_r_launch.argtypes = [p] * 4 + [i] * 7 + [p]
        lib.counts_from_r_launch.restype = i
        lib.counts_from_r_error_string.argtypes = [i]
        lib.counts_from_r_error_string.restype = ctypes.c_char_p
    return lib


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
    launches`` counts kernel launches.
    """
    if r.device.type == "cpu" and cidx.device.type == "cpu":
        return counts_from_r_multi_ref(r, cidx, R, W)
    _check(r, cidx, R, W)
    M = r.shape[0]
    S, N, L = cidx.shape
    R1 = R + 1
    dev = cidx.device
    C = torch.zeros((M, R1, W), dtype=torch.float32, device=dev)
    if M == 0 or S * N == 0:
        return C
    Cd = torch.zeros((M, R1, W), dtype=torch.float64, device=dev)
    seeds_per_block, smem_counts = launch_plan(M, R1, W)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.counts_from_r_launch(
            r.data_ptr(), cidx.data_ptr(), C.data_ptr(), Cd.data_ptr(),
            S * N, L, W, R1, M, seeds_per_block, int(smem_counts),
            torch.cuda.current_stream(dev).cuda_stream,
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
