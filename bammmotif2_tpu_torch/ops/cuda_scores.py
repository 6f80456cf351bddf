"""Window log-odds scores for M seeds: the CUDA kernel's binding.

Port of ``bammmotif2_tpu.ops.pallas_em.window_scores_multi`` (the Pallas
TPU kernel ``_scores_kernel``).  ``window_scores_multi`` scores every window
of every strand against M combined log-odds LUTs in one launch
(``csrc/window_scores.cu``): the scanner's and the FDR scorer's hot op.  On
CPU tensors it runs the plain PyTorch version ``window_scores_multi_ref``;
on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from bammmotif2_tpu_torch.ops import _build, escore
from bammmotif2_tpu_torch.ops.cuda_em import SMEM_MAX, seed_chunks

# codes an item lays out in shared memory: whole rows at a power-of-two
# stride >= L + 16 (16 rows at L=200), tiles of one row beyond that
ROWS_CAP = 4096
STAGES = 2  # the kernel's bulk-copy buffers: one item streams in while one is scored
_STATIC = 64  # the kernel's static shared memory (its buffers' barriers), rounded up
# The LUTs of the seeds that share a block stay within this many bytes: a
# block scores each staged row for all its seeds, so sharing saves code
# loads and staging, while more LUT bytes cost resident blocks.  On config
# 5's 100k x 200 bp (K=0-4, M=1-33, W=12) the plan at 144 KB was 1.3% off
# the fastest seeds a block on average and at most 12%; at 48 KB 3.7% and
# 26% (K=4, M=32: one seed a block where two fit).  PERF.md §6, the
# seed-stack sweep.
LUT_TARGET = 144 * 1024


def smem_bytes(seeds_per_block: int, smem_lut: bool, R1: int, W: int) -> int:
    """The shared memory a block of the kernel takes: the dynamic part as
    window_scores_launch computes it (the block's LUTs, rows padded to the
    odd stride W | 1 and the whole rounded up to 16 bytes, the laid-out
    rows and STAGES bulk-copy buffers), and the static part."""
    lut = -(-seeds_per_block * R1 * (W | 1) // 4) * 4 if smem_lut else 0
    return 4 * (lut + ROWS_CAP + STAGES * (ROWS_CAP + 8)) + _STATIC


def launch_plan(M: int, R1: int, W: int) -> tuple:
    """(seeds_per_block, smem_lut) for LUTs of shape [M, R1, W].

    A seed's LUT is staged in shared memory when it fits beside the code
    buffers (through L1 it took 1.8-2.7x as long at K=0-2 and 2.2-13x at
    K=3-4).  The seeds then share blocks in balanced chunks of at most as
    many as fit LUT_TARGET and SMEM_MAX (at least one): 16 seeds of a cap
    of 11 run as 8 + 8, never 11 + 5 (``cuda_em.seed_chunks``; the kernel
    splits a launch's seeds over grid y the same way).  Above SMEM_MAX
    (A=4, K=5, W=12 needs 262 KB) the LUT is read through the read-only
    cache and every seed shares one block's codes.
    """
    if smem_bytes(1, True, R1, W) > SMEM_MAX:
        return max(M, 1), False
    cap = max(1, min(M, LUT_TARGET // (R1 * (W | 1) * 4)))
    while cap > 1 and smem_bytes(cap, True, R1, W) > SMEM_MAX:
        cap -= 1
    return max(b - a for a, b in seed_chunks(M, cap)) if M else 1, True


def library() -> ctypes.CDLL:
    lib = _build.load("window_scores")
    if lib.window_scores_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.window_scores_launch.argtypes = [p] * 5 + [i] * 9 + [p]
        lib.window_scores_launch.restype = i
        lib.window_scores_error_string.argtypes = [i]
        lib.window_scores_error_string.restype = ctypes.c_char_p
    return lib


def _check(s_flat, cidx, lens) -> None:
    dev = cidx.device
    for name, t, dtype in (
        ("s_flat", s_flat, torch.float32), ("cidx", cidx, torch.int32),
        ("lens", lens, torch.int32),
    ):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}; all inputs must share one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if s_flat.dim() != 3 or cidx.dim() != 3:
        raise ValueError(f"want s_flat [M, R+1, W] and cidx [S, N, L], got "
                         f"{tuple(s_flat.shape)} and {tuple(cidx.shape)}")
    W = s_flat.shape[2]
    _, N, L = cidx.shape
    if tuple(lens.shape) != (N,):
        raise ValueError(f"want lens [{N}], got {tuple(lens.shape)}")
    if L - W + 1 <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {L}")
    if W + 16 > ROWS_CAP:
        raise ValueError(f"motif width {W} exceeds the kernel's tile of {ROWS_CAP} codes")


def window_scores_multi(s_flat: torch.Tensor, cidx: torch.Tensor, lens: torch.Tensor) -> tuple:
    """Seed-stacked window scoring.

    Args:
      s_flat: f32 [M, R+1, W] combined log-odds LUTs, zero sentinel row R.
      cidx: int32 [S, N, L] combined-row codes in [0, R]
        (encode.strand_indices).
      lens: int32 [N].

    Returns (scores f32 [M, S, N, L-W+1] with escore.NEG_INF on invalid
    windows, mask bool [N, L-W+1]).  ``window_scores_multi.launches``
    counts kernel launches: one a call, all M seeds in balanced chunks of
    ``launch_plan``'s seeds a block.
    """
    if all(t.device.type == "cpu" for t in (s_flat, cidx, lens)):
        return window_scores_multi_ref(s_flat, cidx, lens)
    _check(s_flat, cidx, lens)
    M, R1, W = s_flat.shape
    S, N, L = cidx.shape
    dev = cidx.device
    n_win = L - W + 1
    scores = torch.empty((M, S, N, n_win), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return scores, escore.window_mask(lens, n_win, W)
    mask = torch.empty((N, n_win), dtype=torch.bool, device=dev)
    seeds_per_block, smem_lut = launch_plan(M, R1, W)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.window_scores_launch(
            cidx.data_ptr(), lens.data_ptr(), s_flat.data_ptr(),
            scores.data_ptr(), mask.data_ptr(),
            S, N, L, W, R1, M, seeds_per_block, int(smem_lut), ROWS_CAP,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"window_scores launch failed: {lib.window_scores_error_string(err).decode()}"
        )
    window_scores_multi.launches += 1
    return scores, mask


window_scores_multi.launches = 0


def window_scores(s_flat: torch.Tensor, cidx: torch.Tensor, lens: torch.Tensor) -> tuple:
    """``window_scores_multi`` with M=1: s_flat [R+1, W] -> (scores
    [S, N, L-W+1], mask [N, L-W+1])."""
    scores, mask = window_scores_multi(s_flat[None], cidx, lens)
    return scores[0], mask


def window_scores_multi_ref(s_flat: torch.Tensor, cidx: torch.Tensor,
                            lens: torch.Tensor) -> tuple:
    """The plain PyTorch version of ``window_scores_multi``
    (``escore.window_scores``, one seed at a time); same arguments and
    results, on any device."""
    M, _, W = s_flat.shape
    S, N, L = cidx.shape
    n_win = L - W + 1
    if n_win <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {L}")
    mask = escore.window_mask(lens, n_win, W)
    if M == 0:
        return torch.empty((0, S, N, n_win), dtype=s_flat.dtype, device=cidx.device), mask
    return torch.stack([escore.window_scores(s_flat[m], cidx, lens, W)[0] for m in range(M)]), mask
