"""Fused E+M data pass of one ZOOPS EM iteration: the CUDA kernel's binding.

Port of ``bammmotif2_tpu.ops.pallas_em.em_counts_multi`` (the Pallas TPU
kernel ``_kernel``).  ``em_counts_multi`` scores every window of every
strand for M seeds, forms the ZOOPS posterior per sequence and scatters the
responsibilities into combined count rows, in one launch
(``csrc/em_counts.cu``).  On CPU tensors it runs the plain PyTorch version
``em_counts_multi_ref``; on CUDA tensors it launches the kernel or raises.

The seed stack (``launch_plan``, ``seed_launches``): every seed has blocks
of its own, one launch's grid holds the M seeds' blocks side by side with
the resident blocks split evenly over them (rounded down, so no block waits
for a second wave); where the counts are summed in float each seed gets a
launch of its own, in turn on the stream (PERF.md §6, the seed-stack
sweep).  Inside the EM loop (``em_pass`` with the loop's ``activity``) a
launch deals its blocks to the seeds still active at each iteration, on
the device, so a frozen seed's blocks go to the others.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bammmotif2_tpu_torch.ops import _build, escore

# Shared memory one H100 block may opt into, and the share the wrapper
# aims for so several blocks stay resident per SM (hopper-kernels table).
SMEM_MAX = 232_448
SMEM_TARGET = 48 * 1024
_SCRATCH = 2 * 8 * 4  # the kernel's (max, sum) reduction slots, 8 warps
# A warp owns a sequence while S * L codes are at most this (rows of up to
# 400 bp on both strands); longer rows take a block each, which buffers
# BLOCK_CODES codes and log-weights at a time and tiles rows beyond that.
# The two tie at 800 codes; at 400 the warp is 1.5x faster, at 1,024 the
# block 1.2x (PERF.md, PR 5, plan sweep).
WARP_ROW_CODES = 800
BLOCK_CODES = 4096


class Plan(NamedTuple):
    """How ``em_counts_launch`` runs: ``seeds_per_block`` seeds share a
    block; ``smem_lut`` / ``smem_counts`` say whether their LUTs and counts
    live in shared memory (else the LUT is read through L1 and counts go to
    float64 global atomics), ``fixed_counts`` whether shared counts are
    64-bit fixed point (else float); ``team`` threads (32 or 256) own a
    sequence; each team buffers ``codes_cap`` codes and as many
    log-weights."""

    seeds_per_block: int
    smem_lut: bool
    smem_counts: bool
    fixed_counts: bool
    team: int
    codes_cap: int

    @property
    def counts(self) -> int:
        """em_counts_launch's counts argument: 0 global, 1 float, 2 fixed."""
        return 0 if not self.smem_counts else 2 if self.fixed_counts else 1


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def seed_chunks(M: int, cap: int) -> list:
    """[(m0, m1), ...]: M seeds in ceil(M / cap) consecutive chunks whose
    sizes differ by at most one (chunk y holds seeds y*M//n to
    (y+1)*M//n, as the kernels split a launch's seeds over grid y), so 7
    seeds at a cap of 6 run as 3 + 4, never 6 + 1; none for M = 0."""
    n = -(-M // max(cap, 1))
    return [(y * M // n, (y + 1) * M // n) for y in range(n)]


def smem_bytes(plan: Plan, R1: int, W: int) -> int:
    """The dynamic shared memory a block of ``plan`` asks for, as
    em_counts_launch computes it."""
    table = _round4(plan.seeds_per_block * R1 * W)
    words = int(plan.smem_lut) + int(plan.smem_counts) * (1 + int(plan.fixed_counts))
    return _SCRATCH + 4 * (words * table + 256 // plan.team * 2 * plan.codes_cap)


def launch_plan(M: int, R1: int, W: int, S: int = 2, L: int = 200) -> Plan:
    """The plan for counts of shape [M, R1, W] over codes [S, N, L].

    A warp owns a sequence where S * L <= WARP_ROW_CODES, else a block.
    Counts are privatised in shared memory when one seed's [W, R1] table
    fits beside the teams' buffers: as 64-bit fixed point where that fits
    (exact block sums, and faster: at K=4 too), else as float (A=4, K=4,
    W=30).  The LUT joins them where it fits too (faster than L1 at K=2 and
    K=4).  Where counts do not fit (A=4, K=5 needs 262 KB) the LUT is read
    through L1 and every count adds to the float64 global counts directly.

    One seed a block, whatever M: on bench's set (K=0-4, W=8/12/20, M=1-33)
    it was within 6% of the fastest seeds a block in every case and 1.0-1.7%
    off on average, while sharing lost up to 2.8x at K>=2 (shared tables cost
    resident blocks; staging the codes once saves little beside scoring and
    scattering every seed).  PERF.md §6, the seed-stack sweep.
    """
    team = 32 if S * L <= WARP_ROW_CODES else 256
    codes_cap = _round4(S * L) if team == 32 else max(BLOCK_CODES, _round4(W))

    def need(spb, lut, counts, fixed):
        return smem_bytes(Plan(spb, lut, counts, fixed, team, codes_cap), R1, W)

    counts = need(1, False, True, False) <= SMEM_MAX
    fixed = counts and need(1, False, True, True) <= SMEM_MAX
    lut = counts and need(1, True, True, fixed) <= SMEM_MAX
    return Plan(1, lut, counts, fixed, team, codes_cap)


def seed_launches(plan: Plan, M: int) -> list:
    """The (m0, m1) seed ranges ``em_counts_multi`` launches in turn: all M
    seeds at once, or a launch a seed where the plan sums counts in float
    (where fixed point does not fit: A=4, K=4, W >= 19).  A float table's
    error grows with the rows a block sums, and a stack of s seeds in one
    launch leaves each seed 1/s of the grid: on bench's set at K=4, W=20
    the counts missed the bar at 33 seeds a launch (|dC| 1.6x 1e-4 + 1e-5
    |C|) and reached 0.24x and 0.47x of it at 4 and 8, against 0.07x at one
    seed a launch, which sums no more rows a block than M=1 and took 10%
    longer than launches of 4 (13.5 against 12.2 ms at M=16).  PERF.md §6,
    the seed-stack sweep."""
    return seed_chunks(M, 1 if plan.smem_counts and not plan.fixed_counts else M)


def library() -> ctypes.CDLL:
    lib = _build.load("em_counts")
    if lib.em_counts_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.em_counts_launch.argtypes = [p] * 11 + [i] * 11 + [p]
        lib.em_counts_launch.restype = i
        lib.em_counts_error_string.argtypes = [i]
        lib.em_counts_error_string.restype = ctypes.c_char_p
    return lib


def _check(s_flat, cidx, lens, q) -> None:
    dev = cidx.device
    for name, t, dtype in (
        ("s_flat", s_flat, torch.float32), ("cidx", cidx, torch.int32),
        ("lens", lens, torch.int32), ("q", q, torch.float32),
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
    M, _, W = s_flat.shape
    _, N, L = cidx.shape
    if tuple(lens.shape) != (N,) or tuple(q.shape) != (M,):
        raise ValueError(f"want lens [{N}] and q [{M}], got "
                         f"{tuple(lens.shape)} and {tuple(q.shape)}")
    if L - W + 1 <= 0:
        raise ValueError(f"motif width {W} exceeds padded length {L}")


def em_counts_multi(s_flat: torch.Tensor, cidx: torch.Tensor, lens: torch.Tensor,
                    q: torch.Tensor, unrounded: bool = False) -> tuple:
    """Seed-stacked fused E+M data pass.

    Args:
      s_flat: f32 [M, R+1, W] combined log-odds LUTs, zero sentinel row R.
      cidx: int32 [S, N, L] combined-row codes in [0, R]
        (encode.strand_indices).
      lens: int32 [N].
      q: f32 [M] per-seed ZOOPS priors.

    Returns (C f32 [M, R+1, W] fractional counts with the sentinel row's
    mass kept, ll f32 [M] ZOOPS log-likelihoods); with ``unrounded`` C is
    the float64 sums the kernel rounds from (a sharded run adds them over
    its ranks before rounding once).  ``em_counts_multi.launches`` counts
    kernel launches: one a call, or one a seed where ``seed_launches``
    gives each seed its own.
    """
    if all(t.device.type == "cpu" for t in (s_flat, cidx, lens, q)):
        return em_counts_multi_ref(s_flat, cidx, lens, q, unrounded)
    _check(s_flat, cidx, lens, q)
    M, R1, W = s_flat.shape
    N = cidx.shape[1]
    dev = cidx.device
    C = torch.zeros((M, R1, W), dtype=torch.float32, device=dev)
    ll = torch.zeros((M,), dtype=torch.float32, device=dev)
    Cd = torch.zeros((M, R1, W), dtype=torch.float64, device=dev)
    if M == 0:
        return (Cd if unrounded else C), ll
    _launch(s_flat, cidx, lens, q, Cd, torch.empty((M, N), dtype=torch.float32, device=dev),
            C, ll)
    return (Cd if unrounded else C), ll


em_counts_multi.launches = 0


def em_pass(s_flat: torch.Tensor, cidx: torch.Tensor, lens: torch.Tensor, q: torch.Tensor,
            Cd: torch.Tensor, logz: torch.Tensor, activity: tuple | None = None) -> None:
    """B1's data pass alone, as the EM loop's body runs it before
    ``cuda_update.em_update``: adds the counts into ``Cd`` (f64 [M, R+1,
    W], zero on entry) and writes ``logz`` (f32 [M, N], each sequence's log
    marginal), with ``em_counts_multi``'s arguments, plan and launches
    (counted in ``em_counts_multi.launches``), and neither rounds the
    counts nor sums ll.

    ``activity``: the loop state (running bool [], vds f32 [M], eps f32
    []) that ``em_update`` steps the seeds by.  The pass then serves only
    the seeds active at this iteration (running and vds >= eps, read on
    the device), dealing each launch's blocks to them; a frozen seed's
    ``Cd`` and ``logz`` rows are left as they are.  None serves every
    seed."""
    _check(s_flat, cidx, lens, q)
    M, R1, W = s_flat.shape
    N = cidx.shape[1]
    tensors = [("Cd", Cd, torch.float64, (M, R1, W)), ("logz", logz, torch.float32, (M, N))]
    if activity is not None:
        running, vds, eps = activity
        tensors += [("running", running, torch.bool, ()), ("vds", vds, torch.float32, (M,)),
                    ("eps", eps, torch.float32, ())]
    for name, t, dtype, shape in tensors:
        if t.device != cidx.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)} on "
                             f"{cidx.device}, got {t.dtype} {list(t.shape)} on {t.device}")
    if M:
        _launch(s_flat, cidx, lens, q, Cd, logz, None, None, activity)


def _launch(s_flat, cidx, lens, q, Cd, logz, C, ll, activity=None) -> None:
    """``em_counts_launch`` for each of ``seed_launches``' ranges in turn on
    the current stream; C and ll None run the pass alone; ``activity``
    (running, vds, eps) deals each launch's blocks to its active seeds."""
    M, R1, W = s_flat.shape
    S, N, L = cidx.shape
    dev = cidx.device
    plan = launch_plan(M, R1, W, S, L)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for m0, m1 in seed_launches(plan, M):
            running, vds, eps = (None, None, None) if activity is None else (
                activity[0].data_ptr(), activity[1][m0:].data_ptr(), activity[2].data_ptr())
            err = lib.em_counts_launch(
                cidx.data_ptr(), lens.data_ptr(), s_flat[m0].data_ptr(), q[m0:].data_ptr(),
                None if C is None else C[m0].data_ptr(), Cd[m0].data_ptr(),
                logz[m0].data_ptr(), None if ll is None else ll[m0:].data_ptr(), running, vds,
                eps, S, N, L, W, R1, m1 - m0, plan.seeds_per_block, int(plan.smem_lut),
                plan.counts, plan.team, plan.codes_cap, stream,
            )
            if err != 0:
                raise RuntimeError(
                    f"em_counts launch failed: {lib.em_counts_error_string(err).decode()}"
                )
            em_counts_multi.launches += 1


def em_counts_multi_ref(s_flat: torch.Tensor, cidx: torch.Tensor, lens: torch.Tensor,
                        q: torch.Tensor, unrounded: bool = False) -> tuple:
    """The plain PyTorch version of ``em_counts_multi`` (escore ops, one seed
    at a time); same arguments and results, on any device."""
    M, R1, W = s_flat.shape
    Cs, lls = [], []
    for m in range(M):
        scores, mask = escore.window_scores(s_flat[m], cidx, lens, W)
        r, _r0, ll = escore.zoops_posterior(scores, mask, q[m])
        Cs.append(escore.mstep_counts_f64(r, cidx, R1 - 1, W))
        lls.append(ll)
    C = torch.stack(Cs)
    return (C if unrounded else C.to(s_flat.dtype)), torch.stack(lls)
