"""What sets the pace of a kernel: variants of its source, or of its launch
plan, timed on one GPU.

    python -m bammmotif2_tpu_torch.tools.kernel_variants SOURCE_ROOT --design D [--M 1 4]
        [--K 0 1 2] [--W 12] [--chunks-from 16] [--homopolymer] [--tag T]
    python -m bammmotif2_tpu_torch.tools.kernel_variants summarize FILE...

SOURCE_ROOT is the root of a checkout whose ``csrc/`` holds the design D
names.  The tool writes copies of that source beside its ``common.cuh`` in a
scratch directory, with its other headers (``em.cuh``, ``scores.cuh``,
``counts.cuh``, which hold the passes) written into it,
edited by exact string replacement (each edit must apply once), builds each
with ``ops/_build.NVCC_FLAGS`` (one nvcc each, all started together), loads
it with ctypes and times it on the card.  The variants that drop or fake
work give wrong results and are only timed.

``em_pr5``: the one-pass E+M kernel of PR 5, with this checkout's
``cuda_em.launch_plan`` (at K=2, fixed-point shared counts):
  as_is        the source unchanged;
  no_scatter   the scatter of r into the counts removed;
  no_carry     a count add is one 32-bit atomic, without the returned old
               word and the carry;
  plain_add    a count add is a plain read-add-write (racy).

``em_plans``: the E+M source unchanged, launched with other plans than
``cuda_em.launch_plan``'s (every one that fits ``cuda_em.SMEM_MAX``).
With ``--K``: on bench's set (10k x 200 bp, S=2) at each K, W (``--W``)
and M, launch_plan's team and tables at every seeds a block
(``seed_caps``; the kernel splits a launch's seeds over grid y in
balanced chunks).  Without it, the cases of ``PLAN_CASES``: at K=2 and
K=4 the LUT in shared memory or through L1, float, fixed-point or global
counts, and at M=4 the seeds a block; at K=2, M=1 and rows of 200 to
1,600 bp (N * L held at 2M codes a strand) a warp against a block a
sequence.

``scores_plans``: the window-score source unchanged on ``--rows`` x 200
bp (S=2, W=12; config 5's geometry at 100k, kernel_inputs' planted set)
at each K and M, at every seeds a block, the LUT in shared memory (where
it fits) and (unless ``--lut smem``) through L1.

``counts_plans``: the counts-from-r source unchanged on bench's geometry
with the sampler's 0/1 r (``counts_inputs``) at each K and M.

The three plan designs also time, from M = ``--chunks-from`` on, the M
seeds as consecutive balanced launches (``cuda_em.seed_chunks``) of the
fastest variant's seeds a block and of 4, 8 and 16 seeds (counts: 1, 4,
8, 16), and hold every variant's result to the plain version (E+M within
tests/test_torch_cuda.py's bars, scores bit-equal, 0/1 counts equal).  A
variant's times: its kernel's device µs a call (all its launches) and
every device operation's (``ab.device_ms``), and the call's µs by CUDA
events, in two rounds.

``fdr_rows``: one FDR fold's E+M pass at BASELINE config 4's groups
(10k x 200 bp, K=2, W=8/10/12 with 4/3/3 seeds, ``FDR_GROUPS``) on all
rows with the held-out fifth at length 0 against the training rows
compacted.

``summarize FILE...`` merges the JSON of several processes' plan sweeps:
per case and variant the median device and events µs, each process's
median (the spread), the fastest variant and launch_plan's against it.

``scores_pr5``: the window-score kernel of PR 5, with this checkout's
``cuda_scores.launch_plan``:
  as_is          the source unchanged;
  generic_width  no kernel specialised to a width (the sliding loop only);
  stages3        three bulk-copy buffers (two items in flight);
  rows2048       items of 2,048 codes;
  rows2048_stages4  and four buffers;
  no_store       the full runs' float4 scores are not stored;
  no_mask        the mask is not written.

``cgs_draws``: the CGS sweep's draw kernels (``csrc/jax_draws.cu`` over
``threefry.cuh``), on cgs_z at M=1, 4 and 10 and cgs_beta at M=1 and 16
(``sweep_draws``); every variant gives the plain versions' draws:
  as_is          the source unchanged;
  z_elems1, z_elems2, z_elems8  1, 2 or 8 elements a lane in flight in
                 cgs_z, not 4;
  z_min_blocks6  cgs_z's registers capped for 6 resident blocks an SM;
  rotl_funnel    the Threefry rotate as a funnel shift, not two shifts and
                 an or;
  beta_spec1, beta_spec4  1 or 4 lanes a gamma (attempts in flight), not 2.

``counts_stream``: the streaming counts-from-r kernel (B3, with
``cuda_counts.launch_plan``), on the sampler's 0/1 r; beside the variants,
``torch.sum`` of the same r, a read of the same bytes by PyTorch:
  as_is        the source unchanged;
  stream_only  nothing queued and no cross-block sum: the read alone;
  no_tail      no flush, ticket or last-block conversion;
  ldg          r read through __ldg instead of __ldcs (evict-first);
  unroll1, unroll2, unroll8  1, 2 or 8 16-byte loads in flight a thread (not 4);
  min_blocks6, min_blocks8  registers capped for 6 or 8 resident blocks an SM;
  grid_x4, grid_half, grid_quarter  4x, 1/2 or 1/4 of the resident blocks;
  drain_every_chunk  a warp drains its queue after every chunk that queued a value;
  global_acc   no shared-memory table: every count an f64 atomic on acc.

The source-edit designs run on bench.py's geometry (10k x 200 bp, S=2,
W=12, K=2; tests/test_torch_cuda.py's ``kernel_inputs``, with
``--homopolymer`` on rows of one base), the scores design on BASELINE
config 5's (100k x 200 bp, ``chip_smoke.c5_inputs``; ``--rows`` keeps its
first rows), at each M given.  A variant's device time is its
``__global__``'s under ``torch.profiler`` over 10 calls after a warm-up,
in two rounds: in the order listed, then reversed.  The card's name and
power limit and a JSON summary are printed and written to
``chiprun_out/kernel_variants_<design>[_homopolymer][_rows][_tag].json``.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from bammmotif2_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PR5_CARRY = """const unsigned xl = (unsigned)x, old = atomicAdd(lo, xl);
    const unsigned hi = (unsigned)(x >> 32) + (old + xl < old ? 1u : 0u);
    if (hi) atomicAdd(lo + table_floats, hi);"""

_STAGES = "constexpr int kStages = 2;"
_ROWS_CAP = "auto kern = KernelWidths::kernel(W, smem_lut != 0, pick);"
_Z_ELEMS = "constexpr int kZElems = 4;"
_BETA_SPEC = "constexpr int kBetaSpec = 2;"

DESIGNS = {  # design -> (source, __global__, {variant: edits})
    "em_pr5": ("em_counts", "em_counts_kernel", {
        "as_is": [],
        "no_scatter": [("  const int first = kTeam == 32 ? 0 : (threadIdx.x >> 5) * 32;\n",
                        "  const int first = kTeam == 32 ? 0 : (threadIdx.x >> 5) * 32;\n"
                        "  return;\n")],
        "no_carry": [(_PR5_CARRY, "atomicAdd(lo, (unsigned)x);")],
        "plain_add": [(_PR5_CARRY, "*lo += (unsigned)x;")],
    }),
    "scores_pr5": ("window_scores", "window_scores_kernel", {
        "as_is": [],
        "generic_width": [("using KernelWidths = Widths<6, 8, 10, 12, 14, 16, 18, 20, 24, 30>;",
                           "using KernelWidths = Widths<>;")],
        "stages3": [(_STAGES, "constexpr int kStages = 3;")],
        "rows2048": [(_ROWS_CAP, "rows_cap = 2048;\n  " + _ROWS_CAP)],
        "rows2048_stages4": [(_STAGES, "constexpr int kStages = 4;"),
                             (_ROWS_CAP, "rows_cap = 2048;\n  " + _ROWS_CAP)],
        "no_store": [("*reinterpret_cast<float4*>(orow + i) = v;",
                      "if (v.x == 1.2345f) *reinterpret_cast<float4*>(orow + i) = v;")],
        "no_mask": [("const bool mask_here = write_mask && it.s == 0 && m == m0;",
                     "const bool mask_here = false;")],
    }),
    "em_plans": ("em_counts", "em_counts_kernel", {"as_is": []}),
    "scores_plans": ("window_scores", "window_scores_kernel", {"as_is": []}),
    "counts_plans": ("counts_from_r", "counts_kernel", {"as_is": []}),
    "fdr_rows": ("em_counts", "em_counts_kernel", {"as_is": []}),
    "cgs_draws": ("jax_draws", "cgs_z_kernel", {
        "as_is": [],
        "z_elems1": [(_Z_ELEMS, "constexpr int kZElems = 1;")],
        "z_elems2": [(_Z_ELEMS, "constexpr int kZElems = 2;")],
        "z_elems8": [(_Z_ELEMS, "constexpr int kZElems = 8;")],
        "z_min_blocks6": [("__launch_bounds__(kThreads)\ncgs_z_kernel(",
                           "__launch_bounds__(kThreads, 6)\ncgs_z_kernel(")],
        "rotl_funnel": [("return (x << r) | (x >> (32 - r));", "return __funnelshift_l(x, x, r);")],
        "beta_spec1": [(_BETA_SPEC, "constexpr int kBetaSpec = 1;")],
        "beta_spec4": [(_BETA_SPEC, "constexpr int kBetaSpec = 4;")],
    }),
    "counts_stream": ("counts_from_r", "counts_kernel", {
        "as_is": [],
        "stream_only": [("    bool keep = x != 0.f;", "    bool keep = false;"),
                        ("  if (Cs != nullptr) flush_counts(Cs, acc, RW);",
                         "  return;\n  if (Cs != nullptr) flush_counts(Cs, acc, RW);")],
        "no_tail": [("  if (Cs != nullptr) flush_counts(Cs, acc, RW);",
                     "  return;\n  if (Cs != nullptr) flush_counts(Cs, acc, RW);")],
        "ldg": [("__ldcs(rb + k)", "__ldg(rb + k)")],
        "unroll1": [("constexpr int kCountsUnroll = 4;", "constexpr int kCountsUnroll = 1;")],
        "unroll2": [("constexpr int kCountsUnroll = 4;", "constexpr int kCountsUnroll = 2;")],
        "unroll8": [("constexpr int kCountsUnroll = 4;", "constexpr int kCountsUnroll = 8;")],
        "min_blocks6": [("__launch_bounds__(kThreads)\ncounts_kernel(",
                         "__launch_bounds__(kThreads, 6)\ncounts_kernel(")],
        "min_blocks8": [("__launch_bounds__(kThreads)\ncounts_kernel(",
                         "__launch_bounds__(kThreads, 8)\ncounts_kernel(")],
        "grid_x4": [("counts_grid(resident, M, plane)", "counts_grid(4 * resident, M, plane)")],
        "grid_half": [("counts_grid(resident, M, plane)", "counts_grid(resident / 2, M, plane)")],
        "grid_quarter": [("counts_grid(resident, M, plane)",
                          "counts_grid(resident / 4, M, plane)")],
        "drain_every_chunk": [("constexpr int kWarpDrainAt = 128;",
                               "constexpr int kWarpDrainAt = 0;")],
        "global_acc": [("  const size_t smem = smem_counts ? sizeof(float) * (size_t)R1 * W : 0;",
                        "  smem_counts = 0;\n  const size_t smem = 0;")],
    }),
}

# em_plans: case -> kernel_inputs options (S=2)
PLAN_CASES = {
    "K2_M1": dict(N=10_000, L=200, W=12, K=2, M=1),
    "K2_M4": dict(N=10_000, L=200, W=12, K=2, M=4),
    "K4_M1": dict(N=10_000, L=200, W=12, K=4, M=1),
    "K4_M4": dict(N=10_000, L=200, W=12, K=4, M=4),
    "K4_W30_M1": dict(N=10_000, L=200, W=30, K=4, M=1),
    **{f"K2_M1_L{L}": dict(N=2_000_000 // L, L=L, W=12, K=2, M=1)
       for L in (300, 400, 512, 800, 1_200, 1_600)},
}


def seed_caps(M: int) -> list:
    """The seeds a block (or a launch) that split M seeds differently in
    balanced chunks: ceil(M / n) for n = 1..M, largest first."""
    return sorted({-(-M // n) for n in range(1, M + 1)}, reverse=True)


def variant_source(src: str, edits: list) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit does not apply once: {old!r}")
        src = src.replace(old, new)
    return src


def inline_headers(src: str, csrc: str) -> str:
    """``src`` with each ``#include "X.cuh"`` but common.cuh's replaced by
    that header's text, so that edits reach a kernel's device routines."""
    for name in sorted(os.listdir(csrc)):
        inc = f'#include "{name}"'
        if name.endswith(".cuh") and name != "common.cuh" and inc in src:
            with open(os.path.join(csrc, name)) as fh:
                src = src.replace(inc, fh.read().replace("#pragma once\n", ""))
    return src


def build(source_root: str, out_dir: str, source: str, variants: dict) -> dict:
    """name -> path of the built library of each variant."""
    csrc = os.path.join(source_root, "bammmotif2_tpu_torch", "csrc")
    with open(os.path.join(csrc, f"{source}.cu")) as fh:
        src = inline_headers(fh.read(), csrc)
    with open(os.path.join(csrc, "common.cuh")) as fh:
        common = fh.read()
    with open(os.path.join(out_dir, "common.cuh"), "w") as fh:
        fh.write(common)
    jobs = {}
    for name, edits in variants.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(variant_source(src, edits))
        jobs[name] = (cu, os.path.join(out_dir, f"lib{name}.so"))

    def nvcc(item):
        name, (cu, so) = item
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
        return name, so

    with ThreadPoolExecutor(len(jobs)) as ex:
        return dict(ex.map(nvcc, jobs.items()))


def em_caller(lib_path: str, args: tuple, plan, launches=None):
    """A call of the library's em_counts_launch on args = (s_flat, cidx,
    lens, q) with ``plan`` (a ``cuda_em.Plan``): a launch a (m0, m1) range
    of ``launches`` in turn on the stream (each at the plan's seeds a block,
    capped at its range's; by default ``cuda_em.seed_launches``, as
    ``em_counts_multi`` launches).  Returns (C, ll)."""
    import torch

    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.em_counts_launch.argtypes = [p] * 11 + [i] * 11 + [p]
    lib.em_counts_launch.restype = i
    s_flat, cidx, lens, q = args
    M, R1, W = s_flat.shape
    S, N, L = cidx.shape
    dev = cidx.device
    from bammmotif2_tpu_torch.ops import cuda_em

    ranges = launches or cuda_em.seed_launches(plan, M)

    def call():
        C = torch.zeros((M, R1, W), dtype=torch.float32, device=dev)
        ll = torch.zeros((M,), dtype=torch.float32, device=dev)
        Cd = torch.zeros((M, R1, W), dtype=torch.float64, device=dev)
        logz = torch.empty((M, N), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for m0, m1 in ranges:
            err = lib.em_counts_launch(
                cidx.data_ptr(), lens.data_ptr(), s_flat[m0].data_ptr(), q[m0:].data_ptr(),
                C[m0].data_ptr(), Cd[m0].data_ptr(), logz[m0].data_ptr(), ll[m0:].data_ptr(),
                None, None, None, S, N, L, W, R1, m1 - m0, min(plan.seeds_per_block, m1 - m0),
                int(plan.smem_lut), plan.counts, plan.team, plan.codes_cap, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: {err}")
        return C, ll

    return call


def plan_tag(plan) -> str:
    return (f"{'warp' if plan.team == 32 else 'block'}_spb{plan.seeds_per_block}"
            f"_lut_{'smem' if plan.smem_lut else 'l1'}"
            f"_counts_{['global', 'float', 'fixed'][plan.counts]}")


def alternative_plans(M: int, R1: int, W: int, S: int, L: int, teams_only: bool,
                      spb_only: bool = False) -> dict:
    """tag -> plan: launch_plan's (tagged ``plan:...``) and each other
    choice of team, LUT place, counts kind and (M > 1) seeds a block
    (``seed_caps``: every cap that splits the M seeds differently,
    in balanced chunks) that fits SMEM_MAX; with ``teams_only``, launch_plan's
    tables and seeds a block with either team; with ``spb_only``,
    launch_plan's team and tables with every seeds a block that fits."""
    from bammmotif2_tpu_torch.ops import cuda_em

    base = cuda_em.launch_plan(M, R1, W, S, L)
    tables = ((False, False, False), (False, True, False), (False, True, True),
              (True, True, False), (True, True, True))
    teams = ((32, cuda_em._round4(S * L)), (256, max(cuda_em.BLOCK_CODES, W)))
    if teams_only or spb_only:
        tables = ((base.smem_lut, base.smem_counts, base.fixed_counts),)
    if spb_only:
        teams = ((base.team, base.codes_cap),)
    out = {}
    for team, cap in teams:
        for lut, counts, fixed in tables:
            spbs = ({base.seeds_per_block} if teams_only else
                    set(seed_caps(M)) if counts else {1})
            for spb in sorted(spbs):
                plan = cuda_em.Plan(spb, lut, counts, fixed, team, cap)
                if cuda_em.smem_bytes(plan, R1, W) <= cuda_em.SMEM_MAX:
                    out[("plan:" if plan == base else "") + plan_tag(plan)] = plan
    return out


def scores_caller(lib_path: str, args: tuple, spb: int, smem_lut: bool, launches=None):
    """A call of the library's window_scores_launch on args = (s_flat,
    cidx, lens) at ``spb`` seeds a block, the LUT in shared memory or
    through L1: one launch of all M seeds, or one a (m0, m1) range of
    ``launches`` in turn (each at ``spb`` capped at its range's; every
    launch writes the mask).  Returns (scores, mask)."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_scores

    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.window_scores_launch.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.window_scores_launch.restype = i
    s_flat, cidx, lens = args
    M, R1, W = s_flat.shape
    S, N, L = cidx.shape
    ranges = launches or [(0, M)]

    def call():
        scores = torch.empty((M, S, N, L - W + 1), dtype=torch.float32, device=cidx.device)
        mask = torch.empty((N, L - W + 1), dtype=torch.bool, device=cidx.device)
        stream = torch.cuda.current_stream(cidx.device).cuda_stream
        for m0, m1 in ranges:
            err = lib.window_scores_launch(
                cidx.data_ptr(), lens.data_ptr(), s_flat[m0].data_ptr(), scores[m0].data_ptr(),
                mask.data_ptr(), S, N, L, W, R1, m1 - m0, min(spb, m1 - m0), int(smem_lut),
                cuda_scores.ROWS_CAP, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: {err}")
        return scores, mask

    return call


def counts_caller(lib_path: str, args: tuple, launches=None):
    """A call of the library's counts_from_r_launch on args = (r, cidx, R,
    W), with cuda_counts.launch_plan's plan and a zeroed workspace of its
    own (each launch leaves it zero): one launch of all M seeds, or one a
    (m0, m1) range of ``launches`` in turn.  Returns C."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_counts

    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.counts_from_r_launch.argtypes = [p] * 5 + [ctypes.c_longlong] + [i] * 6 + [p]
    lib.counts_from_r_launch.restype = i
    r, cidx, R, W = args
    M, (S, N, L), R1 = r.shape[0], cidx.shape, R + 1
    dev = cidx.device
    C = torch.empty((M, R1, W), dtype=torch.float32, device=dev)
    acc = torch.zeros(M * R1 * W, dtype=torch.float64, device=dev)
    tickets = torch.zeros(M, dtype=torch.int32, device=dev)
    ranges = launches or [(0, M)]

    def call():
        stream = torch.cuda.current_stream(dev).cuda_stream
        for m0, m1 in ranges:
            err = lib.counts_from_r_launch(
                r[m0].data_ptr(), cidx.data_ptr(), C[m0].data_ptr(), acc.data_ptr(),
                tickets.data_ptr(), S * N * L, L, W, R1, m1 - m0,
                int(cuda_counts.launch_plan(R1, W)), dev.index, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: {err}")
        return C

    return call


def device_us(fn, kernel: str, n: int = 10) -> float:
    """Mean device microseconds of ``kernel`` per call under torch.profiler
    (``ab.device_ms``, which keeps only windows that traced every call)."""
    from bammmotif2_tpu_torch.tools.ab import device_ms

    ms = device_ms(fn, n, kernel)["kernel_device_ms"]
    if not isinstance(ms, float):
        raise RuntimeError(f"no profiler window traced {kernel} {n} times")
    return ms * 1e3


def timed(fn, kernel: str, per_call: int = 1) -> dict:
    """A plan's times: ``kernel``'s device µs a call summed over its
    ``per_call`` launches and every device operation's (``ab.device_ms``,
    10 calls; "not measured" where no whole window was traced), and the
    call's µs by CUDA events over 10 back-to-back calls (gaps between
    launches included)."""
    import chip_smoke
    from bammmotif2_tpu_torch.tools.ab import device_ms

    d = device_ms(fn, 10, kernel, per_call=per_call)
    us = {k: v * 1e3 if isinstance(v, float) else v for k, v in d.items()}
    return {"device_us": us["kernel_device_ms"], "call_device_us": us["call_device_ms"],
            "events_us": chip_smoke.time_cuda(fn, 10) * 1e3}


def em_error(got: tuple, ref: tuple, checks) -> float:
    """max |dC| / (C_ATOL + C_RTOL |C|) and ll's relative error over
    LL_RTOL, the larger (tests/test_torch_cuda.py's bars: at most 1)."""
    (C, ll), (C_ref, ll_ref) = got, ref
    dc = ((C - C_ref).abs() / (checks.C_ATOL + checks.C_RTOL * C_ref.abs())).max().item()
    dl = ((ll - ll_ref).abs() / ll_ref.abs()).max().item() / checks.LL_RTOL
    return max(dc, dl)


def median(xs: list) -> float:
    xs = sorted(x for x in xs if isinstance(x, float))
    return xs[len(xs) // 2] if xs else float("inf")


def run_variants(calls: dict, kernel: str, check) -> dict:
    """tag -> times of each (call, launches a call) of ``calls`` in two
    rounds (in order, then reversed) and ``check``'s error of its first
    output (a plan that gives a wrong result stops the sweep)."""
    import torch

    runs = {t: {"launches": n, "error": check(fn())} for t, (fn, n) in calls.items()}
    for t, r in runs.items():
        if r["error"] > 1.0:
            raise AssertionError(f"{t}: error {r['error']} over its bar")
    torch.cuda.synchronize()
    names = list(calls)
    for order in (names, names[::-1]):
        for t in order:
            for k, v in timed(calls[t][0], kernel, calls[t][1]).items():
                runs[t].setdefault(k, []).append(v)
    return runs


def chunk_calls(runs: dict, M: int, make, caps=(4, 8, 16)) -> dict:
    """Consecutive balanced launches (``cuda_em.seed_chunks``) of launch
    caps {the fastest variant's seeds a block} and ``caps`` below M, each
    launch at that variant's seeds a block (capped at its chunk's):
    ``make(spb, smem_lut, launches)`` -> a call.  ``runs``' tags name the
    seeds a block as ``spb<n>`` and the LUT as ``lut_l1`` where it is read
    through L1."""
    from bammmotif2_tpu_torch.ops import cuda_em

    best = min(runs, key=lambda t: median(runs[t]["device_us"]))
    spb = int(best.split("spb")[1].split("_")[0]) if "spb" in best else 1
    lut = "lut_l1" not in best
    out = {}
    for cap in sorted({spb, *caps}):
        if cap < M:
            launches = cuda_em.seed_chunks(M, cap)
            out[f"launches{len(launches)}_cap{cap}_from_{best.removeprefix('plan:')}"] = (
                make(min(spb, cap), lut, launches), len(launches))
    return out


def sweep_em(a, lib: str, checks, dev) -> dict:
    """em_plans: E+M under every plan of ``alternative_plans`` (launch_plan's
    team and tables, every seeds a block, where --K is given; PLAN_CASES
    else), and at M >= --chunks-from consecutive balanced launches."""
    import chip_smoke
    import torch

    from bammmotif2_tpu_torch.ops import cuda_em

    out = {}
    if a.K is None:
        groups = [(c, o, [o["M"]]) for c, o in PLAN_CASES.items()]
    else:
        groups = [(None, dict(N=10_000, L=200, W=W, K=K), a.M) for K in a.K for W in a.W]
    for case, opts, Ms in groups:
        full = checks.kernel_inputs(**{**opts, "M": max(Ms)}, S=2, device=dev,
                                    **({"homopolymer": True} if a.homopolymer else {}))
        ref_full = cuda_em.em_counts_multi_ref(*full)
        for M in Ms:
            args = (full[0][:M].contiguous(), full[1], full[2], full[3][:M].contiguous())
            ref = (ref_full[0][:M], ref_full[1][:M])
            _M, R1, W = args[0].shape
            S, _N, L = args[1].shape
            name = case or f"K{opts['K']}_W{W}_M{M}"
            plans = alternative_plans(M, R1, W, S, L, teams_only="_L" in name,
                                      spb_only=case is None)
            calls = {t: (em_caller(lib, args, pl), len(cuda_em.seed_launches(pl, M)))
                     for t, pl in plans.items()}
            check = lambda got: em_error(got, ref, checks)  # noqa: E731
            runs = run_variants(calls, "em_counts_kernel", check)
            if case is None and M >= a.chunks_from:
                base = cuda_em.launch_plan(M, R1, W, S, L)
                make = lambda spb, _lut, ln: em_caller(lib, args, base._replace(  # noqa: E731
                    seeds_per_block=spb), ln)
                runs.update(run_variants(chunk_calls(runs, M, make), "em_counts_kernel", check))
            out[name] = {"K": opts["K"], "W": W, "M": M,
                         **chip_smoke.em_bound(args[1], args[2], R1, W, M), "variants": runs}
            print(name, json.dumps(out[name]), flush=True)
        del full, ref_full
        torch.cuda.empty_cache()
    return out


def sweep_scores(a, lib: str, checks, dev) -> dict:
    """scores_plans: window scores on --rows x 200 bp at W=12 at every seeds
    a block with the LUT in shared memory (where it fits) and through L1,
    and at M >= --chunks-from consecutive balanced launches; every result
    bit-equal to the plain version."""
    import chip_smoke
    import torch

    from bammmotif2_tpu_torch.ops import cuda_em, cuda_scores

    out = {}
    for K in a.K or (2,):
        full = checks.kernel_inputs(N=a.rows, L=200, W=12, K=K, M=max(a.M), S=2, device=dev)[:3]
        ref_full = cuda_scores.window_scores_multi_ref(*full)
        for M in a.M:
            args = (full[0][:M].contiguous(), full[1], full[2])
            _M, R1, W = args[0].shape
            plan = cuda_scores.launch_plan(M, R1, W)

            def check(got, M=M):
                same = torch.equal(got[0], ref_full[0][:M]) and torch.equal(got[1], ref_full[1])
                return 0.0 if same else float("inf")

            calls = {}
            for lut in (True, False)[: 1 if a.lut == "smem" else 2]:
                for spb in seed_caps(M):
                    if lut and cuda_scores.smem_bytes(spb, True, R1, W) > cuda_em.SMEM_MAX:
                        continue
                    tag = f"spb{spb}_lut_{'smem' if lut else 'l1'}"
                    calls[("plan:" if (spb, lut) == plan else "") + tag] = (
                        scores_caller(lib, args, spb, lut), 1)
            runs = run_variants(calls, "window_scores_kernel", check)
            if M >= a.chunks_from:
                make = lambda spb, lut, ln: scores_caller(lib, args, spb, lut, ln)  # noqa: E731
                runs.update(run_variants(chunk_calls(runs, M, make), "window_scores_kernel",
                                         check))
            name = f"K{K}_M{M}"
            out[name] = {"K": K, "W": W, "M": M, "rows": a.rows,
                         **chip_smoke.scores_bound(args[1], args[2], R1, W, M), "variants": runs}
            print(name, json.dumps(out[name]), flush=True)
            del calls, runs
            torch.cuda.empty_cache()
        del full, ref_full
        torch.cuda.empty_cache()
    return out


def sweep_counts(a, lib: str, checks, dev) -> dict:
    """counts_plans: counts from the sampler's 0/1 r at bench's geometry in
    one launch and in consecutive balanced launches of 1, 4, 8 and 16
    seeds; every result equal to the plain version."""
    import chip_smoke
    import torch

    from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em

    out = {}
    for K in a.K or (2,):
        full = checks.counts_inputs(N=10_000, L=200, W=12, K=K, M=max(a.M), S=2, r="01",
                                    device=dev)
        ref_full = cuda_counts.counts_from_r_multi_ref(*full)
        for M in a.M:
            r, cidx, R, W = full[0][:M], *full[1:]
            args = (r, cidx, R, W)
            check = lambda got, M=M: 0.0 if torch.equal(got, ref_full[:M]) else float("inf")  # noqa: E731
            calls = {"plan:one_launch": (counts_caller(lib, args), 1)}
            for cap in (1, 4, 8, 16):
                if cap < M:
                    ln = cuda_em.seed_chunks(M, cap)
                    calls[f"launches{len(ln)}_cap{cap}"] = (counts_caller(lib, args, ln), len(ln))
            runs = run_variants(calls, "counts_kernel", check)
            name = f"K{K}_M{M}"
            out[name] = {"K": K, "W": W, "M": M, **chip_smoke.counts_bound(r, cidx, R + 1, W),
                         "variants": runs}
            print(name, json.dumps(out[name]), flush=True)
        del full, ref_full
        torch.cuda.empty_cache()
    return out


# fdr_rows: BASELINE config 4's (W, seeds) groups (chip_smoke.C4_MOTIFS,
# C4_SEEDS: seed s has motif s % 3's width) at K=2, --cvFold 5
FDR_GROUPS = ((8, 4), (10, 3), (12, 3))
FDR_FOLDS = 5


def sweep_fdr(a, lib: str, checks, dev) -> dict:
    """fdr_rows: one FDR fold's E+M pass at config 4's geometry (10k x 200
    bp, K=2) on all N rows with the held-out fifth at length 0 (``masked``,
    as evaluation/fdr.py runs it) against the training rows alone
    (``compacted``; at N = 10k every fold trains on 8,000 rows, so padding
    to the largest fold adds none).  The two give the same counts (a row
    of length 0 adds log(1-q) to ll, which the check takes out)."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_em

    out = {}
    for W, M in FDR_GROUPS:
        s_flat, cidx, lens, q = checks.kernel_inputs(N=10_000, L=200, W=W, K=2, M=M, S=2,
                                                     device=dev)
        train = torch.arange(lens.shape[0], device=dev) % FDR_FOLDS != 0
        masked = (s_flat, cidx, torch.where(train, lens, 0), q)
        compact = (s_flat, cidx[:, train].contiguous(), lens[train].contiguous(), q)
        n_out = int((~train).sum().item())
        ref = cuda_em.em_counts_multi_ref(*compact)
        check = lambda got, ref=ref: em_error(got, ref, checks)  # noqa: E731
        plan = cuda_em.launch_plan(M, s_flat.shape[1], W, 2, 200)
        masked_call = em_caller(lib, masked, plan)
        calls = {
            "masked": ((lambda f=masked_call, n=n_out, q=q: (
                lambda C, ll: (C, ll - n * torch.log1p(-q)))(*f())), 1),
            "compacted": (em_caller(lib, compact, plan), 1)}
        runs = run_variants(calls, "em_counts_kernel", check)
        out[f"W{W}_M{M}"] = {"W": W, "M": M, "K": 2, "plan": plan._asdict(), "variants": runs}
        print(f"W{W}_M{M}", json.dumps(out[f"W{W}_M{M}"]), flush=True)
    return out


def summarize(paths: list) -> dict:
    """The plan sweeps of several processes (their JSON files) merged: per
    case and variant the median of every round's device µs and events µs,
    each process's median device µs (their spread), the fastest variant
    and launch_plan's (``plan:``) against it."""
    runs = [json.load(open(p)) for p in paths]
    out = {"gpu": sorted({r["gpu"] for r in runs}), "processes": len(runs), "cases": {}}
    for case in runs[0]["cases"]:
        got = [r["cases"][case] for r in runs if case in r["cases"]]
        rows = {}
        for tag in got[0]["variants"]:
            per = [g["variants"][tag] for g in got if tag in g["variants"]]
            dev = [x for v in per for x in v["device_us"] if isinstance(x, float)]
            rows[tag] = {"device_us": median(dev),
                         "events_us": median([x for v in per for x in v["events_us"]]),
                         "process_device_us": [median(v["device_us"]) for v in per],
                         "launches": per[0]["launches"],
                         "max_error": max(v["error"] for v in per)}
        best = min(rows, key=lambda t: rows[t]["device_us"])
        plan = next((t for t in rows if t.startswith("plan:")), None)
        out["cases"][case] = {
            **{k: got[0][k] for k in ("K", "W", "M", "bound_ms") if k in got[0]},
            "best": best, "plan": plan,
            "plan_over_best": rows[plan]["device_us"] / rows[best]["device_us"] if plan else None,
            "variants": rows}
    return out


def draws_callers(lib_path: str):
    """(z, beta): calls of the library's cgs_z_launch(flat, keys) and
    cgs_beta_launch(a, b, keys, attempts=True) on fresh outputs (beta on a
    copy of the keys, so that every call draws the same numbers)."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_draws

    lib = cuda_draws.bind(ctypes.CDLL(lib_path))

    def z(flat, keys):
        M, N, C = flat.shape
        out = torch.empty((M, N), dtype=torch.int64, device=flat.device)
        err = lib.cgs_z_launch(flat.data_ptr(), keys.data_ptr(), out.data_ptr(), 0, N, C, M,
                               flat.device.index, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cgs_z launch failed: {err}")
        return out

    def beta(a, b, keys):
        M = a.shape[0]
        keys = keys.clone()
        q = torch.empty(M, device=a.device)
        n = torch.empty((M, 2), dtype=torch.int32, device=a.device)
        err = lib.cgs_beta_launch(a.data_ptr(), b.data_ptr(), keys.data_ptr(), q.data_ptr(),
                                  n.data_ptr(), 1, 1e-4, 1 - 1e-4, M, a.device.index,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cgs_beta launch failed: {err}")
        return q, n, keys

    return z, beta


def sweep_draws(libs: dict, dev) -> dict:
    """``cgs_draws``: each variant's cgs_z on bench's 10k rows of 379
    logits at M=1, 4 and 10, and cgs_beta at M=1 and 16 on the sampler's
    shapes (8,001 and 2,000) and at a = b = 1 (most rejections), held to
    the plain versions (z equal; q, attempts and keys equal) and timed
    (``timed``, two rounds: in order, then reversed)."""
    import numpy as np
    import torch

    from bammmotif2_tpu_torch.ops import cuda_draws

    C = 1 + 2 * (200 - 12 + 1)
    cases, ref = {}, {}
    for M in (1, 4, 10):
        flat = torch.randn((M, 10_000, C), generator=torch.Generator().manual_seed(M)).to(dev)
        keys = torch.as_tensor(np.random.default_rng(M).integers(0, 2 ** 32, (M, 2)), device=dev)
        cases[f"z_M{M}"] = ("z", (flat, keys))
        ref[f"z_M{M}"] = cuda_draws.cgs_z_ref(flat, keys)
    for M, a, b in ((1, 8_001.0, 2_000.0), (16, 8_001.0, 2_000.0), (16, 1.0, 1.0)):
        keys = torch.as_tensor(np.random.default_rng(M).integers(0, 2 ** 32, (M, 2)), device=dev)
        args = (torch.full((M,), a, device=dev), torch.full((M,), b, device=dev), keys)
        tag = f"beta_M{M}" + ("_a1_b1" if a == 1.0 else "")
        cases[tag] = ("beta", args)
        k = keys.clone()
        q, n = cuda_draws.cgs_beta_ref(*args[:2], k, 1e-4, 1 - 1e-4, attempts=True)
        ref[tag] = (q, n, k)
    out = {}
    callers = {name: draws_callers(path) for name, path in libs.items()}
    for tag, (which, args) in cases.items():
        calls = {name: (lambda c=c, which=which, args=args: c[which == "beta"](*args))
                 for name, c in callers.items()}
        for name, fn in calls.items():
            got, want = fn(), ref[tag]
            same = (torch.equal(got, want) if which == "z" else
                    torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                    and bool(((got[0] - want[0]).abs() <= 1e-6 * want[0].abs()).all()))
            if not same:
                raise AssertionError(f"{name} differs from the plain version at {tag}")
        kernel = "cgs_z_kernel" if which == "z" else "cgs_beta_kernel"
        runs = {name: {} for name in calls}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                for k, v in timed(calls[name], kernel).items():
                    runs[name].setdefault(k, []).append(v)
        out[tag] = runs
        print(tag, json.dumps(runs), flush=True)
    return out


SWEEPS = {"em_plans": sweep_em, "scores_plans": sweep_scores, "counts_plans": sweep_counts,
          "fdr_rows": sweep_fdr}


def main() -> int:
    if sys.argv[1:2] == ["summarize"]:
        print(json.dumps(summarize(sys.argv[2:]), indent=1))
        return 0
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("source_root")
    ap.add_argument("--design", choices=sorted(DESIGNS), required=True)
    ap.add_argument("--M", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--K", type=int, nargs="+", default=None,
                    help="plan sweeps: model orders (em_plans: with --W and --M, else PLAN_CASES)")
    ap.add_argument("--W", type=int, nargs="+", default=[12], help="em_plans: motif widths")
    ap.add_argument("--chunks-from", type=int, default=16,
                    help="plan sweeps: time consecutive balanced launches from this M on")
    ap.add_argument("--rows", type=int, default=100_000, help="scores designs: rows of the set")
    ap.add_argument("--lut", choices=("both", "smem"), default="both",
                    help="scores_plans: time the LUT through L1 too, or in shared memory only")
    ap.add_argument("--homopolymer", action="store_true",
                    help="E+M designs: rows of one base (kernel_inputs' homopolymer)")
    ap.add_argument("--tag", default="", help="suffix of the output file's name")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sys.path.insert(0, ROOT)
    import chip_smoke

    from bammmotif2_tpu_torch.ops import cuda_em, cuda_scores

    source, kernel, variants = DESIGNS[a.design]
    dev = torch.device("cuda")
    out = {"gpu": gpu, "design": a.design, "homopolymer": a.homopolymer, "device_us": {}}
    if source == "window_scores":
        out["rows"] = a.rows
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(os.path.abspath(a.source_root), tmp, source, variants)
        checks = chip_smoke.load_by_path("bamm_torch_cuda_checks", "tests/test_torch_cuda.py")
        if source == "jax_draws":
            out["cases"] = sweep_draws(libs, dev)
            cases = {}
        elif a.design in SWEEPS:
            out["cases"] = SWEEPS[a.design](a, libs["as_is"], checks, dev)
            cases = {}
        elif source == "window_scores":
            cidx, lens, base, _sset = chip_smoke.c5_inputs(dev, tmp)
            cidx, lens = cidx[:, : a.rows].contiguous(), lens[: a.rows].contiguous()
            cases = {f"M{M}": dict(M=M) for M in a.M}
        else:
            cases = {f"M{M}": dict(N=10_000, L=200, W=12, K=2, M=M) for M in a.M}
        for case, opts in cases.items():
            if source == "window_scores":
                args = (chip_smoke.c5_luts(base, opts["M"]), cidx, lens)
                spb, lut = cuda_scores.launch_plan(*args[0].shape)
                calls = {n: scores_caller(path, args, spb, lut) for n, path in libs.items()}
            elif source == "counts_from_r":
                args = checks.counts_inputs(S=2, device=dev, r="01", **opts)
                calls = {n: counts_caller(path, args) for n, path in libs.items()}
            else:
                args = checks.kernel_inputs(S=2, device=dev, **opts,
                                            **({"homopolymer": True} if a.homopolymer else {}))
                M, R1, W = args[0].shape
                S, _N, L = args[1].shape
                plan = cuda_em.launch_plan(M, R1, W, S, L)
                calls = {n: em_caller(path, args, plan) for n, path in libs.items()}
            names = list(calls)
            runs = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    runs[n].append(device_us(calls[n], kernel))
            if source == "counts_from_r":
                r = args[0]
                runs["torch_sum_reference"] = [device_us(lambda: r.sum(), "reduce_kernel")
                                               for _ in range(2)]
            out["device_us"][case] = runs
            print(case, json.dumps(runs), flush=True)
            del calls, args
            torch.cuda.empty_cache()
    line = json.dumps(out)
    print(gpu)
    print(line)
    os.makedirs("chiprun_out", exist_ok=True)
    tag = f"{a.design}{'_homopolymer' if a.homopolymer else ''}"
    tag += f"_{a.rows}" if source == "window_scores" else ""
    tag += f"_{a.tag}" if a.tag else ""
    with open(os.path.join("chiprun_out", f"kernel_variants_{tag}.json"), "w") as fh:
        fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
