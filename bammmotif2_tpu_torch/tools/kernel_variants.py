"""What sets the pace of a kernel: variants of its source, or of its launch
plan, timed on one GPU.

    python -m bammmotif2_tpu_torch.tools.kernel_variants SOURCE_ROOT --design D [--M 1 4]
        [--homopolymer]

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
``cuda_em.launch_plan``'s (every one that fits ``cuda_em.SMEM_MAX``), on
the cases of ``PLAN_CASES``: at K=2 and K=4 the LUT in shared memory or
through L1, float, fixed-point or global counts, and at M=4 the seeds a
block; at K=2, M=1 and rows of 200 to 1,600 bp (N * L held at 2M codes a
strand) a warp against a block a sequence.  ``--M`` and
``--homopolymer`` do not apply.

``scores_pr5``: the window-score kernel of PR 5, with this checkout's
``cuda_scores.launch_plan``:
  as_is          the source unchanged;
  generic_width  no kernel specialised to a width (the sliding loop only);
  stages3        three bulk-copy buffers (two items in flight);
  rows2048       items of 2,048 codes;
  rows2048_stages4  and four buffers;
  no_store       the full runs' float4 scores are not stored;
  no_mask        the mask is not written.

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

E+M designs run on bench.py's geometry (10k x 200 bp, S=2, W=12, K=2;
tests/test_torch_cuda.py's ``kernel_inputs``, with ``--homopolymer`` on rows
of one base), the scores design on BASELINE config 5's (100k x 200 bp,
``chip_smoke.c5_inputs``; ``--rows`` keeps its first rows), at each M
given.  A variant's device time is its ``__global__``'s under
``torch.profiler`` over 10 calls after a warm-up, in two rounds: in the
order listed, then reversed.  The card's name and power limit and a JSON
summary are printed and written to
``chiprun_out/kernel_variants_<design>[_homopolymer].json``.  Imports no JAX.
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


def em_caller(lib_path: str, args: tuple, plan):
    """One launch of the library's em_counts_launch on args = (s_flat,
    cidx, lens, q) with ``plan`` (a ``cuda_em.Plan``)."""
    import torch

    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.em_counts_launch.argtypes = [p] * 8 + [i] * 11 + [p]
    lib.em_counts_launch.restype = i
    s_flat, cidx, lens, q = args
    M, R1, W = s_flat.shape
    S, N, L = cidx.shape
    dev = cidx.device

    def call():
        C = torch.zeros((M, R1, W), dtype=torch.float32, device=dev)
        ll = torch.zeros((M,), dtype=torch.float32, device=dev)
        Cd = torch.zeros((M, R1, W), dtype=torch.float64, device=dev)
        logz = torch.empty((M, N), dtype=torch.float32, device=dev)
        err = lib.em_counts_launch(
            cidx.data_ptr(), lens.data_ptr(), s_flat.data_ptr(), q.data_ptr(), C.data_ptr(),
            Cd.data_ptr(), logz.data_ptr(), ll.data_ptr(), S, N, L, W, R1, M,
            plan.seeds_per_block, int(plan.smem_lut), plan.counts, plan.team, plan.codes_cap,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")

    return call


def plan_tag(plan) -> str:
    return (f"{'warp' if plan.team == 32 else 'block'}_spb{plan.seeds_per_block}"
            f"_lut_{'smem' if plan.smem_lut else 'l1'}"
            f"_counts_{['global', 'float', 'fixed'][plan.counts]}")


def alternative_plans(M: int, R1: int, W: int, S: int, L: int, teams_only: bool) -> dict:
    """tag -> plan: launch_plan's (tagged ``plan:...``) and each other
    choice of team, LUT place, counts kind and (M > 1) seeds a block that
    fits SMEM_MAX; with ``teams_only``, launch_plan's tables with either
    team."""
    from bammmotif2_tpu_torch.ops import cuda_em

    base = cuda_em.launch_plan(M, R1, W, S, L)
    tables = ((False, False, False), (False, True, False), (False, True, True),
              (True, True, False), (True, True, True))
    if teams_only:
        tables = ((base.smem_lut, base.smem_counts, base.fixed_counts),)
    out = {}
    for team, cap in ((32, cuda_em._round4(S * L)), (256, max(cuda_em.BLOCK_CODES, W))):
        for lut, counts, fixed in tables:
            spbs = {base.seeds_per_block} if teams_only else {1, M} if counts else {1}
            for spb in sorted(spbs):
                plan = cuda_em.Plan(spb, lut, counts, fixed, team, cap)
                if cuda_em.smem_bytes(plan, R1, W) <= cuda_em.SMEM_MAX:
                    out[("plan:" if plan == base else "") + plan_tag(plan)] = plan
    return out


def scores_caller(lib_path: str, args: tuple):
    """One launch of the library's window_scores_launch on args = (s_flat,
    cidx, lens), with cuda_scores.launch_plan's plan."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_scores

    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.window_scores_launch.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.window_scores_launch.restype = i
    s_flat, cidx, lens = args
    M, R1, W = s_flat.shape
    S, N, L = cidx.shape
    spb, smem_lut = cuda_scores.launch_plan(M, R1, W)
    scores = torch.empty((M, S, N, L - W + 1), dtype=torch.float32, device=cidx.device)
    mask = torch.empty((N, L - W + 1), dtype=torch.bool, device=cidx.device)

    def call():
        err = lib.window_scores_launch(
            cidx.data_ptr(), lens.data_ptr(), s_flat.data_ptr(), scores.data_ptr(),
            mask.data_ptr(), S, N, L, W, R1, M, spb, int(smem_lut), cuda_scores.ROWS_CAP,
            torch.cuda.current_stream(cidx.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")

    return call


def counts_caller(lib_path: str, args: tuple):
    """One launch of the library's counts_from_r_launch on args = (r, cidx,
    R, W), with cuda_counts.launch_plan's plan and a zeroed workspace of its
    own."""
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

    def call():
        err = lib.counts_from_r_launch(
            r.data_ptr(), cidx.data_ptr(), C.data_ptr(), acc.data_ptr(), tickets.data_ptr(),
            S * N * L, L, W, R1, M, int(cuda_counts.launch_plan(R1, W)), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")

    return call


def device_us(fn, kernel: str, n: int = 10) -> float:
    """Mean device microseconds of ``kernel`` per call under torch.profiler
    (``ab.device_ms``, which keeps only windows that traced every call)."""
    from bammmotif2_tpu_torch.tools.ab import device_ms

    ms = device_ms(fn, n, kernel)["kernel_device_ms"]
    if not isinstance(ms, float):
        raise RuntimeError(f"no profiler window traced {kernel} {n} times")
    return ms * 1e3


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("source_root")
    ap.add_argument("--design", choices=sorted(DESIGNS), required=True)
    ap.add_argument("--M", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--rows", type=int, default=100_000, help="scores designs: rows of the set")
    ap.add_argument("--homopolymer", action="store_true",
                    help="E+M designs: rows of one base (kernel_inputs' homopolymer)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sys.path.insert(0, ROOT)
    import chip_smoke

    from bammmotif2_tpu_torch.ops import cuda_em

    source, kernel, variants = DESIGNS[a.design]
    dev = torch.device("cuda")
    out = {"gpu": gpu, "design": a.design, "homopolymer": a.homopolymer, "device_us": {}}
    if source == "window_scores":
        out["rows"] = a.rows
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(os.path.abspath(a.source_root), tmp, source, variants)
        if source == "window_scores":
            cidx, lens, base, _sset = chip_smoke.c5_inputs(dev, tmp)
            cidx, lens = cidx[:, : a.rows].contiguous(), lens[: a.rows].contiguous()
        checks = chip_smoke.load_by_path("bamm_torch_cuda_checks", "tests/test_torch_cuda.py")
        cases = PLAN_CASES if a.design == "em_plans" else {
            f"M{M}": dict(N=10_000, L=200, W=12, K=2, M=M) for M in a.M}
        for case, opts in cases.items():
            if source == "window_scores":
                args = (chip_smoke.c5_luts(base, opts["M"]), cidx, lens)
                calls = {n: scores_caller(path, args) for n, path in libs.items()}
            elif source == "counts_from_r":
                args = checks.counts_inputs(S=2, device=dev, r="01", **opts)
                calls = {n: counts_caller(path, args) for n, path in libs.items()}
            else:
                args = checks.kernel_inputs(S=2, device=dev, **opts,
                                            **({"homopolymer": True} if a.homopolymer else {}))
                M, R1, W = args[0].shape
                S, _N, L = args[1].shape
                if a.design == "em_plans":
                    plans = alternative_plans(M, R1, W, S, L, teams_only="_L" in case)
                    calls = {t: em_caller(libs["as_is"], args, pl) for t, pl in plans.items()}
                else:
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
    with open(os.path.join("chiprun_out", f"kernel_variants_{tag}.json"), "w") as fh:
        fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
