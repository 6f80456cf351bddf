#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bammmotif2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   : nvcc builds csrc/em_counts.cu, csrc/window_scores.cu,
               csrc/counts_from_r.cu, csrc/flat.cu, csrc/while_loop.cu and
               csrc/jax_draws.cu in parallel; prints
               the toolchain, the card, the CUDA
               driver's and runtime's versions (a WHILE graph node needs
               12.3) and the ptxas resource reports.
  2. kernel  : each of the six kernels against its plain PyTorch version on
               the card at the main paths' geometries, seed stacks of 16,
               32 and 33 at K=0 and K=2 among them (tests/test_torch_cuda.py:
               KERNEL_CASES / check_kernel, SCORE_CASES / check_scores,
               COUNTS_CASES / check_counts, FLAT_CASES / check_flat; the
               last also holds the flat kernels to the combined-layout ones
               on the same sequences), check_counts_calls: each
               counts-from-r call is one kernel, its workspace cleans
               itself across calls, shapes and streams, and a CUDA graph
               of a call replays right; and check_flat_calls: a flat
               window-score call is one kernel, a flat E+M call enqueues no
               more than the combined one and no gather or fold;
               check_condition: the loops' stop-test kernel
               (ops/cuda_while.py) against its plain version on edge
               inputs (the cap reached, every seed frozen, NaN); the draw
               kernels of the reference's jax.random streams
               (ops/cuda_draws.py, tests/test_torch_draws.py):
               markov_codes bit-equal to markov_codes_ref at sOrder 0-5
               (check_markov), cgs_z bit-equal to cgs_z_ref on
               Z_CASES: M=16, 10k rows of 379 logits at two row offsets,
               M=1, C = 1, 31 and 33, N off a block's rows, the last rows
               of fold_in's 32 bits, rows of NEG_INF, -inf, NaN and +inf
               (check_z), cgs_beta against cgs_beta_ref on 2 x 10^5 (a, b)
               pairs and on BETA_SMALL's shapes, the same attempts, q
               within rtol 1e-6, the same advanced keys, and some gamma
               past the kernel's lanes a gamma (check_beta); the kernels'
               draws against the CPU's plain
               versions, which tests/test_torch_threefry.py holds to
               jax.random (check_draws_against_cpu); and check_loops: the EM loop
               and the CGS sweeps each as one launch of a WHILE-node graph
               (refinement/graphs.py) against their eager loops (CGS bit
               for bit, also at 1 and 2 sweeps; EM within the bars: at a
               fixed budget, converged, stopped by its warm-up iteration,
               and a cached loop graph launched with another cap and ll0),
               no host read in the graphed loops against one a chunk of
               multi.SYNC_EVERY iterations in the eager EM loop, B1-B3,
               the draw kernels and the stop-test kernel counted once an
               iteration or sweep (each wrapper's launches a call), a
               capture that fails raises, and the same at a 33-seed stack
               (check_chunked_loops).
  3. slice   : every path through the CLI, once through the kernels and once
               under --no-pallas, with every kernel's launch count set to 0
               just before each run and read just after; the EM and CGS
               loops of both run as replayed CUDA graphs, each run starting
               with an empty graph cache (its captures are reported); the
               CGS draw kernels and the stop test launch on both paths:
               - --EM on examples/ and on a planted 10k x 200 bp set at -k 2
                 and -k 4: written models agree, the refined consensus is
                 the planted motif, the E+M kernel launched at least once per
                 iteration; at -k 2 the kernel path's loop also runs eagerly:
                 equal iterations, files within the bars; MULTI_SEEDS
                 (16) seeds in one group at each of MULTI_SEED_ORDERS
                 (-k 0 and -k 2), a stack the E+M launch splits over its
                 grid (cuda_em.launch_plan, seed_launches), compared at
                 the same budget.
                 The 10k comparisons run a fixed budget of
                 FIXED_ITERS: at ll ~ 7e4 the f32 spacing (0.0078) exceeds
                 epsilon (1e-3), so the |dll| < epsilon stop fires when two
                 f32 lls round equal and a converged run's iteration count
                 is rounding noise.  The converged reference command line
                 runs as well, checked for convergence, consensus, launches;
               - --EM --scoreSeqset --FDR --savePvalues --saveLogOdds on
                 examples/: every written file of the two runs agrees
                 (tests/torch_outputs.py states the bars);
               - BASELINE config 5: a 100k x 200 bp set with a planted 12-mer
                 in 80% of rows, scanned with the planted PWM against 1M
                 sampled negatives (--mFold 10, the streaming path).  No EM
                 runs, so the two paths score from one LUT and their files
                 are equal; >= 99% of planted sites are reported at
                 --pvalCutoff 1e-4; the window-score kernel launched once
                 per chunk scored, markov_codes once; and the 1M negatives
                 of markov_codes bit-equal to markov_codes_ref's on the card
                 (check_config5_negatives);
               - BASELINE config 4: 10k x 200 bp, 3 planted motifs, 10 seeds
                 of widths 8/10/12, --EM --optimizeQ --FDR -q 0.5 with
                 sampled negatives (--mFold 10, --cvFold 5) at a fixed
                 --maxEMIterations 20 (agreement as on examples/), then
                 converged through the kernels: finite .stats, AvRec ZOOPS
                 >= 0.25 for the three unperturbed seeds, both kernels
                 launched, markov_codes once a fold tail (5 folds x 3
                 (W, K) groups);
               - --CGS -k 2 -K 2 on the planted 10k x 200 bp set at the
                 default 100 sweeps: written files equal byte for byte
                 (both paths draw the same numbers, window scores are
                 bit-equal and 0/1 counts exact), and equal to the kernel
                 path's eager sweep loop; the consensus is the planted motif;
                 the sweeps ran as one launch of a WHILE-node graph
                 (graphs.stats' while_launches), the window-score,
                 counts-from-r, cgs_z and cgs_beta kernels launched once a
                 sweep (settled counts);
               - --EM --CGS on examples/: files agree, all three kernels
                 launched;
               - config 4 with --CGS --FDR (per-fold CGS) compared at
                 --maxCGSIterations 20, then through the kernels at the
                 default 100: AvRec ZOOPS >= 0.25 for the planted seeds,
                 each fold's sweeps one loop-graph launch;
               - config 4's EM-FDR and CGS-FDR through evaluate_motifs
                 (fdr_program_slice): the FDR group program, graphed,
                 against its plain version, the fold loop: FDRResults
                 equal and .stats files equal byte for byte, one fold-tail
                 capture a (W, K) group replayed for its other folds, both
                 runs' folds under torch.cuda.set_sync_debug_mode("error")
                 (no host sync from the first fold to the fetch: an EM
                 fold's loop and a CGS fold's sweeps are one launch of a
                 loop graph), B2 and B1 or B3 launched;
               - FDR under torch.profiler (fdr_trace_slice, tests/
                 test_torch_cuda.py's check_traced_fdr, each case a process
                 of its own): EM-FDR, unrefined and CGS-FDR groups in the
                 benchmark's traced order and an --EM --FDR --profile CLI
                 job, results and files equal to the untraced job's, every
                 fold-loop iteration's em_counts_kernel launched inside
                 bamm::fdr.folds, graph.loop_ops no more than the trace's
                 device records;
               - the flat-layout entry points (ops/cuda_flat.py, the port of
                 tools/pallas_flat.py) on the planted 10k x 200 bp set at
                 K=2: FLAT_ITERS EM iterations through flat em_counts, then
                 flat window_scores and flat counts_from_r on the refined
                 model's best windows; every flat kernel launched, the model
                 agrees with FLAT_ITERS iterations through the combined E+M
                 kernel within tests/torch_outputs.py's PROB_TOL and has the
                 planted consensus, scores are bit-equal to the combined
                 window-score kernel's, counts equal to the combined
                 counts kernel's.
  4. parallel: parallel/ (torch.distributed) on the one card, each rank a
               subprocess of this script with torchrun's variables set:
               - a one-rank NCCL group: FIXED_ITERS EM iterations and
                 PARALLEL_SWEEPS CGS sweeps on the planted 10k x 200 bp set
                 at K=2 on a (1, 1) mesh, every all-reduce through NCCL, are
                 bit-equal to the unsharded runs (a one-rank f64 sum is the
                 identity, rounded once); B1, B2 and B3 launched once per
                 iteration or sweep at least; both loops captured (NCCL's
                 all-reduce joins the graph);
               - two ranks over gloo (NCCL refuses two ranks on one card),
                 CUDA tensors staged through host memory by parallel.mesh:
                 --EM at FIXED_ITERS and --CGS at PARALLEL_SWEEPS on the same
                 set through cli.run_pipeline on a (2, 1) mesh; rank 0's files
                 within tests/torch_outputs.py's bars of the single process's
                 (CGS: equal, the draws are the same), rank 1 writes none,
                 each rank launched B1, or B2 and B3, once per iteration or
                 sweep at least; no loop captured (gloo stages through host
                 memory, so the loops run eagerly);
               - the all-reduce's µs an iteration (CUDA events around the
                 reduce of an iteration's buffer, NCCL one rank, gloo two
                 ranks) and EM iterations/s and CGS sweeps/s at world size
                 1 and 2.
  5. timing  : each kernel against its plain version (CUDA events): E+M at
               bench.py's geometry (10k x 200 bp, W=12, K=2), window scores
               at config 5's (100k x 200 bp, W=12, K=2) at M=1 and M=10,
               counts-from-r at bench's geometry with the sampler's 0/1 r at
               M=1 and M=10 (also the kernel's and the whole call's device
               time and the wrapper's host µs a call); the flat kernels at
               bench's geometry at K=2, 3 and 4 beside the combined-layout
               kernels on the same sequences (CUDA events, each kernel's
               and each call's device time under torch.profiler, each
               wrapper's host µs a call), and flat window scores at config
               5's; the
               E+M kernel's device time at bench's geometry at K=2 and 4,
               M=1 and 4 (and on homopolymer rows), the window-score
               kernel's at config 5's at M=1 and 10; each
               kernel's bound (bytes over 3.35 TB/s, f32 operations over
               67 TFLOP/s or 32-bit integer operations over 132 SMs' two
               integer pipes of 64 a clock at the SM clock, whichever is
               largest) and, where one
               PyTorch call computes
               the same function (embedding_bag for window scores on an
               index built beforehand, index_add_ for counts from r with its
               index built beforehand and, beside it, inside the timed
               call), that call's time; EM windows/s and iterations/s; CGS sweeps/s at
               bench's geometry (kernel and plain at M=1, kernel at M=10,
               each graphed and eager, under set_sync_debug_mode("error"),
               the loop graph's body nodes and the device's busy share
               under torch.profiler over 10 graphed and 10 eager sweeps at
               M=1 and 10); the stop-test kernel at M=16; the draw kernels
               against their plain versions: markov_codes at config 5's 1M
               x 200 bp and config 4's fold (20k x 200 bp), cgs_z at M=1,
               10 and 16 on 10k rows of 379 logits beside torch.rand and
               the argmax of logits plus gumbel noise, cgs_beta at M=1, 10
               and 16 beside a generator's torch._standard_gamma (in
               interleaved rounds, with spread and rank test), each
               kernel's bound by bytes, f32 and 32-bit integer operations
               (the ALU pipe's and both integer pipes'); the device
               loop's own cost an iteration, a WHILE-node launch against a
               replay an iteration, on a body of two small kernels;
               the loops (time_loops): EM its/s eager against graphed at
               M=1 and 4 through run_em / run_em_multi and through the
               CLI's --EM stage, graphed EM its/s at a fixed budget at
               M=1, 4, 10 and 16 at K=2 and 4 and on converged runs,
               capture ms, the captures of the slices' CLI runs, and the
               first-use cost of --CGS in fresh processes (kernel path
               first, plain path first); config 5's
               end-to-end scan windows/s and config 4's EM-FDR and CGS-FDR
               seconds per (W, K) group; and the W=10 group of config 4
               through the FDR group program split by stage
               (time_fdr_group: group seconds and the self seconds of
               the program's fdr.* spans).
The line before the last holds the card's name and power limit as
nvidia-smi reports them; the last line is {"ok": true, "device": {...}}.
Imports no JAX.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCES = ("em_counts", "window_scores", "counts_from_r", "flat", "while_loop",
                  "jax_draws")

# bench.py's problem
N_SEQS, SEQ_LEN, W, N_TIMED = 10_000, 200, 12, 30
FIXED_ITERS = 40  # 10k comparison budget; dll there is >> the f32 spacing
C5_SEQS = 100_000  # BASELINE config 5: a 100k-sequence scan
C5_MFOLD = 10
C4_MOTIFS = ["TGACTCAG", "CACGTGACTT", "GGGGCGGGGCCA"]  # W = 8, 10, 12
C4_SEEDS = 10
CGS_FIXED_SWEEPS = 20  # config 4's CGS-FDR comparison budget
FLAT_ITERS = 40  # EM iterations of the flat slice, compared at a fixed budget
# the chunked multi-seed --EM runs: one group of MULTI_SEEDS seeds on bench's
# set at each model order of MULTI_SEED_ORDERS
MULTI_SEEDS, MULTI_SEED_ORDERS = 16, ("0", "2")
# the card's peaks (H100 SXM datasheet, 700 W): device
# memory bandwidth, and f32 arithmetic outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# 32-bit integer results a clock on an SM of compute capability 9.0, a pipe:
# 64 of add, shift and bitwise operations (NVIDIA's CUDA C++ Programming
# Guide, the throughput table of its arithmetic instructions) on the ALU
# pipe, and 64 more integer adds and multiply-adds (IMAD) on the FMA pipe;
# on the H100's 132 SMs
INT32_OPS_PER_SM_CLOCK, SMS = 64, 132


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def load_by_path(name: str, rel: str):
    """A helper module of tests/, loaded by path (a site-wide package named
    ``tests`` must not shadow it)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counted() -> dict:
    """Each kernel's name -> the wrapper that counts its launches."""
    from bammmotif2_tpu_torch.ops import (
        cuda_counts, cuda_draws, cuda_em, cuda_flat, cuda_scores, cuda_while,
    )

    return {"em_counts": cuda_em.em_counts_multi,
            "window_scores": cuda_scores.window_scores_multi,
            "counts_from_r": cuda_counts.counts_from_r_multi,
            "flat_em_counts": cuda_flat.em_counts,
            "flat_window_scores": cuda_flat.window_scores,
            "flat_counts_from_r": cuda_flat.counts_from_r,
            "loop_condition": cuda_while.condition,
            "markov_codes": cuda_draws.markov_codes,
            "cgs_z": cuda_draws.cgs_z,
            "cgs_beta": cuda_draws.cgs_beta}


# not the data path's kernels: the loops' stop test and the draws run on
# both the kernel path and under --no-pallas
BOTH_PATHS = ("loop_condition", "markov_codes", "cgs_z", "cgs_beta")


def launches() -> dict:
    return {name: fn.launches for name, fn in counted().items()}


def reset_launches() -> None:
    for fn in counted().values():
        fn.launches = 0


@functools.cache
def sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz (nvidia-smi's clocks.max.sm)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])


def bound(nbytes: int, ops: int, int_ops: int = 0, alu_ops: int = 0,
          clock_mhz: float | None = None) -> dict:
    """The least time the card could take: the largest of the bytes a
    function must move (each input read once, each output written once)
    over HBM_BYTES_PER_S, its f32 operations over F32_OPS_PER_S and its
    32-bit integer operations over the SMs' two integer pipes: ``alu_ops``
    of the ``int_ops`` run only on the ALU pipe (shifts, bitwise), the rest
    on either, so they take max(alu_ops, int_ops / 2) clocks of SMS x
    INT32_OPS_PER_SM_CLOCK results at the SM clock (``clock_mhz``, else the
    card's highest).  ``bound_by`` is "bytes" or "operations",
    ``bound_term`` which of the three terms."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "f32": ops / F32_OPS_PER_S, "int32": 0.0}
    if int_ops:
        mhz = sm_clock_mhz() if clock_mhz is None else clock_mhz
        terms["int32"] = max(alu_ops, int_ops / 2) / (SMS * INT32_OPS_PER_SM_CLOCK * mhz * 1e6)
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term] * 1e3,
            "bound_by": "bytes" if term == "bytes" else "operations", "bound_term": term,
            "bytes": int(nbytes), "ops": int(ops), "int_ops": int(int_ops),
            "alu_ops": int(alu_ops)}


def hash_bound(nbytes: int, ops: int, hashes: int, clock_mhz: float | None = None) -> dict:
    """``bound`` of a function whose integer work is ``hashes`` Threefry-2x32
    hashes (cuda_draws.THREEFRY_INT_OPS a hash, THREEFRY_ALU_OPS of them
    on the ALU pipe alone)."""
    from bammmotif2_tpu_torch.ops.cuda_draws import THREEFRY_ALU_OPS, THREEFRY_INT_OPS

    return bound(nbytes, ops, hashes * THREEFRY_INT_OPS, hashes * THREEFRY_ALU_OPS, clock_mhz)


def valid_windows(lens, S: int, W: int) -> int:
    """Window starts i with i + W <= len, over all rows and strands."""
    return S * int((lens.long() - W + 1).clamp(min=0).sum().item())


def em_bound(codes, lens, R1: int, W: int, M: int, extra: int = 0) -> dict:
    """E+M pass: codes, lens, M LUTs and q in, M count tables and ll out;
    2W + 6 f32 operations a valid window and seed (W adds to score it, a
    max, an exp and an add for log Z, an exp for r, W adds of r)."""
    S = codes.shape[0]
    nbytes = codes.numel() * 4 + lens.numel() * 4 + 2 * M * (R1 * W * 4 + 4) + extra
    return bound(nbytes, M * valid_windows(lens, S, W) * (2 * W + 6))


def scores_bound(codes, lens, R1: int, W: int, M: int, extra: int = 0) -> dict:
    """Window scores: codes, lens and M LUTs in, M score planes and the mask
    out; W f32 adds a valid window and seed."""
    S, N, L = codes.shape
    n_win = L - W + 1
    nbytes = codes.numel() * 4 + lens.numel() * 4 + M * R1 * W * 4 + M * S * N * n_win * 4 + N * n_win
    return bound(nbytes + extra, M * valid_windows(lens, S, W) * W)


def counts_bound(r, codes, R1: int, W: int, extra: int = 0) -> dict:
    """Counts from r: the count tables out; in, r at every window start
    (i < L-W+1, the only starts read) and only the codes that this run's
    non-zero r needs, in whole 32-byte sectors (a zero r needs no code);
    W f32 adds for each non-zero r at a window start."""
    import torch

    S, N, L = codes.shape
    n_win, esize = L - W + 1, codes.element_size()
    M = r.numel() // codes.numel()
    live = r.reshape(M, S, N, L)[..., :n_win] != 0
    _m, s, n, i = live.nonzero(as_tuple=True)
    first = ((s * N + n) * L + i) * esize  # byte offset of each live window's codes
    sec = first[:, None] // 32 + torch.arange(-(-W * esize // 32) + 1, device=codes.device)
    sec = sec[sec <= (first[:, None] + W * esize - 1) // 32]
    nbytes = (M * S * N * n_win * r.element_size() + int(torch.unique(sec).numel()) * 32
              + M * R1 * W * 4 + extra)
    return bound(nbytes, int(s.numel()) * W)


def window_index(codes, W: int):
    """[S*N*n_win, W] int64 with codes[s, n, i+j] * W + j: every window's
    LUT entries, the index a library call needs (built untimed)."""
    import torch

    j = torch.arange(W, device=codes.device)
    return (codes.unfold(2, W, 1).to(torch.int64) * W + j).reshape(-1, W)


def library_scores_ms(lut, codes, W: int) -> float:
    """One embedding_bag call (mode="sum") summing every window's W LUT
    entries: the window-score function without its mask."""
    import torch

    idx, weight = window_index(codes, W), lut.reshape(-1, 1).contiguous()
    return time_cuda(lambda: torch.nn.functional.embedding_bag(idx, weight, mode="sum"), 10)


def library_counts_ms(r, rows, R1: int, W: int, index_inside: bool = False) -> float:
    """One index_add_ call adding every non-zero r ([M, S, N, L] or [S, N,
    L]) at a window start to its window's W combined rows (``rows`` holds
    combined-row codes, [S, N, L]).  The index (the non-zero r, their
    windows' codes) is built beforehand, or with ``index_inside`` inside the
    timed call, as a caller holding only r would have to."""
    import torch

    S, N, L = rows.shape
    r4 = r.reshape(-1, S, N, L)
    M, n_win = r4.shape[0], L - W + 1
    j = torch.arange(W, device=r.device)
    codes = rows.reshape(-1)

    def index():
        rv = r4[..., :n_win]
        m, s, n, i = rv.nonzero(as_tuple=True)
        pos = (s * N + n) * L + i
        idx = ((m * R1)[:, None] + codes[pos[:, None] + j].long()) * W + j
        return idx.reshape(-1), rv[m, s, n, i][:, None].expand(-1, W).reshape(-1)

    def add(idx, vals):
        return torch.zeros(M * R1 * W, dtype=torch.float32, device=r.device).index_add_(0, idx, vals)

    if index_inside:
        return time_cuda(lambda: add(*index()), 10)
    idx, vals = index()
    vals = vals.contiguous()
    return time_cuda(lambda: add(idx, vals), 10)


def phase_build():
    import torch

    from bammmotif2_tpu_torch.ops import (
        _build, cuda_counts, cuda_draws, cuda_em, cuda_flat, cuda_scores, cuda_while,
    )

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:  # one nvcc per source, together
        paths = list(ex.map(_build.library_path, KERNEL_SOURCES))
    cuda_em.library()
    cuda_scores.library()
    cuda_counts.library()
    cuda_flat.library()
    cuda_while.library()
    cuda_draws.library()
    secs = time.perf_counter() - t0
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"toolchain: torch {torch.__version__} | cuda {torch.version.cuda} | "
        f"nvcc {nvcc} | gpu {nvidia_smi()}")
    log(f"CUDA driver {cuda_while.driver_version()} | runtime {cuda_while.runtime_version()} | "
        f"WHILE graph nodes need {cuda_while.MIN_DRIVER}")
    log(f"build: {len(paths)} libraries in {secs:.1f}s")
    for path in paths:
        log(f"  {os.path.relpath(path, ROOT)}")
        with open(path + ".log") as fh:
            log("".join(f"    {ln}" for ln in fh if "Used" in ln or "spill" in ln
                        or "entry function" in ln).rstrip())


def phase_kernel(device) -> dict:
    checks = load_by_path("bamm_torch_cuda_checks", "tests/test_torch_cuda.py")
    worst = dict.fromkeys(counted(), 0.0)
    for name, case in checks.KERNEL_CASES.items():
        res = checks.check_kernel(case, device)
        worst["em_counts"] = max(worst["em_counts"], res["max_abs_err"])
        log(f"kernel em_counts {name}: " + json.dumps({k: float(v) for k, v in res.items()}))
    for name, case in checks.SCORE_CASES.items():
        res = checks.check_scores(case, device)
        worst["window_scores"] = max(worst["window_scores"], res["max_abs_err"])
        log(f"kernel window_scores {name}: " + json.dumps({k: float(v) for k, v in res.items()}))
    for name, case in checks.COUNTS_CASES.items():
        res = checks.check_counts(case, device)
        worst["counts_from_r"] = max(worst["counts_from_r"], res["max_abs_err"])
        log(f"kernel counts_from_r {name}: " + json.dumps({k: float(v) for k, v in res.items()}))
    for name, case in checks.FLAT_CASES.items():
        res = checks.check_flat(case, device)
        for k in checks.FLAT_KERNELS:
            worst[k] = max(worst[k], res[k]["max_abs_err"])
        log(f"kernel flat {name}: " + json.dumps(res))
    res = checks.check_counts_calls(device)
    for k in ("counts_from_r", "flat_counts_from_r"):
        worst[k] = max(worst[k], res["max_abs_err"])
    log("kernel counts calls (one kernel a call, workspace, CUDA graph): " + json.dumps(res))
    log("kernel flat calls (what an E+M and a scores call enqueue): "
        + json.dumps(checks.check_flat_calls(device)))
    res = checks.check_condition(device)
    worst["loop_condition"] = float(res["mismatches"])
    log("kernel loop_condition (edge inputs; max_abs_err counts mismatches): " + json.dumps(res))
    draws = load_by_path("bamm_torch_draws_checks", "tests/test_torch_draws.py")
    res = draws.check_markov(device)
    worst["markov_codes"] = float(res["mismatched_codes"])
    log("kernel markov_codes (bit-equal to markov_codes_ref; max_abs_err counts mismatched "
        "codes): " + json.dumps(res))
    res = draws.check_z(device)
    worst["cgs_z"] = float(res["mismatches"])
    log("kernel cgs_z (bit-equal to cgs_z_ref; max_abs_err counts mismatches): "
        + json.dumps(res))
    res = draws.check_beta(device)
    worst["cgs_beta"] = res["max_abs_err"]
    log(f"kernel cgs_beta (against cgs_beta_ref: the same attempts, rtol {draws.BETA_RTOL}, "
        f"the same advanced keys): " + json.dumps(res))
    log("kernel draws against the CPU's plain versions: "
        + json.dumps(check_draws_against_cpu(device)))
    log("kernel loops (graphed against eager, host reads, counters, failed capture): "
        + json.dumps(checks.check_loops(device)))
    return worst


def check_draws_against_cpu(device) -> dict:
    """The draw kernels on the card against their plain versions on the CPU
    (which tests/test_torch_threefry.py holds to jax.random): a sampled set
    (2,000 x 150 bp, sOrder 2) and CGS's z (M=4, 2,000 rows of 379 logits)
    bit-equal; q (256 chains) within rtol 1e-6, the CPU's exp against the
    card's."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_draws, threefry

    draws = load_by_path("bamm_torch_draws_checks", "tests/test_torch_draws.py")
    trans, lens, key = draws._markov_inputs("cpu", 2_000, 150, 2, 11)
    codes = cuda_draws.markov_codes(key.to(device), tuple(t.to(device) for t in trans),
                                    lens.to(device), L=150, s_order=2, A=4).cpu()
    want = cuda_draws.markov_codes_ref(key, trans, lens, L=150, s_order=2, A=4)
    rng = np.random.default_rng(12)
    flat = torch.as_tensor(rng.normal(0, 2, (4, 2_000, 379)).astype(np.float32))
    keys = threefry.fold_in(threefry.prng_key(3)[None], torch.arange(4))
    z = cuda_draws.cgs_z(flat.to(device), keys.to(device), 7).cpu()
    z_ref = cuda_draws.cgs_z_ref(flat, keys, 7)
    a = torch.as_tensor(rng.integers(1, 10_002, 256).astype(np.float32))
    b = torch.as_tensor(rng.integers(1, 10_002, 256).astype(np.float32))
    k256 = threefry.split(threefry.prng_key(4), 256)
    q = cuda_draws.cgs_beta(a.to(device), b.to(device), k256.clone().to(device), 1e-4,
                            1 - 1e-4).cpu()
    q_ref = cuda_draws.cgs_beta_ref(a, b, k256.clone(), 1e-4, 1 - 1e-4)
    out = {"codes_mismatched": int((codes != want).sum()),
           "z_mismatched": int((z != z_ref).sum()),
           "q_max_rel_err": float(((q - q_ref).abs() / q_ref).max())}
    if out["codes_mismatched"] or out["z_mismatched"] or out["q_max_rel_err"] > 1e-6:
        raise AssertionError(f"the card's draws differ from the CPU's: {out}")
    return out


def write_meme(path: str, pwms: list) -> None:
    with open(path, "w") as fh:
        fh.write("MEME version 4\n\n")
        for name, pwm in pwms:
            fh.write(f"MOTIF {name}\nletter-probability matrix: alength= 4 w= {len(pwm)} "
                     f"nsites= 100\n")
            fh.writelines(" ".join(f"{p:.6f}" for p in row) + "\n" for row in pwm)
            fh.write("\n")


def planted_problem(outdir: str, n_seqs: int = N_SEQS, tag: str = "planted") -> tuple:
    """bench.py::build_problem's set (numpy seed 0, n_seqs rows) as FASTA +
    MEME seed.  Returns (sset, fasta, meme, motif codes, start, planted?)."""
    from bammmotif2_tpu_torch.utils.alphabet import Alphabet
    from bammmotif2_tpu_torch.utils.fasta import SequenceSet, write_fasta

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (n_seqs, SEQ_LEN)).astype(np.int8)
    motif_codes = rng.integers(0, 4, W)
    pos = rng.integers(0, SEQ_LEN - W, n_seqs)
    has = rng.random(n_seqs) < 0.8
    rows = np.nonzero(has)[0]
    codes[rows[:, None], pos[rows][:, None] + np.arange(W)] = motif_codes
    sset = SequenceSet(codes, np.full(n_seqs, SEQ_LEN, np.int32),
                       [f"s{i}" for i in range(n_seqs)], Alphabet.standard())
    fasta = os.path.join(outdir, f"{tag}.fasta")
    write_fasta(fasta, sset)
    pwm = np.full((W, 4), 0.1)
    pwm[np.arange(W), motif_codes] = 0.7
    meme = os.path.join(outdir, f"{tag}.meme")
    write_meme(meme, [("planted", pwm)])
    return sset, fasta, meme, motif_codes, pos, has


def seeds_meme(outdir: str, planted, M: int, tag: str) -> str:
    """A MEME of M width-W seeds on ``planted``'s motif: the planted PWM's
    shape, softer with m (0.7 - 0.02 m on the planted base)."""
    pwms = []
    for m in range(M):
        pwm = np.full((W, 4), (0.3 + 0.02 * m) / 3)
        pwm[np.arange(W), planted] = 0.7 - 0.02 * m
        pwms.append((f"seed{m + 1}", pwm))
    path = os.path.join(outdir, f"{tag}.meme")
    write_meme(path, pwms)
    return path


def config4_problem(outdir: str) -> tuple:
    """tools/config4_bench.py's inputs, built with the port's seeds module:
    10k x 200 bp, 3 motifs interleaved (80% of their rows), 10 seeds (the 3
    motifs, then perturbed variants)."""
    from bammmotif2_tpu_torch.utils.alphabet import Alphabet
    from bammmotif2_tpu_torch.utils.fasta import SequenceSet, write_fasta
    from bammmotif2_tpu_torch.models import seeds as seeds_mod

    rng = np.random.default_rng(0)
    alphabet = Alphabet.from_type("STANDARD")
    codes = rng.integers(0, 4, (N_SEQS, SEQ_LEN)).astype(np.int8)
    for i, mot in enumerate(C4_MOTIFS):
        enc = alphabet.encode(mot)
        rows = np.arange(i, N_SEQS, len(C4_MOTIFS))
        pos = rng.integers(0, SEQ_LEN - len(enc), rows.size)
        keep = rng.random(rows.size) < 0.8
        for r, p, k in zip(rows, pos, keep):
            if k:
                codes[r, p : p + len(enc)] = enc
    sset = SequenceSet(codes, np.full(N_SEQS, SEQ_LEN, np.int32),
                       [f"s{i}" for i in range(N_SEQS)], alphabet)
    fasta = os.path.join(outdir, "c4.fasta")
    write_fasta(fasta, sset)
    pwms = []
    for s in range(C4_SEEDS):
        pwm = seeds_mod.iupac_to_pwm(C4_MOTIFS[s % len(C4_MOTIFS)], soft=0.7)
        if s >= len(C4_MOTIFS):
            pwm = pwm * rng.uniform(0.8, 1.25, pwm.shape)
        pwms.append((f"seed{s + 1}", pwm / pwm.sum(axis=1, keepdims=True)))
    meme = os.path.join(outdir, "c4.meme")
    write_meme(meme, pwms)
    return fasta, meme


def runs_events(tmp: str, tag: str, base: str) -> dict:
    """A finished run's metrics events by kind (lists)."""
    events: dict = {}
    with open(os.path.join(tmp, tag, f"{base}.metrics.jsonl")) as fh:
        for e in map(json.loads, fh):
            events.setdefault(e["event"], []).append(e)
    return events


def run_cli(outdir: str, fasta: str, meme: str, extra: list, device, graphs: bool = True) -> dict:
    """One CLI run (``graphs``: False runs its loops eagerly); returns its
    metrics events by kind (lists), the launches each kernel made in it
    (counts zeroed just before), its seconds and the loops it captured
    (``refinement.graphs.stats``: the cache emptied just before, as a fresh
    process starts)."""
    from bammmotif2_tpu_torch import cli
    from bammmotif2_tpu_torch.refinement import graphs as graphs_mod

    graphs_mod.clear()
    reset_launches()
    t0 = time.perf_counter()
    cli.main([outdir, fasta, "--PWMFile", meme, "--jsonl", *extra], device=device, graphs=graphs)
    secs = time.perf_counter() - t0
    n = launches()
    base = os.path.splitext(os.path.basename(fasta))[0]
    events = runs_events(os.path.dirname(outdir), os.path.basename(outdir), base)
    return {"events": events, "launches": n, "seconds": secs, "base": base,
            "captures": graphs_mod.stats()}


def run_pair(tag: str, fasta: str, meme: str, extra: list, device, tmp: str) -> tuple:
    """The same command through the kernels and under --no-pallas; the plain
    run must launch none of the data path's kernels (the loops run on the
    device on both paths, and CGS draws from the same kernels on both, so
    BOTH_PATHS' kernels launch on both)."""
    k = run_cli(os.path.join(tmp, tag + "_kernel"), fasta, meme, extra, device)
    p = run_cli(os.path.join(tmp, tag + "_plain"), fasta, meme, [*extra, "--no-pallas"], device)
    if any(n for name, n in p["launches"].items() if name not in BOTH_PATHS):
        raise AssertionError(f"{tag}: --no-pallas run launched a kernel: {p['launches']}")
    return k, p


def check_consensus(tag: str, dirs: tuple, base: str, motif: str, planted) -> None:
    from bammmotif2_tpu_torch.models.motif import Motif

    for d in dirs:
        consensus = Motif.read(os.path.join(d, f"{base}_{motif}.ihbcp")).v[0].argmax(axis=0)
        if not np.array_equal(consensus, planted):
            raise AssertionError(f"{tag}: consensus {consensus} != planted {planted}")


def em_slice(tag, fasta, meme, extra, device, tmp, compare, planted=None,
             eager=False) -> dict:
    """The --EM slice through the kernel, then under --no-pallas, both with
    their loops graphed; checks launches, (with ``compare``) agreement of
    the two paths with equal iteration counts, (with ``planted``) the
    refined consensus, and (with ``eager``) the kernel path's loop run
    eagerly against the graphed one: equal iterations, files within
    tests/torch_outputs.py's bars."""
    outputs = load_by_path("bamm_torch_outputs", "tests/torch_outputs.py")
    k, p = run_pair(tag, fasta, meme, ["--EM", *extra], device, tmp)
    ev_k, ev_p = k["events"]["em_done"], p["events"]["em_done"]
    its = max(e["iterations"] for e in ev_k)
    n = k["launches"]["em_counts"]
    if n < its or n == 0:
        raise AssertionError(f"{tag}: {n} kernel launches for {its} EM iterations")
    if k["launches"]["loop_condition"] < its:
        raise AssertionError(f"{tag}: {k['launches']['loop_condition']} stop tests for {its} "
                             f"EM iterations")
    dirs = (os.path.join(tmp, tag + "_kernel"), os.path.join(tmp, tag + "_plain"))
    if compare:
        pairs = [(a["iterations"], b["iterations"]) for a, b in zip(ev_k, ev_p, strict=True)]
        if any(a != b for a, b in pairs):
            raise AssertionError(f"{tag}: iterations (kernel, plain): {pairs}")
        worst = outputs.compare_dirs(*dirs, refined=True)["max_dp"]
    elif not all(e["converged"] for e in ev_k + ev_p):
        raise AssertionError(f"{tag}: not converged: {ev_k + ev_p}")
    else:
        worst = max(float(np.abs(outputs.read_probs(os.path.join(dirs[0], f)) -
                                 outputs.read_probs(os.path.join(dirs[1], f))).max())
                    for f in os.listdir(dirs[0]) if f.endswith((".ihbcp", ".ihbp")))
    if planted is not None:
        check_consensus(tag, dirs, k["base"], ev_k[0]["motif"], planted)
    graphed_vs_eager = None
    if eager:
        e = run_cli(os.path.join(tmp, tag + "_eager"), fasta, meme, ["--EM", *extra], device,
                    graphs=False)
        pairs = [(a["iterations"], b["iterations"])
                 for a, b in zip(ev_k, e["events"]["em_done"], strict=True)]
        if any(a != b for a, b in pairs) or e["captures"]:
            raise AssertionError(f"{tag}: iterations (graphed, eager) {pairs}, "
                                 f"eager captures {e['captures']}")
        graphed_vs_eager = {
            "max_abs_dp": outputs.compare_dirs(dirs[0], os.path.join(tmp, tag + "_eager"),
                                               refined=True)["max_dp"],
            "em_seconds_graphed": [x["seconds"] for x in ev_k],
            "em_seconds_eager": [x["seconds"] for x in e["events"]["em_done"]]}
    if not k["captures"]:
        raise AssertionError(f"{tag}: the kernel run's EM loop was not graphed")
    out = {
        "compared": compare,
        "captures": k["captures"],
        "graphed_vs_eager": graphed_vs_eager,
        "launches": n,
        "condition_launches": k["launches"]["loop_condition"],
        "iterations_kernel": [e["iterations"] for e in ev_k],
        "iterations_plain": [e["iterations"] for e in ev_p],
        "max_abs_dp": worst,
        "cli_seconds_kernel": k["seconds"],
        "cli_seconds_plain": p["seconds"],
        "em_windows_per_s_kernel": [e["windows_per_sec"] for e in ev_k],
        "em_windows_per_s_plain": [e["windows_per_sec"] for e in ev_p],
    }
    log(f"slice {tag}: " + json.dumps(out))
    return out


def files_equal(dir_a: str, dir_b: str) -> bool:
    """Every written file (metrics logs aside) byte-identical."""
    names = sorted(n for n in os.listdir(dir_a) if not n.endswith(".metrics.jsonl"))
    for n in names:
        with open(os.path.join(dir_a, n), "rb") as a, open(os.path.join(dir_b, n), "rb") as b:
            if a.read() != b.read():
                return False
    return True


def one_launch_a_run(captures: list, sweeps: int, tag: str) -> list:
    """The cached CGS loops of ``captures`` (``graphs.stats()``): each call
    of each ran its ``sweeps`` sweeps as one launch of its loop graph
    (``while_launches`` = calls; its sweeps but the first call's eager one
    settled as ``replays``).  Returns them."""
    loops = [c for c in captures if c["name"] == "CGS sweep loop"]
    if not loops or any(c.get("while_launches") != c["calls"]
                        or c["replays"] != c["calls"] * sweeps - 1 for c in loops):
        raise AssertionError(f"{tag}: a CGS run was not one loop-graph launch: {loops}")
    return loops


def full_slice(tag, fasta, meme, extra, device, tmp, m_fold,
               kernels=("em_counts", "window_scores")) -> tuple:
    """A CLI command through the kernels and under --no-pallas: every
    written file agrees (tests/torch_outputs.py, refined models), and each
    of ``kernels`` launched in the kernel run."""
    outputs = load_by_path("bamm_torch_outputs", "tests/torch_outputs.py")
    k, p = run_pair(tag, fasta, meme, extra, device, tmp)
    if not all(k["launches"][name] for name in kernels):
        raise AssertionError(f"{tag}: a kernel did not launch: {k['launches']}")
    dirs = (os.path.join(tmp, tag + "_kernel"), os.path.join(tmp, tag + "_plain"))
    cmp = outputs.compare_dirs(*dirs, refined=True, m_fold=m_fold)
    out = {
        "launches": k["launches"],
        "captures": k["captures"],
        "files_compared": cmp["files"],
        "files_equal": files_equal(*dirs),
        "max_abs_dp": cmp["max_dp"],
        "rows_near_cutoff": cmp["rows_near_cutoff"],
        "avrec_zoops_mops_kernel": [[e["avrec_zoops"], e["avrec_mops"]]
                                    for e in k["events"].get("fdr_done", [])],
        "cli_seconds_kernel": k["seconds"],
        "cli_seconds_plain": p["seconds"],
    }
    log(f"slice {tag}: " + json.dumps(out))
    return k, out


def config5_slice(device, tmp) -> dict:
    """BASELINE config 5: 100k x 200 bp scan, 1M sampled negatives."""
    from bammmotif2_tpu_torch.scoring.scan import KEEP_BYTES

    outputs = load_by_path("bamm_torch_outputs", "tests/torch_outputs.py")
    _, fasta, meme, _motif, pos, has = planted_problem(tmp, C5_SEQS, "c5")
    extra = ["--scoreSeqset", "--mFold", str(C5_MFOLD), "--pvalCutoff", "1e-4", "-k", "2", "-K", "2"]
    k, p = run_pair("config5", fasta, meme, extra, device, tmp)
    dirs = (os.path.join(tmp, "config5_kernel"), os.path.join(tmp, "config5_plain"))
    outputs.compare_dirs(*dirs, refined=False)  # one LUT: equal files
    ev = k["events"]["scan_done"][0]
    with open(os.path.join(dirs[0], f"{k['base']}_{ev['motif']}.occurrence")) as fh:
        found = {(f[0], f[2], f[3].split("..")[0]) for f in (ln.split("\t") for ln in fh.readlines()[1:])}
    rows = np.nonzero(has)[0]
    hit = sum((f"s{n}", "+", str(pos[n] + 1)) in found for n in rows)
    recovered = hit / rows.size
    if recovered < 0.99:
        raise AssertionError(f"config5: {recovered:.4f} of planted sites reported")
    # positives (151 MB) are retained; negatives (1.5 GB) stream, scored once
    # for the maxima and once more for the pool
    B = 16384
    n_pos, n_neg = -(-C5_SEQS // B), -(-C5_SEQS * C5_MFOLD // B)
    if 4 * 2 * C5_SEQS * (SEQ_LEN - W + 1) > KEEP_BYTES:
        raise AssertionError("config5: the positives were expected to be retained")
    chunks = n_pos + 2 * n_neg
    if k["launches"]["window_scores"] < chunks:
        raise AssertionError(f"config5: {k['launches']} for {chunks} chunks scored")
    if k["launches"]["markov_codes"] != 1 or p["launches"]["markov_codes"] != 1:
        raise AssertionError(f"config5: one sampler launch a scan, got {k['launches']}, "
                             f"--no-pallas {p['launches']}")
    negatives = check_config5_negatives(device, tmp)
    neg_windows = C5_MFOLD * ev["windows"]
    out = {
        "launches": k["launches"],
        "chunks_scored": chunks,
        "occurrences": ev["hits"],
        "planted_recovered": recovered,
        "negatives_bit_equal_to_plain": negatives,
        "scan_seconds_kernel": ev["seconds"],
        "scan_seconds_plain": p["events"]["scan_done"][0]["seconds"],
        "scan_windows_per_s_kernel": (ev["windows"] + neg_windows) / ev["seconds"],
        "scan_windows_per_s_plain": (ev["windows"] + neg_windows)
        / p["events"]["scan_done"][0]["seconds"],
        "cli_seconds_kernel": k["seconds"],
        "cli_seconds_plain": p["seconds"],
    }
    log("slice config5 (100k x 200 bp, 1M sampled negatives): " + json.dumps(out))
    return out


def c5_negative_inputs(device, tmp) -> tuple:
    """Config 5's sampler inputs as its --scoreSeqset stage makes them: the
    key PRNGKey(--seed), the order-2 background fit to the 100k positives
    (--sOrder, --bgModelAlpha at their defaults) and the positives' lengths
    10 times (1M rows, L=200)."""
    import torch

    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.ops import threefry
    from bammmotif2_tpu_torch.utils.config import Params

    params = Params()
    sset, *_ = planted_problem(tmp, C5_SEQS, "c5")
    bg = BackgroundModel.from_sequence_set(sset, order=params.sOrder, alpha=params.bgModelAlpha,
                                           ss=False)
    trans = tuple(torch.as_tensor(v, dtype=torch.float32, device=device) for v in bg.v)
    lens = torch.as_tensor(np.tile(sset.lens, C5_MFOLD), dtype=torch.int32, device=device)
    return threefry.prng_key(params.seed, device), trans, lens, params.sOrder


def check_config5_negatives(device, tmp) -> dict:
    """markov_codes against markov_codes_ref on config 5's 1M negative rows
    (``c5_negative_inputs``) on the card: bit-equal."""
    from bammmotif2_tpu_torch.ops import cuda_draws

    key, trans, lens, s_order = c5_negative_inputs(device, tmp)
    kw = dict(L=SEQ_LEN, s_order=s_order, A=4)
    got = cuda_draws.markov_codes(key, trans, lens, **kw)
    want = cuda_draws.markov_codes_ref(key, trans, lens, **kw)
    out = {"rows": int(lens.numel()), "mismatched_codes": int((got != want).sum()),
           "rows_differing": int((got != want).any(dim=1).sum())}
    if out["mismatched_codes"]:
        raise AssertionError(f"config5: the sampler kernel differs from its plain version: {out}")
    return out


def config4_slice(device, tmp) -> dict:
    """BASELINE config 4: 10 seeds, EM + FDR with sampled negatives."""
    fasta, meme = config4_problem(tmp)
    extra = ["--maxPWM", str(C4_SEEDS), "--EM", "--optimizeQ", "--FDR", "-q", "0.5",
             "--mFold", "10", "--cvFold", "5"]
    k, fixed = full_slice("config4_fixed", fasta, meme, [*extra, "--maxEMIterations", "20"],
                          device, tmp, m_fold=10)
    conv = run_cli(os.path.join(tmp, "config4_converged"), fasta, meme, extra, device)
    if not (conv["launches"]["em_counts"] and conv["launches"]["window_scores"]):
        raise AssertionError(f"config4: a kernel did not launch: {conv['launches']}")
    tails = 5 * len({len(m) for m in C4_MOTIFS})  # a fold tail a fold and (W, K) group
    if k["launches"]["markov_codes"] != tails or conv["launches"]["markov_codes"] != tails:
        raise AssertionError(f"config4: {tails} sampler launches expected, got "
                             f"{k['launches']['markov_codes']}, {conv['launches']['markov_codes']}")
    fdr = conv["events"]["fdr_done"]
    d = os.path.join(tmp, "config4_converged")
    for e in fdr:
        for tag in ("zoops", "mops"):
            a = np.loadtxt(os.path.join(d, f"c4_{e['motif']}.{tag}.stats"), skiprows=1, ndmin=2)
            if a.shape[0] < 2 or not np.isfinite(a).all():
                raise AssertionError(f"config4: {e['motif']}.{tag}.stats is empty or not finite")
    avrec = {e["motif"]: e["avrec_zoops"] for e in fdr}
    # the CLI names seeds motif_1.. in file order: the first three are the
    # unperturbed planted motifs
    if min(avrec[f"motif_{s + 1}"] for s in range(len(C4_MOTIFS))) < 0.25:
        raise AssertionError(f"config4: AvRec ZOOPS of the planted seeds {avrec}")
    groups = {}
    for e in fdr:
        groups[f"W{e['W']}_K{e['K']}"] = e["group_seconds"]
    out = {
        "fixed": fixed,
        "converged_launches": conv["launches"],
        "captures": conv["captures"],
        "converged_em_iterations": [e["iterations"] for e in conv["events"]["em_done"]],
        "avrec_zoops": avrec,
        "fdr_group_seconds_kernel": groups,
        "cli_seconds_converged": conv["seconds"],
    }
    log("slice config4 (10 seeds, --FDR): " + json.dumps(out))
    return out


def cgs_slices(device, tmp) -> dict:
    """--CGS on the planted 10k set, --EM --CGS on examples/, and config 4's
    CGS-FDR, each through the kernels and under --no-pallas."""
    examples = os.path.join(ROOT, "examples")
    _, fasta, meme, planted, _pos, _has = planted_problem(tmp, tag="cgs")
    k, main = full_slice("cgs_10k", fasta, meme, ["--CGS", "-k", "2", "-K", "2"], device, tmp,
                         m_fold=1, kernels=("window_scores", "counts_from_r"))
    # graphed: equal to --no-pallas (graphed too) and to the eager loop, byte for byte
    e = run_cli(os.path.join(tmp, "cgs_10k_eager"), fasta, meme, ["--CGS", "-k", "2", "-K", "2"],
                device, graphs=False)
    main["files_equal_eager"] = files_equal(os.path.join(tmp, "cgs_10k_kernel"),
                                            os.path.join(tmp, "cgs_10k_eager"))
    main["cgs_seconds_eager"] = e["events"]["cgs_done"][0]["seconds"]
    if not (main["files_equal"] and main["files_equal_eager"]) or not k["captures"] \
            or e["captures"]:
        raise AssertionError(f"cgs_10k: files equal to --no-pallas {main['files_equal']}, to "
                             f"the eager loop {main['files_equal_eager']}; captures "
                             f"{k['captures']}, eager {e['captures']}")
    sweeps = k["events"]["cgs_done"][0]["iterations"]
    per_sweep = ("window_scores", "counts_from_r", "cgs_z", "cgs_beta")
    if any(k["launches"][name] != sweeps for name in per_sweep):
        raise AssertionError(f"cgs_10k: {k['launches']} for {sweeps} sweeps")
    main["cgs_loop_graph"] = one_launch_a_run(k["captures"], sweeps, "cgs_10k")
    if len(main["cgs_loop_graph"]) != 1:
        raise AssertionError(f"cgs_10k: loops {main['cgs_loop_graph']}")
    check_consensus("cgs_10k", (os.path.join(tmp, "cgs_10k_kernel"), os.path.join(tmp, "cgs_10k_plain")),
                    k["base"], k["events"]["cgs_done"][0]["motif"], planted)
    p_ev = runs_events(tmp, "cgs_10k_plain", k["base"])["cgs_done"][0]
    stage = {"sweeps": sweeps, "q_kernel": k["events"]["cgs_done"][0]["q"], "q_plain": p_ev["q"],
             "cgs_seconds_kernel": k["events"]["cgs_done"][0]["seconds"],
             "cgs_seconds_plain": p_ev["seconds"]}
    log("slice cgs_10k CGS stage (cgs_done events): " + json.dumps(stage))
    main.update(stage)
    _k, em_cgs = full_slice("examples_em_cgs", os.path.join(examples, "positives.fasta"),
                            os.path.join(examples, "seed.meme"), ["--EM", "--CGS"], device, tmp,
                            m_fold=1, kernels=("em_counts", "window_scores", "counts_from_r"))

    fasta4, meme4 = config4_problem(tmp)
    extra = ["--maxPWM", str(C4_SEEDS), "--CGS", "--FDR", "-q", "0.5", "--mFold", "10",
             "--cvFold", "5"]
    _k, fixed = full_slice("config4_cgs_fixed", fasta4, meme4,
                           [*extra, "--maxCGSIterations", str(CGS_FIXED_SWEEPS)], device, tmp,
                           m_fold=10, kernels=("window_scores", "counts_from_r"))
    full = run_cli(os.path.join(tmp, "config4_cgs"), fasta4, meme4, extra, device)
    if not (full["launches"]["window_scores"] and full["launches"]["counts_from_r"]):
        raise AssertionError(f"config4 CGS: a kernel did not launch: {full['launches']}")
    # the CGS stage's loops (one call each), then the FDR folds' (five calls
    # a group); the cache may have dropped the oldest
    loops = one_launch_a_run(full["captures"], 100, "config4 CGS")
    if sum(c["calls"] == 5 for c in loops) != len({len(m) for m in C4_MOTIFS}):
        raise AssertionError(f"config4 CGS: the folds' loops {loops}")
    fdr = full["events"]["fdr_done"]
    avrec = {e["motif"]: e["avrec_zoops"] for e in fdr}
    if min(avrec[f"motif_{s + 1}"] for s in range(len(C4_MOTIFS))) < 0.25:
        raise AssertionError(f"config4 CGS: AvRec ZOOPS of the planted seeds {avrec}")
    c4 = {
        "fixed": fixed,
        "launches": full["launches"],
        "cgs_loop_graphs": loops,
        "captures": full["captures"],
        "avrec_zoops": avrec,
        "cgs_fdr_group_seconds_kernel": {f"W{e['W']}_K{e['K']}": e["group_seconds"] for e in fdr},
        "cli_seconds": full["seconds"],
    }
    log("slice config4 CGS (10 seeds, --CGS --FDR, 100 sweeps): " + json.dumps(c4))
    return {"cgs_10k": main, "examples_em_cgs": em_cgs, "config4_cgs": c4}


def fdr_program_slice(device, tmp) -> dict:
    """Config 4's EM-FDR and CGS-FDR through evaluate_motifs, all ten seeds
    (three (W, K) groups): the group program, graphed, against its plain
    version, the fold loop (``program=False``), on the same inputs.  Their
    FDRResults are equal and their .stats files byte for byte; each group
    captured its fold tail once and replayed it for its other folds; the
    folds of both runs (``fdr._run_folds``: an EM fold's loop graph, a CGS
    fold's) ran under torch.cuda.set_sync_debug_mode("error"), so a host
    sync between the first fold and the fetch fails it; a CGS fold's sweeps
    were one loop-graph launch (``one_launch_a_run``); B2 and B1 (EM) or B3 (CGS)
    launched in the program's run."""
    import torch

    from bammmotif2_tpu_torch.evaluation import fdr
    from bammmotif2_tpu_torch.refinement import graphs as graphs_mod
    from bammmotif2_tpu_torch.tools import fdr_split

    checks = load_by_path("bamm_torch_cuda_checks", "tests/test_torch_cuda.py")
    out = {}
    for refine in ("EM", "CGS"):
        seeds, bg, pos, params = fdr_split.problem(sys.modules[__name__], tmp, refine, None)
        run_folds = fdr._run_folds

        def no_sync(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return run_folds(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        graphs_mod.clear()
        reset_launches()
        fdr._run_folds = no_sync
        try:
            t0 = time.perf_counter()
            prog = fdr.evaluate_motifs([m.copy() for m in seeds], bg, pos, params, device=device)
            secs = time.perf_counter() - t0
        finally:
            fdr._run_folds = run_folds
        n, caps = launches(), graphs_mod.stats()
        t0 = time.perf_counter()
        loop = fdr.evaluate_motifs([m.copy() for m in seeds], bg, pos, params, device=device,
                                   program=False)
        loop_secs = time.perf_counter() - t0
        same = checks.fdr_results_equal(prog, loop)
        dirs = [os.path.join(tmp, f"fdr_program_{refine}_{t}") for t in ("program", "loop")]
        for d, res in zip(dirs, (prog, loop)):
            for m, r in zip(seeds, res):
                r.write(d, f"c4_{m.name}")
        tails = [c for c in caps if c["name"] == "FDR fold tail"]
        n_groups = len({m.W for m in seeds})
        kernels = ("window_scores", "em_counts" if refine == "EM" else "counts_from_r")
        entry = {
            "results_equal": same,
            "files_equal": files_equal(*dirs),
            "fold_tail_captures": tails,
            "groups": n_groups,
            "launches": n,
            "group_seconds_program": {f"W{m.W}": r.group_seconds for m, r in zip(seeds, prog)},
            "group_seconds_loop": {f"W{m.W}": r.group_seconds for m, r in zip(seeds, loop)},
            "evaluate_seconds_program": secs,
            "evaluate_seconds_loop": loop_secs,
            "fold_iterations": [r.fold_iterations for r in prog],
        }
        log(f"slice fdr_program {refine} (config 4, 10 seeds): " + json.dumps(entry))
        if not (same and entry["files_equal"]):
            raise AssertionError(f"fdr_program {refine}: the program's results differ from the "
                                 f"fold loop's (results {same}, files {entry['files_equal']})")
        if len(tails) != n_groups or any(c["calls"] != 1 or c["replays"] != params.cvFold - 1
                                         for c in tails):
            raise AssertionError(f"fdr_program {refine}: fold-tail captures {tails}, "
                                 f"{n_groups} groups of {params.cvFold} folds")
        if not all(n[k] for k in kernels):
            raise AssertionError(f"fdr_program {refine}: a kernel did not launch: {n}")
        if refine == "CGS":
            loops = one_launch_a_run(caps, params.maxCGSIterations, "fdr_program CGS")
            entry["cgs_loop_graphs"] = loops
            if sorted(c["calls"] for c in loops) != [params.cvFold] * n_groups:
                raise AssertionError(f"fdr_program CGS: a fold's sweeps were not one "
                                     f"loop-graph launch: {loops}")
        out[refine] = entry
    return out


def flat_slice(device, tmp) -> dict:
    """The flat-layout entry points (ops/cuda_flat.py, the port of
    tools/pallas_flat.py) at bench's geometry, K=2: FLAT_ITERS ZOOPS EM
    iterations (optimised q) through flat em_counts, then flat
    window_scores and flat counts_from_r on the refined model's best window
    of each row.  The launch counts are zeroed just before and read just
    after; then the same iterations run through the combined E+M kernel
    and the combined window-score and counts kernels score and count the
    same model, for the checks."""
    import torch

    from bammmotif2_tpu_torch.models import motif as motif_mod
    from bammmotif2_tpu_torch.models import seeds as seeds_mod
    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.ops import cuda_counts, cuda_flat, cuda_scores, encode
    from bammmotif2_tpu_torch.refinement.em import em_step, prepare_data
    from bammmotif2_tpu_torch.refinement.gibbs import occupancy

    outputs = load_by_path("bamm_torch_outputs", "tests/torch_outputs.py")
    K = 2
    sset, _, _, planted, _pos, _has = planted_problem(tmp, tag="flat")
    bg = BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False)
    pwm = np.full((W, 4), 0.1)
    pwm[np.arange(W), planted] = 0.7
    motif = seeds_mod.motif_from_pwm(pwm, K=K, f_bg=sset.base_frequencies())
    data = prepare_data(sset, bg, K, False, device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)  # noqa: E731
    v0 = tuple(f32(vk) for vk in motif.v)
    alphas, f_bg, q0 = f32(motif.alphas), f32(motif.f_bg), f32(0.9)
    R, lens = encode.num_rows(4, K), data["lens"]
    kw = dict(A=4, K=K, W=W)

    reset_launches()
    t0 = time.perf_counter()
    qidx = encode.strand_base5_indices(sset, K, False, device)
    map5 = torch.as_tensor(encode.map_base5_to_combined(4, K), device=device)
    v, q = v0, q0
    for _ in range(FLAT_ITERS):
        C, ll = cuda_flat.em_counts(motif_mod.log_odds_lut(v, data["bg_flat"]), qidx, lens, q,
                                    map5, R=R, **kw)
        v = motif_mod.update_v(motif_mod.counts_from_combined(C[:R], 4, K), alphas, f_bg)
        q = torch.clamp(C.sum(dim=0)[0] / lens.shape[0], 1e-4, 1.0 - 1e-4)  # as em_step
    s_flat = motif_mod.log_odds_lut(v, data["bg_flat"])
    sc, mk = cuda_flat.window_scores(s_flat, qidx, lens, map5, **kw)
    S, N, n_win = sc.shape
    best = sc.permute(1, 0, 2).reshape(N, S * n_win).argmax(dim=1) + 1
    r = occupancy(torch.where(mk.any(dim=1), best, 0)[None], S, qidx.shape[2], n_win)[0]
    Cr = cuda_flat.counts_from_r(r, qidx, map5, R=R, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = launches()
    flat_n = {k: n[k] for k in ("flat_em_counts", "flat_window_scores", "flat_counts_from_r")}
    if flat_n["flat_em_counts"] != FLAT_ITERS or min(flat_n.values()) == 0:
        raise AssertionError(f"flat: launches {n} for {FLAT_ITERS} EM iterations")

    vc, qc = v0, q0
    for _ in range(FLAT_ITERS):
        vc, qc, llc, _vd = em_step(vc, qc, data, alphas, f_bg, A=4, K=K, W=W, optimize_q=True,
                                   path="cuda")
    dv = max((a - b).abs().max().item() for a, b in zip(v, vc))
    consensus = v[0].argmax(dim=0).cpu().numpy()
    b2, b2_mk = cuda_scores.window_scores(s_flat, data["cidx"], lens)
    b3 = cuda_counts.counts_from_r(r, data["cidx"], R, W)
    out = {
        "launches": flat_n,
        "seconds": secs,
        "em_max_abs_dv_vs_combined": dv,
        "q_flat": q.item(), "q_combined": qc.item(),
        "ll_flat": ll.item(), "ll_combined": llc.item(),
        "scores_bit_equal_combined": bool(torch.equal(sc, b2) and torch.equal(mk, b2_mk)),
        "counts_equal_combined": bool(torch.equal(Cr, b3)),
        "occupied_rows": int((r.sum(dim=(0, 2)) > 0).sum().item()),
    }
    log("slice flat (bench geometry 10k x 200 bp, W=12, K=2): " + json.dumps(out))
    if dv > outputs.PROB_TOL or not np.array_equal(consensus, planted):
        raise AssertionError(f"flat: dv {dv} vs the combined kernel, consensus {consensus} "
                             f"vs planted {planted}")
    if not (out["scores_bit_equal_combined"] and out["counts_equal_combined"]):
        raise AssertionError(f"flat: scores or counts differ from the combined kernels: {out}")
    return out


def fdr_trace_slice(tmp) -> dict:
    """tests/test_torch_cuda.py's traced FDR checks (``check_traced_fdr``:
    EM-FDR, unrefined FDR, CGS-FDR and an ``--EM --FDR --profile`` CLI job,
    each traced in a process of its own against the same job untraced)."""
    checks = load_by_path("bamm_torch_cuda_checks", "tests/test_torch_cuda.py")
    out = {}
    for case in sorted(checks.TRACED_FDR_CASES):
        d = os.path.join(tmp, f"traced_{case}")
        os.makedirs(d)
        res = out[case] = checks.check_traced_fdr(case, d)
        log(f"slice traced_fdr {case}: " + json.dumps(
            {k: res[k] for k in ("results_equal", "files_equal", "counts", "device_records",
                                 "em_counts", "fold_loop_iterations", "trace_bytes")}))
    return out


def phase_slice(device, tmp) -> dict:
    examples = os.path.join(ROOT, "examples")
    ex_fa, ex_meme = os.path.join(examples, "positives.fasta"), os.path.join(examples, "seed.meme")
    secs = {}
    t0 = time.perf_counter()
    em_slice("examples", ex_fa, ex_meme, [], device, tmp, compare=True)
    _, fasta, meme, planted, _pos, _has = planted_problem(tmp)
    budget = ["--maxEMIterations", str(FIXED_ITERS)]
    for k in ("2", "4"):
        em_slice(f"10k_k{k}_fixed", fasta, meme, ["-k", k, "-K", "2", *budget],
                 device, tmp, True, planted, eager=k == "2")
    conv = em_slice("10k_k2_converged", fasta, meme, ["-k", "2", "-K", "2"],
                    device, tmp, False, planted)
    meme_m = seeds_meme(tmp, planted, MULTI_SEEDS, "multi")
    for k in MULTI_SEED_ORDERS:
        em_slice(f"10k_M{MULTI_SEEDS}_k{k}_fixed", fasta, meme_m, ["-k", k, "-K", "2", *budget],
                 device, tmp, True)
    secs["em"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    full_slice("examples_scan_fdr", ex_fa, ex_meme,
               ["--EM", "--scoreSeqset", "--FDR", "--savePvalues", "--saveLogOdds"],
               device, tmp, m_fold=10)
    secs["examples_scan_fdr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c5 = config5_slice(device, tmp)
    secs["config5"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c4 = config4_slice(device, tmp)
    secs["config4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cgs = cgs_slices(device, tmp)
    secs["cgs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fdr_program = fdr_program_slice(device, tmp)
    secs["fdr_program"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fdr_traced = fdr_trace_slice(tmp)
    secs["fdr_traced"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = flat_slice(device, tmp)
    secs["flat"] = time.perf_counter() - t0
    log("slice seconds: " + json.dumps(secs))
    return {"em_converged": conv,
            "launches": {"em_counts": conv["launches"],
                         "loop_condition": conv["condition_launches"],
                         "window_scores": c5["launches"]["window_scores"],
                         "counts_from_r": cgs["cgs_10k"]["launches"]["counts_from_r"],
                         "markov_codes": c5["launches"]["markov_codes"],
                         "cgs_z": cgs["cgs_10k"]["launches"]["cgs_z"],
                         "cgs_beta": cgs["cgs_10k"]["launches"]["cgs_beta"],
                         **flat["launches"]},
            "config5": c5, "config4": c4, "cgs": cgs, "fdr_program": fdr_program,
            "fdr_traced": fdr_traced, "flat": flat}


PARALLEL_SWEEPS = 20  # CGS sweeps of the parallel phase
PARALLEL_TIMEOUT = 300  # seconds a group of parallel workers may take
PARALLEL_COMMANDS = {  # the two-rank CLI commands on the planted 10k set
    "em": ["--EM", "-k", "2", "-K", "2", "--maxEMIterations", str(FIXED_ITERS)],
    "cgs": ["--CGS", "-k", "2", "-K", "2", "--maxCGSIterations", str(PARALLEL_SWEEPS)],
}


def reduce_us(group, numel: int, dtype, device, n: int = 50) -> float:
    """Mean µs of ``parallel.mesh.all_reduce`` over ``group`` on a buffer of
    ``numel`` entries on ``device`` (CUDA events around n calls after one
    warm-up); every rank of the group calls it alike."""
    import torch

    from bammmotif2_tpu_torch.parallel import mesh as mesh_mod

    buf = torch.zeros(numel, dtype=dtype, device=device)
    mesh_mod.all_reduce(buf, group)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        mesh_mod.all_reduce(buf, group)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n * 1e3


def reduce_times(group, device) -> dict:
    """The all-reduce of one iteration of the 10k slice: EM sums f64 counts
    [R+1, W] and ll (M=1, K=2, W=12), CGS f32 counts, n_occ and ll.  On a
    gloo group also the EM reduce of a host tensor (host clock), which
    leaves out the staging through host memory."""
    import torch
    import torch.distributed as dist

    from bammmotif2_tpu_torch.ops import encode

    cells = (encode.num_rows(4, 2) + 1) * W
    out = {"em_allreduce_us": reduce_us(group, cells + 1, torch.float64, device),
           "cgs_allreduce_us": reduce_us(group, cells + 2, torch.float32, device)}
    if dist.get_backend(group) == "gloo":
        buf = torch.zeros(cells + 1, dtype=torch.float64)
        dist.all_reduce(buf, group=group)
        t0 = time.perf_counter()
        for _ in range(50):
            dist.all_reduce(buf, group=group)
        out["em_allreduce_host_tensor_us"] = (time.perf_counter() - t0) / 50 * 1e6
    return out


def parallel_worker(kind: str, tmp: str) -> int:
    """One rank of the parallel phase, started by ``phase_parallel`` with
    torchrun's variables set; writes its results to TMP/parallel_KIND_RANK.json.

    nccl: a one-rank NCCL group; FIXED_ITERS EM iterations and
    PARALLEL_SWEEPS CGS sweeps on the planted 10k set, unsharded and on a
    (1, 1) mesh whose every all-reduce goes through NCCL.
    gloo: one of two ranks on one card over gloo; PARALLEL_COMMANDS through
    ``cli.run_pipeline`` on a (2, 1) mesh.
    Each runs twice and reports the second round: the first loads the
    kernels and makes the communicators inside its timed loops.
    """
    import torch
    import torch.distributed as dist

    from bammmotif2_tpu_torch import cli
    from bammmotif2_tpu_torch.models import seeds as seeds_mod
    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.parallel import distributed
    from bammmotif2_tpu_torch.parallel import mesh as mesh_mod
    from bammmotif2_tpu_torch.refinement import graphs as graphs_mod
    from bammmotif2_tpu_torch.refinement.em import run_em
    from bammmotif2_tpu_torch.refinement.gibbs import run_gibbs_multi
    from bammmotif2_tpu_torch.utils.config import Params

    rank = int(os.environ["RANK"])
    out: dict = {"rank": rank}
    if kind == "nccl":
        if not distributed.initialize():
            raise AssertionError("nccl: no process group came up")
        out["backend"] = dist.get_backend()
        if out["backend"] != "nccl":
            raise AssertionError(f"nccl: the backend is {out['backend']}")
        device = torch.device("cuda", torch.cuda.current_device())
        os.makedirs(os.path.join(tmp, "nccl"), exist_ok=True)
        sset, _, _, planted, _pos, _has = planted_problem(os.path.join(tmp, "nccl"))
        bg = BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False)
        pwm = np.full((W, 4), 0.1)
        pwm[np.arange(W), planted] = 0.7
        seed = seeds_mod.motif_from_pwm(pwm, K=2, f_bg=sset.base_frequencies())
        mesh = mesh_mod.make_mesh(1, 1)
        em_params = Params(EM=True, maxEMIterations=FIXED_ITERS, epsilon=0.0)
        cgs_params = Params(CGS=True, maxCGSIterations=PARALLEL_SWEEPS)
        runs = {}
        graphs_mod.clear()
        # round 1 warms up (and captures); round 2 replays the cached graphs
        for name, m in (("unsharded", None), ("mesh", mesh)) * 2:
            em_m, cgs_m = seed.copy(), seed.copy()
            reset_launches()
            em_r = run_em(em_m, bg, sset, em_params, device=device, mesh=m)
            cgs_r = run_gibbs_multi([cgs_m], bg, sset, cgs_params, device=device, mesh=m)[0]
            runs[name] = (em_m, em_r, cgs_m, cgs_r, launches())
        # the rule: NCCL's all-reduce joins the graph; each loop captured once
        # unsharded and once on the mesh, and replayed by round 2
        got = sorted((c["name"], c["calls"]) for c in graphs_mod.stats())
        if got != [("CGS sweep loop", 2)] * 2 + [("EM loop", 2)] * 2:
            raise AssertionError(f"nccl: loops captured {graphs_mod.stats()}")
        (em0, r0, cgs0, g0, _), (em1, r1, cgs1, g1, n1) = runs["unsharded"], runs["mesh"]
        out.update({
            "em_iterations": r1.iterations,
            "em_bit_equal": all(np.array_equal(a, b) for a, b in zip(em0.v, em1.v))
            and (r0.ll, r0.q) == (r1.ll, r1.q),
            "cgs_bit_equal": all(np.array_equal(a, b) for a, b in zip(cgs0.v, cgs1.v))
            and g0.q == g1.q,
            "launches": n1,
            "em_iters_per_s": {"unsharded": r0.iterations / r0.seconds,
                               "mesh_1x1": r1.iterations / r1.seconds},
            "cgs_sweeps_per_s": {"unsharded": g0.iterations / g0.seconds,
                                 "mesh_1x1": g1.iterations / g1.seconds},
            **reduce_times(mesh.data_group, device),
        })
    else:
        if not distributed.initialize(backend="gloo"):
            raise AssertionError("gloo: no process group came up")
        device = torch.device("cuda", torch.cuda.current_device())
        mesh = distributed.auto_mesh(1)
        out["mesh"] = mesh.shape
        for tag, extra in [*PARALLEL_COMMANDS.items()] * 2:  # round 1 warms up
            outdir = os.path.join(tmp, f"parallel_{tag}_rank{rank}")
            params = cli.params_from_args([outdir, os.path.join(tmp, "parallel.fasta"), "--PWMFile",
                                           os.path.join(tmp, "parallel.meme"), "--jsonl", *extra])
            graphs_mod.clear()
            reset_launches()
            res = cli.run_pipeline(params, device, mesh)
            if graphs_mod.stats():  # the rule: gloo stages through host memory, eager
                raise AssertionError(f"gloo {tag}: loops captured {graphs_mod.stats()}")
            r = res["em_results" if tag == "em" else "cgs_results"][0]
            out[tag] = {"launches": launches(), "iterations": r.iterations,
                        "per_s": r.iterations / r.seconds, "files": len(res["files"])}
        out.update(reduce_times(mesh.data_group, device))
    with open(os.path.join(tmp, f"parallel_{kind}_{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def run_workers(kind: str, world: int, tmp: str) -> list:
    """Start ``world`` ranks of ``parallel_worker(kind)`` (LOCAL_RANK 0: one
    card; OMP_NUM_THREADS 1 unless set, as torchrun sets it), wait for them
    within PARALLEL_TIMEOUT (killing all if one hangs), and return their
    results; raises if any failed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"),
                   WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker", kind, tmp],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + PARALLEL_TIMEOUT
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel {kind} rank {rank} failed ({p.returncode}):\n"
                                 f"{text[-4000:]}")
    results = []
    for rank in range(world):
        with open(os.path.join(tmp, f"parallel_{kind}_{rank}.json")) as fh:
            results.append(json.load(fh))
    return results


def phase_parallel(device, tmp) -> dict:
    """parallel/ on the one card: a one-rank NCCL group, then two ranks over
    gloo, each against the single process (module docstring, phase 4)."""
    outputs = load_by_path("bamm_torch_outputs", "tests/torch_outputs.py")
    (nccl,) = run_workers("nccl", 1, tmp)
    if not (nccl["em_bit_equal"] and nccl["cgs_bit_equal"]):
        raise AssertionError(f"parallel nccl: the (1, 1) mesh run differs: {nccl}")
    n = nccl["launches"]
    if min(n["em_counts"], n["window_scores"], n["counts_from_r"]) < min(
            nccl["em_iterations"], PARALLEL_SWEEPS) or nccl["em_iterations"] != FIXED_ITERS:
        raise AssertionError(f"parallel nccl: launches {n} for {FIXED_ITERS} iterations and "
                             f"{PARALLEL_SWEEPS} sweeps")
    log("parallel nccl, one rank, (1, 1) mesh: " + json.dumps(nccl))

    _, fasta, meme, _planted, _pos, _has = planted_problem(tmp, tag="parallel")
    ranks = run_workers("gloo", 2, tmp)
    out = {"nccl_1rank": nccl, "gloo_2rank": ranks, "single": {}}
    kernels = {"em": ("em_counts",), "cgs": ("window_scores", "counts_from_r")}
    for tag, extra in PARALLEL_COMMANDS.items():
        single = run_cli(os.path.join(tmp, f"parallel_{tag}_single"), fasta, meme, extra, device)
        done = single["events"][f"{tag}_done"][0]
        out["single"][tag] = {"launches": single["launches"], "iterations": done["iterations"],
                              "per_s": done["iterations"] / done["seconds"]}
        for r in ranks:
            got = r[tag]
            if got["iterations"] != done["iterations"] or any(
                    got["launches"][k] < got["iterations"] for k in kernels[tag]):
                raise AssertionError(f"parallel gloo {tag} rank {r['rank']}: {got} against "
                                     f"{done['iterations']} single-process iterations")
        if ranks[1][tag]["files"] or os.path.exists(os.path.join(tmp, f"parallel_{tag}_rank1")):
            raise AssertionError(f"parallel gloo {tag}: rank 1 wrote files")
        dirs = (os.path.join(tmp, f"parallel_{tag}_rank0"),
                os.path.join(tmp, f"parallel_{tag}_single"))
        cmp = outputs.compare_dirs(*dirs, refined=True)
        out[f"{tag}_max_abs_dp"] = cmp["max_dp"]
        out[f"{tag}_files_equal"] = files_equal(*dirs)
    if not out["cgs_files_equal"]:
        raise AssertionError("parallel gloo cgs: rank 0's files differ from the single process's")
    rates = {
        "em_iters_per_s": {"world1": out["single"]["em"]["per_s"],
                           "world1_nccl_mesh": nccl["em_iters_per_s"]["mesh_1x1"],
                           "world2_gloo": [r["em"]["per_s"] for r in ranks]},
        "cgs_sweeps_per_s": {"world1": out["single"]["cgs"]["per_s"],
                             "world1_nccl_mesh": nccl["cgs_sweeps_per_s"]["mesh_1x1"],
                             "world2_gloo": [r["cgs"]["per_s"] for r in ranks]},
        "allreduce_us": {"nccl_1rank": {k: v for k, v in nccl.items() if k.endswith("_us")},
                         "gloo_2rank": [{k: v for k, v in r.items() if k.endswith("_us")}
                                        for r in ranks]},
        "gpu": nvidia_smi(),
    }
    log("parallel gloo, two ranks on one card, (2, 1) mesh: " + json.dumps(
        {k: v for k, v in out.items() if k != "nccl_1rank"}))
    log("parallel rates (10k x 200 bp, K=2, W=12; CLI loop seconds): " + json.dumps(rates))
    out["rates"] = rates
    return out


def time_cuda(fn, n: int) -> float:
    """Mean ms per call over n calls after one warm-up (CUDA events)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_em(device, tmp) -> dict:
    import torch

    from bammmotif2_tpu_torch.models import seeds as seeds_mod
    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.models.motif import log_odds_lut
    from bammmotif2_tpu_torch.ops import cuda_em
    from bammmotif2_tpu_torch.refinement.em import em_step, prepare_data

    sset, _, _, planted, _pos, _has = planted_problem(tmp)
    bg = BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False)
    pwm = np.full((W, 4), 0.1)
    pwm[np.arange(W), planted] = 0.7
    motif = seeds_mod.motif_from_pwm(pwm, K=2, f_bg=sset.base_frequencies())
    data = prepare_data(sset, bg, 2, False, device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)  # noqa: E731
    v0 = tuple(f32(vk) for vk in motif.v)
    alphas, f_bg, q0 = f32(motif.alphas), f32(motif.f_bg), f32(0.9)
    n_win = 2 * int(np.maximum(sset.lens - W + 1, 0).sum())  # bench.py:69

    s_flat = log_odds_lut(v0, data["bg_flat"])[None].contiguous()
    args = (s_flat, data["cidx"], data["lens"], q0.reshape(1))
    out = {
        "kernel_ms": time_cuda(lambda: cuda_em.em_counts_multi(*args), N_TIMED),
        "plain_ms": time_cuda(lambda: cuda_em.em_counts_multi_ref(*args), N_TIMED),
        **em_bound(data["cidx"], data["lens"], s_flat.shape[1], W, 1),
        "library_ms": None,
    }
    out["device"] = em_device_times(device)
    out["kernel_device_ms"] = out["device"]["K2_M1"]["kernel_device_ms"]
    for path in ("cuda", "plain"):
        def loop(n):
            v, q = v0, q0
            for _ in range(n):
                v, q, _ll, _vd = em_step(v, q, data, alphas, f_bg, N_SEQS, A=4, K=2, W=W,
                                         optimize_q=True, path=path)
            return v

        loop(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(N_TIMED)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[f"em_windows_per_s_{path}"] = n_win * N_TIMED / dt
        out[f"em_iters_per_s_{path}"] = N_TIMED / dt
    log("timing em_counts (bench geometry 10k x 200 bp, W=12, K=2, S=2, M=1): " + json.dumps(out))
    return out


EM_DEVICE_CASES = {  # bench's geometry (10k x 200 bp, S=2, W=12); kernel_inputs options
    "K2_M1": dict(K=2, M=1), "K2_M4": dict(K=2, M=4), "K4_M1": dict(K=4, M=1),
    "K4_M4": dict(K=4, M=4), "K2_M1_homopolymer": dict(K=2, M=1, homopolymer=True),
}


def em_inputs(name: str, device) -> tuple:
    """(s_flat, cidx, lens, q) of EM_DEVICE_CASES[name]
    (tests/test_torch_cuda.py's kernel_inputs)."""
    checks = load_by_path("bamm_torch_cuda_checks", "tests/test_torch_cuda.py")
    return checks.kernel_inputs(N=N_SEQS, L=SEQ_LEN, W=W, S=2, device=device,
                                **EM_DEVICE_CASES[name])


def em_device_times(device) -> dict:
    """em_counts_kernel's device time (torch.profiler, 10 calls) and its
    launch plan on each of EM_DEVICE_CASES."""
    from bammmotif2_tpu_torch.ops import cuda_em
    from bammmotif2_tpu_torch.tools.ab import device_ms

    out = {}
    for name in EM_DEVICE_CASES:
        args = em_inputs(name, device)
        M, R1, _w = args[0].shape
        plan = cuda_em.launch_plan(M, R1, W, 2, SEQ_LEN)
        out[name] = {**device_ms(lambda: cuda_em.em_counts_multi(*args), 10, "em_counts_kernel"),
                     "plan": plan._asdict()}
    return out


def c5_inputs(device, tmp) -> tuple:
    """Config 5's geometry (100k x 200 bp, S=2, K=2): (cidx, lens, the
    planted PWM's log-odds LUT [R+1, W])."""
    import torch

    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.models.motif import log_odds_lut
    from bammmotif2_tpu_torch.models import seeds as seeds_mod
    from bammmotif2_tpu_torch.ops import encode

    sset, _, _, planted, _pos, _has = planted_problem(tmp, C5_SEQS, "c5_timing")
    bg = BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False)
    pwm = np.full((W, 4), 0.1)
    pwm[np.arange(W), planted] = 0.7
    motif = seeds_mod.motif_from_pwm(pwm, K=2, f_bg=sset.base_frequencies())
    cidx, lens = encode.strand_indices(sset, 2, False, device)
    bg_flat = torch.as_tensor(bg.conditional_flat(2), dtype=torch.float32, device=device)
    base = log_odds_lut(tuple(torch.as_tensor(v, dtype=torch.float32, device=device)
                              for v in motif.v), bg_flat)
    return cidx, lens, base, sset


def c5_luts(base, M: int):
    """M LUTs: the planted PWM's, then scaled copies (numpy seed 1), zero
    sentinel row."""
    import torch

    rng = np.random.default_rng(1)
    s_flat = torch.stack([base] + [
        base * float(rng.uniform(0.6, 1.4)) for _ in range(M - 1)]).contiguous()
    s_flat[:, -1, :] = 0.0
    return s_flat


def time_scores(device, tmp) -> dict:
    """window_scores_multi vs plain at config 5's geometry, M=1 and M=10,
    with the bytes it moves (cidx read, scores and mask written), its bound,
    the kernel's device time (torch.profiler) and, at M=1, the library
    call's time and the flat window-score kernel on the same sequences and
    LUT (CUDA events, and its device time)."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_flat, cuda_scores, encode
    from bammmotif2_tpu_torch.tools.ab import device_ms

    cidx, lens, base, sset = c5_inputs(device, tmp)
    out = {}
    S, N, L = cidx.shape
    n_win = L - W + 1
    for M in (1, 10):
        s_flat = c5_luts(base, M)
        args = (s_flat, cidx, lens)
        ms = time_cuda(lambda: cuda_scores.window_scores_multi(*args), N_TIMED)
        plain_ms = time_cuda(lambda: cuda_scores.window_scores_multi_ref(*args), 5 if M > 1 else N_TIMED)
        nbytes = S * N * L * 4 + M * S * N * n_win * 4 + N * n_win
        out[f"M{M}"] = {
            "ms": ms, "plain_ms": plain_ms,
            "bytes": nbytes, "kernel_GB_per_s": nbytes / ms / 1e6,
            "share_of_3.35TB_per_s": nbytes / ms / 1e6 / 3350.0,
            "windows_per_s": M * S * N * n_win / ms * 1e3,
            **scores_bound(cidx, lens, s_flat.shape[1], W, M),
            **device_ms(lambda: cuda_scores.window_scores_multi(*args), 10, "window_scores_kernel"),
        }
    out["M1"]["library_ms"] = library_scores_ms(base, cidx, W)
    qidx = encode.strand_base5_indices(sset, 2, False, device)
    map5 = torch.as_tensor(encode.map_base5_to_combined(4, 2), device=device)
    args = (base, qidx, lens, map5)
    kw = dict(A=4, K=2, W=W)
    out["flat_M1"] = {
        "ms": time_cuda(lambda: cuda_flat.window_scores(*args, **kw), N_TIMED),
        "plain_ms": time_cuda(lambda: cuda_flat.window_scores_ref(*args, **kw), 5),
        "combined_ms": out["M1"]["ms"],
        **device_ms(lambda: cuda_flat.window_scores(*args, **kw), 10, "flat_scores_kernel"),
        "combined_kernel_device_ms": out["M1"]["kernel_device_ms"],
        **scores_bound(qidx, lens, base.shape[0], W, 1, extra=map5.numel() * 4),
    }
    log("timing window_scores (config 5 geometry 100k x 200 bp, W=12, K=2, S=2): "
        + json.dumps(out))
    return out


def time_counts(device) -> dict:
    """counts_from_r_multi vs plain at bench's geometry with the sampler's
    0/1 r, M=1 and M=10: the wrapper's ms (CUDA events), its host µs a call
    (tools/ab.py's host_us), the device ms of the kernel alone and of the
    whole call (torch.profiler), the bound, and the index_add_ call's ms
    with its index built beforehand and inside the timed call."""
    from bammmotif2_tpu_torch.ops import cuda_counts
    from bammmotif2_tpu_torch.tools.ab import device_ms, host_us

    checks = load_by_path("bamm_torch_cuda_checks", "tests/test_torch_cuda.py")
    out = {}
    for M in (1, 10):
        args = checks.counts_inputs(N=N_SEQS, L=SEQ_LEN, W=W, K=2, M=M, S=2, r="01", device=device)
        r, cidx, R, _w = args
        fn = lambda: cuda_counts.counts_from_r_multi(*args)  # noqa: E731
        out[f"M{M}"] = {
            "ms": time_cuda(fn, N_TIMED),
            "plain_ms": time_cuda(lambda: cuda_counts.counts_from_r_multi_ref(*args),
                                  5 if M > 1 else N_TIMED),
            **device_ms(fn, 10, "counts_kernel"),
            "host_us": host_us(fn),
            "r_bytes": r.numel() * 4,
            "nonzero_r": int((r != 0).sum().item()),
            **counts_bound(r, cidx, R + 1, W),
            "library_ms": library_counts_ms(r, cidx, R + 1, W),
            "library_with_index_ms": library_counts_ms(r, cidx, R + 1, W, index_inside=True),
        }
    log("timing counts_from_r (bench geometry 10k x 200 bp, W=12, K=2, S=2, 0/1 r): "
        + json.dumps(out))
    return out


def time_flat(device) -> dict:
    """The flat kernels (ops/cuda_flat.py) against their plain versions and
    the combined-layout kernels (B1-B3) on the same sequences and LUT, at
    bench's geometry (10k x 200 bp, W=12) at K=2, 3 and 4, with the
    sampler's 0/1 r for the counts: the wrapper's time (CUDA events) and
    host µs a call (tools/ab.py's host_us), the device time of the
    hand-written kernel alone and of the whole call (torch.profiler), each
    function's bound and, for scores and counts, the library call's time
    (for the counts also with its index built inside the timed call)."""
    from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em, cuda_flat, cuda_scores
    from bammmotif2_tpu_torch.tools.ab import device_ms, host_us

    checks = load_by_path("bamm_torch_cuda_checks", "tests/test_torch_cuda.py")
    out = {}
    for K in (2, 3, 4):
        x = checks.flat_inputs(N=N_SEQS, L=SEQ_LEN, W=W, K=K, S=2, device=device)
        kw, R, map_bytes = dict(A=4, K=K, W=W), x["R"], x["map5"].numel() * 4
        em = (x["s_flat"], x["qidx"], x["lens"], x["q"], x["map5"])
        sc = (x["s_flat"], x["qidx"], x["lens"], x["map5"])
        cr = (x["r"]["01"], x["qidx"], x["map5"])
        s5 = x["s_flat"][x["map5"].long()]
        calls = {  # function: (flat call, combined call, flat kernel, combined kernel)
            "em": (lambda: cuda_flat.em_counts(*em, R=R, **kw),
                   lambda: cuda_em.em_counts_multi(x["s_multi"], x["cidx"], x["lens"], x["q"]),
                   "flat_em_kernel", "em_counts_kernel"),
            "scores": (lambda: cuda_flat.window_scores(*sc, **kw),
                       lambda: cuda_scores.window_scores(x["s_flat"], x["cidx"], x["lens"]),
                       "flat_scores_kernel", "window_scores_kernel"),
            "counts": (lambda: cuda_flat.counts_from_r(*cr, R=R, **kw),
                       lambda: cuda_counts.counts_from_r(x["r"]["01"], x["cidx"], R, W),
                       "flat_counts_kernel", "counts_kernel"),
        }
        plain = {"em": lambda: cuda_flat.em_counts_ref(*em, R=R, **kw),
                 "scores": lambda: cuda_flat.window_scores_ref(*sc, **kw),
                 "counts": lambda: cuda_flat.counts_from_r_ref(*cr, R=R, **kw)}
        res = {}
        for fn_name, (flat_fn, comb_fn, flat_k, comb_k) in calls.items():
            fdev, cdev = device_ms(flat_fn, 10, flat_k), device_ms(comb_fn, 10, comb_k)
            res[fn_name] = {
                "ms": time_cuda(flat_fn, N_TIMED),
                "plain_ms": time_cuda(plain[fn_name], 10),
                "combined_ms": time_cuda(comb_fn, N_TIMED),
                "host_us": host_us(flat_fn),
                **fdev,
                "combined_kernel_device_ms": cdev["kernel_device_ms"],
                "combined_call_device_ms": cdev["call_device_ms"],
            }
        res["em"].update(em_bound(x["qidx"], x["lens"], R + 1, W, 1, extra=map_bytes),
                         library_ms=None)
        res["scores"].update(scores_bound(x["qidx"], x["lens"], R + 1, W, 1, extra=map_bytes),
                             library_ms=library_scores_ms(s5, x["qidx"], W))
        res["counts"].update(counts_bound(x["r"]["01"], x["qidx"], R + 1, W, extra=map_bytes),
                             library_ms=library_counts_ms(x["r"]["01"], x["cidx"], R + 1, W),
                             library_with_index_ms=library_counts_ms(
                                 x["r"]["01"], x["cidx"], R + 1, W, index_inside=True))
        out[f"K{K}"] = res
        log(f"timing flat kernels (bench geometry 10k x 200 bp, W=12, K={K}, S=2, M=1): "
            + json.dumps(res))
    return out


def profile_window(fn) -> dict:
    """torch.profiler over one call of ``fn``: wall ms, the device's busy
    ms and idle share, kernels launched and the largest kernels' ms."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / wall_us if busy_us else "not measured",
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }


def time_cgs(device, tmp) -> dict:
    """CGS sweeps/s at bench's geometry, kernel path and plain at M=1 and
    the kernel path at M=10 (ten chains of the planted PWM), each with its
    sweep loop graphed (the default, one WHILE-node graph a run:
    ``sweeps_per_s_PATH[_M10]``) and eager (``..._eager``), in turns, every
    timed run after an untimed one of the same length (so the graphed one
    launches a cached loop graph); at M=1 and M=10 the loop graph's body
    nodes (a sweep's device operations: ``graphs.stats``' node types) and
    torch.profiler windows over 10 sweeps of the kernel path, graphed and
    eager: the device's busy and idle share and its largest kernels.
    Every run is under torch.cuda.set_sync_debug_mode("error"): the sweep
    loop, its capture included, must not synchronise."""
    import torch

    from bammmotif2_tpu_torch.models import seeds as seeds_mod
    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.refinement import gibbs
    from bammmotif2_tpu_torch.refinement import graphs as graphs_mod
    from bammmotif2_tpu_torch.refinement.em import prepare_data

    sset, _, _, planted, _pos, _has = planted_problem(tmp, tag="cgs_timing")
    bg = BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False)
    pwm = np.full((W, 4), 0.1)
    pwm[np.arange(W), planted] = 0.7
    motif = seeds_mod.motif_from_pwm(pwm, K=2, f_bg=sset.base_frequencies())
    data = prepare_data(sset, bg, 2, False, device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)  # noqa: E731
    f_bg = f32(motif.f_bg)

    def sweeps(path, n, graphed, M=1):
        v0 = tuple(f32(np.stack([vk] * M)) for vk in motif.v)
        alphas, q0 = f32(np.stack([motif.alphas] * M)), f32([0.9] * M)
        keys = gibbs.input_keys(0, range(M), device)
        torch.cuda.set_sync_debug_mode("error")  # the sweep loop must not sync
        try:
            out = gibbs.gibbs_optimize(v0, q0, torch.log(alphas), keys, data, f_bg, alphas,
                                       float(N_SEQS), A=4, K=2, W=W, sample_z=True,
                                       sample_q=True, learn_alpha=True, path=path, n_iters=n,
                                       graphs=graphed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return out

    out = {}
    runs = [("cuda", True, 1), ("cuda", False, 1), ("plain", True, 1), ("plain", False, 1),
            ("cuda", True, 10), ("cuda", False, 10)]
    for path, graphed, M in runs + runs[::-1]:
        sweeps(path, N_TIMED, graphed, M)
        t0 = time.perf_counter()
        sweeps(path, N_TIMED, graphed, M)
        key = f"sweeps_per_s_{path}" + ("" if graphed else "_eager") + ("" if M == 1 else f"_M{M}")
        out.setdefault(key, []).append(N_TIMED / (time.perf_counter() - t0))
    for M in (1, 10):
        graphs_mod.clear()
        sweeps("cuda", 10, True, M)  # the loop graph of 10 sweeps at M
        (loop,) = [c for c in graphs_mod.stats() if c["name"] == "CGS sweep loop"]
        out[f"body_nodes_M{M}"] = {"types": loop["body_nodes"],
                                   "total": sum(loop["body_nodes"].values())}
        for tag, graphed in (("graphed", True), ("eager", False)):
            sweeps("cuda", 10, graphed, M)
            out[f"profiled_10_sweeps_{tag}_M{M}"] = profile_window(
                lambda: sweeps("cuda", 10, graphed, M))
    graphs_mod.settle()
    out["gpu"] = nvidia_smi()
    log("timing CGS sweeps (bench geometry 10k x 200 bp, W=12, K=2, M=1 and 10): "
        + json.dumps(out))
    return out


def z_bound(M: int, N: int, C: int, clock_mhz: float | None = None) -> dict:
    """cgs_z's bound on [M, N, C] logits: the logits and keys read, z
    written; a gumbel-shifted logit an element; a hash an element and a
    row (the row's fold_in) and one a chain (its split)."""
    from bammmotif2_tpu_torch.ops.cuda_draws import GUMBEL_F32_OPS

    return hash_bound(M * N * C * 4 + M * 16 + M * N * 8, M * N * C * GUMBEL_F32_OPS,
                      M * N * (C + 1) + M, clock_mhz)


def beta_bound(attempts, draw: bool = True, clock_mhz: float | None = None) -> dict:
    """cgs_beta's bound for the attempts int32 [M, 2] that this call's
    gammas took (``draw`` False: the sweep's three splits alone): a, b and
    the keys read, the keys and q written; the chains' and the gammas'
    Threefry hashes (cuda_draws.BETA_CHAIN_HASHES, GAMMA_HASHES,
    ATTEMPT_HASHES); a chain's few hundred float operations are left out."""
    from bammmotif2_tpu_torch.ops import cuda_draws as d

    M = attempts.shape[0]
    hashes = M * 3 if not draw else (
        M * (d.BETA_CHAIN_HASHES + 2 * d.GAMMA_HASHES)
        + int(attempts.long().sum()) * d.ATTEMPT_HASHES)
    return hash_bound(2 * 16 * M + 8 * M + 4 * M, 0, hashes, clock_mhz)


DRAW_MS = (1, 10, 16)  # chains of time_draws' cgs_z and cgs_beta
BETA_ROUNDS = 12  # interleaved rounds of cgs_beta against its library call


def interleaved(fns: dict, n: int, rounds: int) -> dict:
    """Each of ``fns`` (name -> call) timed by ``time_cuda`` over n calls,
    in ``rounds`` rounds that take them in turn (the order flipping each
    round): per name the rounds' ms, median, min and max, and "p" the
    two-sided Mann-Whitney p of the first two names' rounds."""
    from scipy import stats

    names = list(fns)
    runs = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            runs[name].append(time_cuda(fns[name], n))
    out = {name: {"runs": v, "median": float(np.median(v)), "min": min(v), "max": max(v)}
           for name, v in runs.items()}
    out["p"] = float(stats.mannwhitneyu(runs[names[0]], runs[names[1]],
                                        alternative="two-sided").pvalue)
    return out


def time_draws(device, tmp) -> dict:
    """The draw kernels (ops/cuda_draws.py) against their plain versions at
    their paths' shapes: markov_codes on config 5's 1M x 200 bp negatives
    (``c5_negative_inputs``) and on config 4's fold (the first 20k of
    them: 2,000 held-out rows x --mFold 10); cgs_z at M = DRAW_MS on
    bench's 10k rows of C = 379 logits (W=12, both strands, 189 windows
    each); and cgs_beta at M = DRAW_MS.  Each: the wrapper's ms (CUDA
    events over back-to-back calls), its kernel's device ms
    (torch.profiler), its host µs a call, its plain version's ms and its
    bound (``hash_bound``: bytes, f32 operations, and the Threefry hashes'
    32-bit integer operations; markov_codes hashes a letter a position of
    each row and L splits); cgs_z beside the library calls that draw the
    same distribution from a generator (torch.rand of the logits' shape,
    then the argmax of logits plus -log(-log(u))), cgs_beta beside
    torch._standard_gamma of the 2M shapes, the two timed in BETA_ROUNDS
    interleaved rounds (``interleaved``: ms and library_ms are the
    medians); markov_codes has no library call."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_draws
    from bammmotif2_tpu_torch.tools.ab import device_ms, host_us

    out = {}
    key, trans, lens, s_order = c5_negative_inputs(device, tmp)
    table = sum(t.numel() for t in trans) * 4
    for tag, n in (("markov_config4_fold", 20_000), ("markov_config5", lens.numel())):
        ln = lens[:n].contiguous()
        call = lambda ln=ln: cuda_draws.markov_codes(key, trans, ln, L=SEQ_LEN,  # noqa: E731
                                                     s_order=s_order, A=4)
        draws = int(ln.long().sum()) * 4  # a gumbel a letter and position
        out[tag] = {
            "rows": n, "ms": time_cuda(call, 5 if n > 100_000 else 50),
            "plain_ms": time_cuda(lambda ln=ln: cuda_draws.markov_codes_ref(
                key, trans, ln, L=SEQ_LEN, s_order=s_order, A=4), 1),
            **device_ms(call, 3 if n > 100_000 else 20, "markov_codes_kernel", attempts=6),
            "host_us": host_us(call, 20),
            **hash_bound(n * 4 + table + 16 + n * SEQ_LEN,
                         draws * cuda_draws.GUMBEL_F32_OPS, draws + SEQ_LEN),
            "library_ms": None,
        }
    C = 1 + 2 * (SEQ_LEN - W + 1)
    for M in DRAW_MS:
        flat = torch.randn((M, N_SEQS, C), generator=torch.Generator().manual_seed(M)).to(device)
        keys = torch.as_tensor(np.random.default_rng(M).integers(0, 2 ** 32, (M, 2)),
                               device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        call = lambda flat=flat, keys=keys: cuda_draws.cgs_z(flat, keys)  # noqa: E731

        def library(flat=flat, gen=gen):
            u = torch.rand(flat.shape, generator=gen, device=device)
            return torch.argmax(flat - torch.log(-torch.log(u)), dim=-1)

        out[f"z_M{M}"] = {
            "ms": time_cuda(call, 100),
            "plain_ms": time_cuda(lambda flat=flat, keys=keys: cuda_draws.cgs_z_ref(flat, keys), 3),
            **device_ms(call, 10, "cgs_z_kernel"),
            "host_us": host_us(call),
            **z_bound(M, N_SEQS, C),
            "library_ms": time_cuda(library, 50),
        }
        del flat
    for M in DRAW_MS:
        keys = torch.as_tensor(np.random.default_rng(M).integers(0, 2 ** 32, (M, 2)),
                               device=device)
        a = torch.full((M,), 8_001.0, device=device)
        b = torch.full((M,), 2_000.0, device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        beta = lambda a=a, b=b, keys=keys: cuda_draws.cgs_beta(a, b, keys, 1e-4, 1 - 1e-4)  # noqa: E731
        ab = torch.cat([a, b])
        _q, attempts = cuda_draws.cgs_beta(a, b, keys.clone(), 1e-4, 1 - 1e-4, attempts=True)
        rounds = interleaved({"ms": beta, "library_ms": lambda ab=ab, gen=gen:
                              torch._standard_gamma(ab, generator=gen)}, 200, BETA_ROUNDS)
        out[f"beta_M{M}"] = {
            "ms": rounds["ms"]["median"],
            "plain_ms": time_cuda(lambda a=a, b=b, keys=keys: cuda_draws.cgs_beta_ref(
                a, b, keys, 1e-4, 1 - 1e-4), 5),
            **device_ms(beta, 10, "cgs_beta_kernel"),
            "host_us": host_us(beta),
            **beta_bound(attempts),
            "library_ms": rounds["library_ms"]["median"],
            "vs_library": rounds,
        }
    out["gpu"] = nvidia_smi()
    log("timing draws (config 4's and config 5's negatives; 10k rows of 379 logits and q at M="
        + "/".join(map(str, DRAW_MS)) + "): " + json.dumps(out))
    return out


LOOP_ITERS = 200  # EM iterations of a fixed-budget timing run (epsilon 0)
LOOP_MS = (1, 4, 10, 16)  # seeds a group of the graphed EM rates
FIRST_USE_ORDERS = ("kernel_first", "plain_first", "plain_first", "kernel_first")


def loops_problem(tmp: str) -> dict:
    """The loops' timing problem: bench's planted set (FASTA, its planted
    PWM's MEME), a MEME of four width-W seeds (the planted PWM, then softer
    ones: 0.7 - 0.05 m on the planted base) and the set's background."""
    from bammmotif2_tpu_torch.models import seeds as seeds_mod
    from bammmotif2_tpu_torch.models.background import BackgroundModel

    sset, fasta, meme, planted, _pos, _has = planted_problem(tmp, tag="loops")
    pwms = []
    for m in range(4):
        pwm = np.full((W, 4), (0.3 + 0.05 * m) / 3)
        pwm[np.arange(W), planted] = 0.7 - 0.05 * m
        pwms.append((f"seed{m + 1}", pwm))
    meme4 = os.path.join(tmp, "loops4.meme")
    write_meme(meme4, pwms)
    return {"sset": sset, "fasta": fasta, "meme": meme, "meme4": meme4,
            "bg": BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False),
            "seeds": [seeds_mod.motif_from_pwm(p, K=2, f_bg=sset.base_frequencies())
                      for _, p in pwms]}


def em_rate(device, prob: dict, M: int, graphed: bool, params=None) -> tuple:
    """(its/s of the loop's seconds, iterations) of one EM run of the first
    M seeds of ``prob``: run_em at M=1, run_em_multi else; ``params``
    defaults to LOOP_ITERS iterations at epsilon 0."""
    from bammmotif2_tpu_torch.refinement import multi
    from bammmotif2_tpu_torch.refinement.em import run_em
    from bammmotif2_tpu_torch.utils.config import Params

    params = params or Params(EM=True, maxEMIterations=LOOP_ITERS, epsilon=0.0, optimizeQ=True)
    seeds, sset, bg = prob["seeds"], prob["sset"], prob["bg"]
    if M == 1:
        r = run_em(seeds[0].copy(), bg, sset, params, device=device, graphs=graphed)
        return r.iterations / r.seconds, r.iterations
    rs = multi.run_em_multi([m.copy() for m in seeds[:M]], bg, sset, params, device=device,
                            graphs=graphed)
    return max(r.iterations for r in rs) / rs[0].group_seconds, max(r.iterations for r in rs)


def loop_rates(device, tmp: str, prob: dict, graphed: bool) -> dict:
    """One mode's loop rates on ``loops_problem``, each timed run after an
    untimed one of the same shape (so a graphed run replays a cached
    capture): EM its/s at a fixed budget (LOOP_ITERS, epsilon 0) at M=1
    (run_em) and M=4 (run_em_multi); the CLI's --EM stage at M=1 and 4
    (em_done: the slowest seed's iterations over the group's seconds; the
    graph cache emptied first, as a fresh process starts); CGS sweeps/s of
    gibbs_optimize (N_TIMED sweeps, M=1, the kernel path); graphed, the
    capture ms of the EM loops and the CGS loop."""
    import torch

    from bammmotif2_tpu_torch.refinement import gibbs
    from bammmotif2_tpu_torch.refinement import graphs as graphs_mod
    from bammmotif2_tpu_torch.refinement.em import prepare_data

    out = {}
    graphs_mod.clear()
    for M in (1, 4):
        em_rate(device, prob, M, graphed)
        out[f"em_its_per_s_M{M}"] = em_rate(device, prob, M, graphed)[0]
    data = prepare_data(prob["sset"], prob["bg"], 2, False, device)
    seed = prob["seeds"][0]
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)  # noqa: E731
    alphas = f32(seed.alphas)[None]

    def sweeps():
        gibbs.gibbs_optimize(tuple(f32(vk)[None] for vk in seed.v), f32([0.9]), torch.log(alphas),
                             gibbs.input_keys(0, [0], device), data, f32(seed.f_bg), alphas,
                             float(N_SEQS), A=4, K=2, W=W, sample_z=True, sample_q=True,
                             learn_alpha=True, path="cuda", n_iters=N_TIMED, graphs=graphed)
        torch.cuda.synchronize()

    sweeps()
    t0 = time.perf_counter()
    sweeps()
    out["cgs_sweeps_per_s_M1"] = N_TIMED / (time.perf_counter() - t0)
    caps = {c["name"]: c["capture_ms"] for c in graphs_mod.stats()}
    for name in ("EM loop", "CGS sweep loop"):
        out[f"capture_ms_{name.split()[0]}"] = caps.get(name, "not measured")
    for M, meme in ((1, prob["meme"]), (4, prob["meme4"])):
        r = run_cli(os.path.join(tmp, f"loops_cli_M{M}_{time.monotonic_ns()}"), prob["fasta"],
                    meme, ["--EM", "-k", "2", "-K", "2", "-e", "0", "--maxEMIterations",
                           str(LOOP_ITERS), "--optimizeQ"], device, graphs=graphed)
        ev = r["events"]["em_done"]
        out[f"cli_em_its_per_s_M{M}"] = (max(e["iterations"] for e in ev)
                                         / sum(e["seconds"] for e in ev))
    return out


def first_use_runs(device, tmp: str, fasta: str, meme: str, order: str) -> dict:
    """The --CGS stage through the kernels and under --no-pallas, in
    ``order`` (kernel_first or plain_first): each run's cgs_done seconds and
    CLI seconds.  Its point is a fresh process: call it first."""
    runs = ("kernel", "plain") if order == "kernel_first" else ("plain", "kernel")
    out = {"order": order}
    for run in runs:
        extra = ["--CGS", "-k", "2", "-K", "2"] + (["--no-pallas"] if run == "plain" else [])
        r = run_cli(os.path.join(tmp, f"first_use_{os.getpid()}_{run}"), fasta, meme, extra,
                    device)
        out[run] = {"cgs_seconds": r["events"]["cgs_done"][0]["seconds"],
                    "cli_seconds": r["seconds"]}
    return out


def first_use_worker(order: str, tmp: str) -> int:
    """A fresh process's ``first_use_runs`` on the planted 10k set of
    ``cgs_slices`` (TMP/cgs.fasta, TMP/cgs.meme); prints one line
    ``FIRST_USE {...}``."""
    import torch

    out = first_use_runs(torch.device("cuda"), tmp, os.path.join(tmp, "cgs.fasta"),
                         os.path.join(tmp, "cgs.meme"), order)
    print("FIRST_USE " + json.dumps(out), flush=True)
    return 0


def first_use(tmp: str) -> list:
    """FIRST_USE_ORDERS, one fresh process each, one after the other."""
    results = []
    for order in FIRST_USE_ORDERS:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--first-use", order, tmp],
                              cwd=ROOT, capture_output=True, text=True, timeout=PARALLEL_TIMEOUT)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("FIRST_USE ")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"first-use {order} failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        results.append(json.loads(lines[-1][len("FIRST_USE "):]))
    return results


def graphed_em_rates(device, tmp) -> dict:
    """Graphed EM its/s on bench's set at K=2 and 4 for each M of LOOP_MS
    (``tools/ab.py::seeds_problem``'s seeds): at a fixed budget
    (LOOP_ITERS, epsilon 0) and converged (the default epsilon; its
    iterations beside it), each timed run after an untimed one of its
    shape, whose loop graph it launches again."""
    from bammmotif2_tpu_torch.tools.ab import seeds_problem
    from bammmotif2_tpu_torch.utils.config import Params

    out = {}
    converged = Params(EM=True, optimizeQ=True)
    for K in (2, 4):
        prob = seeds_problem(sys.modules[__name__], tmp, K, max(LOOP_MS))
        for M in LOOP_MS:
            em_rate(device, prob, M, True)
            out[f"fixed_K{K}_M{M}"] = em_rate(device, prob, M, True)[0]
            em_rate(device, prob, M, True, converged)
            rate, its = em_rate(device, prob, M, True, converged)
            out[f"converged_K{K}_M{M}"] = rate
            out[f"converged_iterations_K{K}_M{M}"] = its
    return out


def time_loops(device, tmp, slices: dict) -> dict:
    """The device-resident loops (refinement/graphs.py) on bench's problem:
    ``loop_rates`` eager and graphed in turns (eager, graphed, graphed,
    eager) in this process; ``graphed_em_rates``; the captures and graphed
    loop calls of the slices' CLI runs; and first use: the --CGS stage
    seconds of fresh processes, kernel path first and plain path first
    (FIRST_USE_ORDERS)."""
    prob = loops_problem(tmp)
    out: dict = {"rates": {}}
    for graphed in (False, True, True, False):
        for k, x in loop_rates(device, tmp, prob, graphed).items():
            out["rates"].setdefault(f"{k}_{'graphed' if graphed else 'eager'}", []).append(x)
    out["graphed_em"] = graphed_em_rates(device, tmp)
    cgs = slices["cgs"]
    out["captures_per_cli_run"] = {
        name: {"captures": len(c), "loop_calls": sum(x["calls"] for x in c),
               "capture_ms": [x["capture_ms"] for x in c]}
        for name, c in (("em_10k_converged", slices["em_converged"]["captures"]),
                        ("cgs_10k", cgs["cgs_10k"]["captures"]),
                        ("config4_em_fdr", slices["config4"]["captures"]),
                        ("config4_cgs_fdr", cgs["config4_cgs"]["captures"]))}
    out["first_use_cgs_stage"] = first_use(tmp)
    out["gpu"] = nvidia_smi()
    log("timing loops (bench geometry 10k x 200 bp, W=12, K=2; eager against graphed): "
        + json.dumps(out))
    return out


def time_condition(device) -> dict:
    """The EM loop's stop-test kernel (``cuda_while.condition``) against its
    plain version at M=16 (a multi-seed --EM group's stack), CUDA events
    over back-to-back calls: it reads its [M], vds [M], cap and eps and
    writes one byte; M float comparisons (vds against eps) and 2 M integer
    operations (its against cap, the join); also its kernel's device ms
    (torch.profiler) and its host µs a call."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_while
    from bammmotif2_tpu_torch.tools.ab import device_ms, host_us

    M = 16
    its = torch.arange(M, dtype=torch.int32, device=device)
    vds = torch.linspace(0.5, 1.0, M, device=device)
    cap = torch.tensor(1000, dtype=torch.int32, device=device)
    eps = torch.tensor(1e-3, device=device)
    running = torch.tensor(False, device=device)
    call = lambda: cuda_while.condition(its, vds, cap, eps, running)  # noqa: E731
    out = {"ms": time_cuda(call, 200),
           "plain_ms": time_cuda(
               lambda: running.copy_(cuda_while.condition_ref(its, vds, cap, eps)), 200),
           **device_ms(call, 20, "loop_condition_kernel", attempts=6),
           "host_us": host_us(call),
           **bound(8 * M + 4 + 4 + 1, M, 2 * M, 2 * M), "library_ms": None, "M": M}
    log("timing loop_condition (M=16): " + json.dumps(out))
    return out


WHILE_ITERS = 2_000  # iterations of time_while_node's loops


def time_while_node(device) -> dict:
    """The device loop's own cost an iteration, apart from its body's work:
    a body of two small kernels (adds to a [16] float buffer and to the
    iteration counter) run WHILE_ITERS times through graphs.Loop, as one
    launch of its WHILE-node loop graph (with the stop test's kernel after
    each iteration: the route of EM's and CGS's loops) and as a replay an
    iteration of its captured graph (the route of a loop on an NCCL mesh,
    and of CGS before the sweep index moved to the device), each timed
    after an untimed run that captures it: µs an iteration, host clock
    around a synchronised run."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_while
    from bammmotif2_tpu_torch.refinement import graphs as graphs_mod
    from bammmotif2_tpu_torch.refinement.multi import UNTIL

    def body(s, _gens):
        s["x"].add_(1.0)
        s["its"].add_(1)

    def run(on_device: bool) -> float:
        s = {"x": torch.zeros(16, device=device),
             "its": torch.zeros(1, dtype=torch.int32, device=device),
             "vds": torch.full((1,), float("inf"), device=device),
             "cap": torch.full((), WHILE_ITERS, dtype=torch.int32, device=device),
             "eps": torch.zeros((), device=device)}
        s["running"] = cuda_while.condition_ref(*(s[k] for k in UNTIL[1:]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with graphs_mod.Loop("while node timing", ("while node timing",), s, {}, body,
                             until=UNTIL if on_device else None) as loop:
            if on_device:
                loop.run_while()
            else:
                loop.run(WHILE_ITERS)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / WHILE_ITERS * 1e6

    out = {}
    for tag, on_device in (("replay", False), ("while", True)) * 2:
        run(on_device)  # captures
        out.setdefault(f"{tag}_us_an_iteration", []).append(run(on_device))
    graphs_mod.settle()
    out["iterations"] = WHILE_ITERS
    out["gpu"] = nvidia_smi()
    log("timing the device loop's own cost (a body of two small kernels): " + json.dumps(out))
    return out


def time_fdr_group(device, tmp) -> dict:
    """Config 4's (W=10, K=2) group through the group program, EM-FDR and
    CGS-FDR: its seconds and where they go, read from the program's spans
    (``utils.metrics``): each run under an active trace, after an untraced
    run that builds and captures; per run the ``fdr.group`` seconds, and
    the self seconds of each span in it (``fdr.prepare``, ``fdr.folds``,
    ``fdr.fetch``, ``fdr.sweeps``, ``fdr.group`` itself, ``graph.capture``)
    summed by name, with the trace's counters."""
    import torch

    from bammmotif2_tpu_torch.evaluation import fdr
    from bammmotif2_tpu_torch.tools import fdr_split
    from bammmotif2_tpu_torch.utils import metrics

    out = {}
    for refine in ("EM", "CGS"):
        seeds, bg, pos, params = fdr_split.problem(sys.modules[__name__], tmp, refine, 10)
        fdr.evaluate_motifs([m.copy() for m in seeds], bg, pos, params, device=device)
        runs = []
        for _ in range(3):
            with metrics.tracing() as trace:
                fdr.evaluate_motifs([m.copy() for m in seeds], bg, pos, params, device=device)
            torch.cuda.synchronize(device)
            spans = trace.spans
            own = metrics.self_seconds(spans)
            stages: dict = {}
            for sp in spans:
                stages[sp["name"]] = stages.get(sp["name"], 0.0) + own[sp["id"]]
            (group,) = [sp for sp in spans if sp["name"] == "fdr.group"]
            runs.append({"group_seconds": (group["end_ns"] - group["start_ns"]) / 1e9,
                         "stages": stages, "counts": trace.counts})
        out[refine] = runs
    out["gpu"] = nvidia_smi()
    log("timing FDR group program (config 4, W=10, K=2; fdr.* spans): " + json.dumps(out))
    return out


def phase_timing(device, tmp, slices: dict) -> dict:
    out = {"em": time_em(device, tmp), "scores": time_scores(device, tmp),
           "counts": time_counts(device), "flat": time_flat(device), "cgs": time_cgs(device, tmp),
           "condition": time_condition(device), "draws": time_draws(device, tmp),
           "while_node": time_while_node(device),
           "loops": time_loops(device, tmp, slices), "fdr_group": time_fdr_group(device, tmp)}
    c5, c4 = slices["config5"], slices["config4"]
    e2e = {
        "config5_scan_windows_per_s_kernel": c5["scan_windows_per_s_kernel"],
        "config5_scan_windows_per_s_plain": c5["scan_windows_per_s_plain"],
        "config4_fdr_group_seconds_kernel": c4["fdr_group_seconds_kernel"],
        "config4_cgs_fdr_group_seconds_kernel":
            slices["cgs"]["config4_cgs"]["cgs_fdr_group_seconds_kernel"],
        "cgs_10k_cli_seconds_kernel": slices["cgs"]["cgs_10k"]["cli_seconds_kernel"],
        "cgs_10k_cli_seconds_plain": slices["cgs"]["cgs_10k"]["cli_seconds_plain"],
        "gpu": nvidia_smi(),
    }
    log("timing end to end: " + json.dumps(e2e))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    csrc = os.path.join(ROOT, "bammmotif2_tpu_torch", "csrc")
    if not all(os.path.isfile(os.path.join(csrc, f"{n}.cu")) for n in KERNEL_SOURCES):
        print(f"chip_smoke: the port's sources are not beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    device = torch.device("cuda")

    t_all = time.perf_counter()
    phase_secs = {}
    t0 = time.perf_counter()
    phase_build()
    phase_secs["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    max_err = phase_kernel(device)
    phase_secs["kernel"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        slices = phase_slice(device, tmp)
        phase_secs["slice"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_parallel(device, tmp)
        phase_secs["parallel"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        timing = phase_timing(device, tmp, slices)
        phase_secs["timing"] = time.perf_counter() - t0
    phase_secs["total"] = time.perf_counter() - t_all
    log("phase seconds: " + json.dumps(phase_secs))
    flat = timing["flat"]["K2"]
    rows = [  # name, source, TPU kernel, timing entry
        ("em_counts", "em_counts.cu", "bammmotif2_tpu/ops/pallas_em.py:345",
         {**timing["em"], "ms": timing["em"]["kernel_ms"]}),
        ("window_scores", "window_scores.cu", "bammmotif2_tpu/ops/pallas_em.py:800",
         timing["scores"]["M1"]),
        ("counts_from_r", "counts_from_r.cu", "bammmotif2_tpu/ops/pallas_em.py:639",
         timing["counts"]["M1"]),
        ("flat_em_counts", "flat.cu", "tools/pallas_flat.py:267", flat["em"]),
        ("flat_window_scores", "flat.cu", "tools/pallas_flat.py:378", flat["scores"]),
        ("flat_counts_from_r", "flat.cu", "tools/pallas_flat.py:447", flat["counts"]),
        # not Pallas kernels: the device side of the reference's lax.while_loop,
        # and its jax.random draws: the negatives' sampler, CGS's z and q
        ("loop_condition", "while_loop.cu", "bammmotif2_tpu/refinement/multi.py:303",
         timing["condition"]),
        ("markov_codes", "jax_draws.cu", "bammmotif2_tpu/generator/seqgen.py:29",
         timing["draws"]["markov_config5"]),
        ("cgs_z", "jax_draws.cu", "bammmotif2_tpu/refinement/gibbs.py:379",
         timing["draws"]["z_M1"]),
        ("cgs_beta", "jax_draws.cu", "bammmotif2_tpu/refinement/gibbs.py:390",
         timing["draws"]["beta_M1"]),
    ]
    kernels = []
    for name, src, tpu, t in rows:
        entry = {"name": name, "route": "cuda", "source": f"bammmotif2_tpu_torch/csrc/{src}",
                 "replaces": tpu, "launches": slices["launches"][name],
                 "max_abs_err": max_err[name]}
        entry.update({k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        entry.update({k: t[k] for k in ("bound_term", "combined_ms", "kernel_device_ms",
                                        "call_device_ms",
                                        "combined_kernel_device_ms", "host_us",
                                        "library_with_index_ms") if k in t})
        kernels.append(entry)
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel did not launch on its path: {kernels}")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.path.insert(0, ROOT)
        sys.exit(parallel_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--first-use"]:
        sys.path.insert(0, ROOT)
        sys.exit(first_use_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
