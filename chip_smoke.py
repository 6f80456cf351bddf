#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bammmotif2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   : nvcc builds csrc/em_counts.cu, csrc/window_scores.cu,
               csrc/counts_from_r.cu and csrc/flat.cu in parallel; prints
               the toolchain, the card and the ptxas resource reports.
  2. kernel  : each of the six kernels against its plain PyTorch version on
               the card at the main paths' geometries (tests/test_torch_cuda.py:
               KERNEL_CASES / check_kernel, SCORE_CASES / check_scores,
               COUNTS_CASES / check_counts, FLAT_CASES / check_flat; the
               last also holds the flat kernels to the combined-layout ones
               on the same sequences), and check_counts_calls: each
               counts-from-r call is one kernel, its workspace cleans
               itself across calls, shapes and streams, and a CUDA graph
               of a call replays right.
  3. slice   : every path through the CLI, once through the kernels and once
               under --no-pallas, with every kernel's launch count set to 0
               just before each run and read just after:
               - --EM on examples/ and on a planted 10k x 200 bp set at -k 2
                 and -k 4: written models agree, the refined consensus is
                 the planted motif, the E+M kernel launched at least once per
                 iteration.  The 10k comparisons run a fixed budget of
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
                 per chunk scored;
               - BASELINE config 4: 10k x 200 bp, 3 planted motifs, 10 seeds
                 of widths 8/10/12, --EM --optimizeQ --FDR -q 0.5 with
                 sampled negatives (--mFold 10, --cvFold 5) at a fixed
                 --maxEMIterations 20 (agreement as on examples/), then
                 converged through the kernels: finite .stats, AvRec ZOOPS
                 >= 0.25 for the three unperturbed seeds, both kernels
                 launched;
               - --CGS -k 2 -K 2 on the planted 10k x 200 bp set at the
                 default 100 sweeps: written files agree (equal files are
                 expected: both paths draw the same numbers, window scores
                 are bit-equal and 0/1 counts exact), the consensus is the
                 planted motif, the window-score and counts-from-r kernels
                 launched at least once per sweep;
               - --EM --CGS on examples/: files agree, all three kernels
                 launched;
               - config 4 with --CGS --FDR (per-fold CGS) compared at
                 --maxCGSIterations 20, then through the kernels at the
                 default 100: AvRec ZOOPS >= 0.25 for the planted seeds;
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
  4. timing  : each kernel against its plain version (CUDA events): E+M at
               bench.py's geometry (10k x 200 bp, W=12, K=2), window scores
               at config 5's (100k x 200 bp, W=12, K=2) at M=1 and M=10,
               counts-from-r at bench's geometry with the sampler's 0/1 r at
               M=1 and M=10 (also the kernel's and the whole call's device
               time and the wrapper's host µs a call); the flat kernels at
               bench's geometry at K=2, 3 and 4 beside the combined-layout
               kernels on the same sequences (CUDA events, and each
               kernel's device time under torch.profiler; the counts'
               host µs), and flat window scores at config 5's; the
               E+M kernel's device time at bench's geometry at K=2 and 4,
               M=1 and 4 (and on homopolymer rows), the window-score
               kernel's at config 5's at M=1 and 10; each
               kernel's bound (bytes over 3.35 TB/s or f32 operations over
               67 TFLOP/s, whichever is larger) and, where one PyTorch call computes
               the same function (embedding_bag for window scores on an
               index built beforehand, index_add_ for counts from r with its
               index built beforehand and, beside it, inside the timed
               call), that call's time; EM windows/s and iterations/s; CGS sweeps/s at
               bench's geometry (kernel and plain, and the device's busy
               share under torch.profiler); config 5's end-to-end scan
               windows/s and config 4's EM-FDR and CGS-FDR seconds per
               (W, K) group.
The line before the last holds the card's name and power limit as
nvidia-smi reports them; the last line is {"ok": true, "device": {...}}.
Imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCES = ("em_counts", "window_scores", "counts_from_r", "flat")

# bench.py's problem
N_SEQS, SEQ_LEN, W, N_TIMED = 10_000, 200, 12, 30
FIXED_ITERS = 40  # 10k comparison budget; dll there is >> the f32 spacing
C5_SEQS = 100_000  # BASELINE config 5: a 100k-sequence scan
C5_MFOLD = 10
C4_MOTIFS = ["TGACTCAG", "CACGTGACTT", "GGGGCGGGGCCA"]  # W = 8, 10, 12
C4_SEEDS = 10
CGS_FIXED_SWEEPS = 20  # config 4's CGS-FDR comparison budget
FLAT_ITERS = 40  # EM iterations of the flat slice, compared at a fixed budget
# the card's peaks (H100 SXM datasheet, 700 W): device
# memory bandwidth, and f32 arithmetic outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em, cuda_flat, cuda_scores

    return {"em_counts": cuda_em.em_counts_multi,
            "window_scores": cuda_scores.window_scores_multi,
            "counts_from_r": cuda_counts.counts_from_r_multi,
            "flat_em_counts": cuda_flat.em_counts,
            "flat_window_scores": cuda_flat.window_scores,
            "flat_counts_from_r": cuda_flat.counts_from_r}


def launches() -> dict:
    return {name: fn.launches for name, fn in counted().items()}


def reset_launches() -> None:
    for fn in counted().values():
        fn.launches = 0


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the bytes a function must move
    (each input read once, each output written once) over HBM_BYTES_PER_S,
    or its f32 operations over F32_OPS_PER_S, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


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

    from bammmotif2_tpu_torch.ops import _build, cuda_counts, cuda_em, cuda_flat, cuda_scores

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:  # one nvcc per source, together
        paths = list(ex.map(_build.library_path, KERNEL_SOURCES))
    cuda_em.library()
    cuda_scores.library()
    cuda_counts.library()
    cuda_flat.library()
    secs = time.perf_counter() - t0
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"toolchain: torch {torch.__version__} | cuda {torch.version.cuda} | "
        f"nvcc {nvcc} | gpu {nvidia_smi()}")
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
    return worst


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


def run_cli(outdir: str, fasta: str, meme: str, extra: list, device) -> dict:
    """One CLI run; returns its metrics events by kind (lists), the launches
    each kernel made in it (counts zeroed just before) and its seconds."""
    from bammmotif2_tpu_torch import cli

    reset_launches()
    t0 = time.perf_counter()
    cli.main([outdir, fasta, "--PWMFile", meme, "--jsonl", *extra], device=device)
    secs = time.perf_counter() - t0
    n = launches()
    base = os.path.splitext(os.path.basename(fasta))[0]
    events = runs_events(os.path.dirname(outdir), os.path.basename(outdir), base)
    return {"events": events, "launches": n, "seconds": secs, "base": base}


def run_pair(tag: str, fasta: str, meme: str, extra: list, device, tmp: str) -> tuple:
    """The same command through the kernels and under --no-pallas; the plain
    run must launch no kernel."""
    k = run_cli(os.path.join(tmp, tag + "_kernel"), fasta, meme, extra, device)
    p = run_cli(os.path.join(tmp, tag + "_plain"), fasta, meme, [*extra, "--no-pallas"], device)
    if any(p["launches"].values()):
        raise AssertionError(f"{tag}: --no-pallas run launched a kernel: {p['launches']}")
    return k, p


def check_consensus(tag: str, dirs: tuple, base: str, motif: str, planted) -> None:
    from bammmotif2_tpu_torch.models.motif import Motif

    for d in dirs:
        consensus = Motif.read(os.path.join(d, f"{base}_{motif}.ihbcp")).v[0].argmax(axis=0)
        if not np.array_equal(consensus, planted):
            raise AssertionError(f"{tag}: consensus {consensus} != planted {planted}")


def em_slice(tag, fasta, meme, extra, device, tmp, compare, planted=None) -> dict:
    """The --EM slice through the kernel, then under --no-pallas; checks
    launches, (with ``compare``) agreement of the two paths with equal
    iteration counts, and (with ``planted``) the refined consensus."""
    outputs = load_by_path("bamm_torch_outputs", "tests/torch_outputs.py")
    k, p = run_pair(tag, fasta, meme, ["--EM", *extra], device, tmp)
    ev_k, ev_p = k["events"]["em_done"], p["events"]["em_done"]
    its = max(e["iterations"] for e in ev_k)
    n = k["launches"]["em_counts"]
    if n < its or n == 0:
        raise AssertionError(f"{tag}: {n} kernel launches for {its} EM iterations")
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
    out = {
        "compared": compare,
        "launches": n,
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
    neg_windows = C5_MFOLD * ev["windows"]
    out = {
        "launches": k["launches"],
        "chunks_scored": chunks,
        "occurrences": ev["hits"],
        "planted_recovered": recovered,
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


def config4_slice(device, tmp) -> dict:
    """BASELINE config 4: 10 seeds, EM + FDR with sampled negatives."""
    fasta, meme = config4_problem(tmp)
    extra = ["--maxPWM", str(C4_SEEDS), "--EM", "--optimizeQ", "--FDR", "-q", "0.5",
             "--mFold", "10", "--cvFold", "5"]
    _k, fixed = full_slice("config4_fixed", fasta, meme, [*extra, "--maxEMIterations", "20"],
                           device, tmp, m_fold=10)
    conv = run_cli(os.path.join(tmp, "config4_converged"), fasta, meme, extra, device)
    if not (conv["launches"]["em_counts"] and conv["launches"]["window_scores"]):
        raise AssertionError(f"config4: a kernel did not launch: {conv['launches']}")
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
    sweeps = k["events"]["cgs_done"][0]["iterations"]
    if min(k["launches"]["window_scores"], k["launches"]["counts_from_r"]) < sweeps:
        raise AssertionError(f"cgs_10k: {k['launches']} for {sweeps} sweeps")
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
    fdr = full["events"]["fdr_done"]
    avrec = {e["motif"]: e["avrec_zoops"] for e in fdr}
    if min(avrec[f"motif_{s + 1}"] for s in range(len(C4_MOTIFS))) < 0.25:
        raise AssertionError(f"config4 CGS: AvRec ZOOPS of the planted seeds {avrec}")
    c4 = {
        "fixed": fixed,
        "launches": full["launches"],
        "avrec_zoops": avrec,
        "cgs_fdr_group_seconds_kernel": {f"W{e['W']}_K{e['K']}": e["group_seconds"] for e in fdr},
        "cli_seconds": full["seconds"],
    }
    log("slice config4 CGS (10 seeds, --CGS --FDR, 100 sweeps): " + json.dumps(c4))
    return {"cgs_10k": main, "examples_em_cgs": em_cgs, "config4_cgs": c4}


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
                 device, tmp, True, planted)
    conv = em_slice("10k_k2_converged", fasta, meme, ["-k", "2", "-K", "2"],
                    device, tmp, False, planted)
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
    flat = flat_slice(device, tmp)
    secs["flat"] = time.perf_counter() - t0
    log("slice seconds: " + json.dumps(secs))
    return {"launches": {"em_counts": conv["launches"],
                         "window_scores": c5["launches"]["window_scores"],
                         "counts_from_r": cgs["cgs_10k"]["launches"]["counts_from_r"],
                         **flat["launches"]},
            "config5": c5, "config4": c4, "cgs": cgs, "flat": flat}


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
    LUT."""
    import torch

    from bammmotif2_tpu_torch.ops import cuda_flat, cuda_scores, encode

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
    from bammmotif2_tpu_torch.tools.ab import host_us

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


def device_ms(fn, n: int, kernel: str, attempts: int = 3) -> dict:
    """Device time per call under torch.profiler over n calls after one
    warm-up: of the __global__ function ``kernel`` alone, and of every
    kernel the call launches (the wrapper's torch ops included).  A window
    that traced no event of ``kernel`` (the profiler of a long process
    sometimes returns no device event at all) is retried, ``attempts``
    times in all."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        own = [e for e in evs if f"::{kernel}(" in e.key or f"::{kernel}<" in e.key]
        if own:
            break
        log(f"device_ms: no device event of {kernel} among {[e.key[:60] for e in evs]} "
            f"(window {attempt + 1} of {attempts})")
    if not own:
        return {"kernel_device_ms": "not measured", "call_device_ms": "not measured"}
    return {"kernel_device_ms": sum(e.self_device_time_total for e in own) / n / 1e3,
            "call_device_ms": sum(e.self_device_time_total for e in evs) / n / 1e3}


def time_flat(device) -> dict:
    """The flat kernels (ops/cuda_flat.py) against their plain versions and
    the combined-layout kernels (B1-B3) on the same sequences and LUT, at
    bench's geometry (10k x 200 bp, W=12) at K=2, 3 and 4, with the
    sampler's 0/1 r for the counts: the wrapper's time (CUDA events), the
    device time of the hand-written kernel alone and of the whole call
    (torch.profiler), each function's bound and, for scores and counts, the
    library call's time (for the counts also with its index built inside
    the timed call, and the wrapper's host µs a call)."""
    from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em, cuda_flat, cuda_scores
    from bammmotif2_tpu_torch.tools.ab import host_us

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
                **fdev,
                "combined_kernel_device_ms": cdev["kernel_device_ms"],
                "combined_call_device_ms": cdev["call_device_ms"],
            }
        res["em"].update(em_bound(x["qidx"], x["lens"], R + 1, W, 1, extra=map_bytes),
                         library_ms=None)
        res["scores"].update(scores_bound(x["qidx"], x["lens"], R + 1, W, 1, extra=map_bytes),
                             library_ms=library_scores_ms(s5, x["qidx"], W))
        res["counts"].update(counts_bound(x["r"]["01"], x["qidx"], R + 1, W, extra=map_bytes),
                             host_us=host_us(calls["counts"][0]),
                             library_ms=library_counts_ms(x["r"]["01"], x["cidx"], R + 1, W),
                             library_with_index_ms=library_counts_ms(
                                 x["r"]["01"], x["cidx"], R + 1, W, index_inside=True))
        out[f"K{K}"] = res
        log(f"timing flat kernels (bench geometry 10k x 200 bp, W=12, K={K}, S=2, M=1): "
            + json.dumps(res))
    return out


def time_cgs(device, tmp) -> dict:
    """CGS sweeps/s at bench's geometry (one chain), kernel path and plain,
    and a torch.profiler window over the kernel path's sweeps: the device's
    busy share and its largest kernels."""
    import torch
    from torch.autograd import DeviceType

    from bammmotif2_tpu_torch.models import seeds as seeds_mod
    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.refinement import gibbs
    from bammmotif2_tpu_torch.refinement.em import prepare_data

    sset, _, _, planted, _pos, _has = planted_problem(tmp, tag="cgs_timing")
    bg = BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False)
    pwm = np.full((W, 4), 0.1)
    pwm[np.arange(W), planted] = 0.7
    motif = seeds_mod.motif_from_pwm(pwm, K=2, f_bg=sset.base_frequencies())
    data = prepare_data(sset, bg, 2, False, device)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)  # noqa: E731
    v0 = tuple(f32(vk)[None] for vk in motif.v)
    alphas, f_bg, q0 = f32(motif.alphas)[None], f32(motif.f_bg), f32([0.9])

    def sweeps(path, n):
        gens = gibbs.chain_generators(0, [0], device)
        torch.cuda.set_sync_debug_mode("error")  # the sweep loop must not sync
        try:
            out = gibbs.gibbs_optimize(v0, q0, torch.log(alphas), gens, data, f_bg, alphas,
                                       float(N_SEQS), A=4, K=2, W=W, sample_z=True,
                                       sample_q=True, learn_alpha=True, path=path, n_iters=n)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return out

    out = {}
    for path in ("cuda", "plain", "cuda", "plain"):
        sweeps(path, 2)
        t0 = time.perf_counter()
        sweeps(path, N_TIMED)
        out.setdefault(f"sweeps_per_s_{path}", []).append(N_TIMED / (time.perf_counter() - t0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sweeps("cuda", 10)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out["profiled_10_sweeps"] = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / wall_us if busy_us else "not measured",
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }
    # does a CUDA generator give row n the same uniform when rows follow it?
    u = [torch.rand(N_SEQS + extra, generator=torch.Generator(device=device).manual_seed(1),
                    device=device)[:N_SEQS] for extra in (0, 7)]
    out["cuda_rand_prefix_equal"] = bool(torch.equal(*u))
    log("timing CGS sweeps (bench geometry 10k x 200 bp, W=12, K=2, M=1): " + json.dumps(out))
    return out


def phase_timing(device, tmp, slices: dict) -> dict:
    out = {"em": time_em(device, tmp), "scores": time_scores(device, tmp),
           "counts": time_counts(device), "flat": time_flat(device), "cgs": time_cgs(device, tmp)}
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
    ]
    kernels = []
    for name, src, tpu, t in rows:
        entry = {"name": name, "route": "cuda", "source": f"bammmotif2_tpu_torch/csrc/{src}",
                 "replaces": tpu, "launches": slices["launches"][name],
                 "max_abs_err": max_err[name]}
        entry.update({k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        entry.update({k: t[k] for k in ("combined_ms", "kernel_device_ms", "call_device_ms",
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
    sys.exit(main())
