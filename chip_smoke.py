#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bammmotif2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build   : nvcc builds csrc/em_counts.cu and csrc/window_scores.cu in
               parallel; prints the toolchain, the card and both ptxas
               resource reports.
  2. kernel  : each kernel against its plain PyTorch version on the card at
               the main paths' geometries (tests/test_torch_cuda.py:
               KERNEL_CASES / check_kernel, SCORE_CASES / check_scores).
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
                 launched.
  4. timing  : each kernel against its plain version (CUDA events): E+M at
               bench.py's geometry (10k x 200 bp, W=12, K=2), window scores
               at config 5's (100k x 200 bp, W=12, K=2) at M=1 and M=10; EM
               windows/s and iterations/s; config 5's end-to-end scan
               windows/s and config 4's FDR seconds per (W, K) group.
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
KERNEL_SOURCES = ("em_counts", "window_scores")

# bench.py's problem
N_SEQS, SEQ_LEN, W, N_TIMED = 10_000, 200, 12, 30
FIXED_ITERS = 40  # 10k comparison budget; dll there is >> the f32 spacing
C5_SEQS = 100_000  # BASELINE config 5: a 100k-sequence scan
C5_MFOLD = 10
C4_MOTIFS = ["TGACTCAG", "CACGTGACTT", "GGGGCGGGGCCA"]  # W = 8, 10, 12
C4_SEEDS = 10


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


def launches() -> dict:
    from bammmotif2_tpu_torch.ops import cuda_em, cuda_scores

    return {"em_counts": cuda_em.em_counts_multi.launches,
            "window_scores": cuda_scores.window_scores_multi.launches}


def reset_launches() -> None:
    from bammmotif2_tpu_torch.ops import cuda_em, cuda_scores

    cuda_em.em_counts_multi.launches = 0
    cuda_scores.window_scores_multi.launches = 0


def phase_build():
    import torch

    from bammmotif2_tpu_torch.ops import _build, cuda_em, cuda_scores

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:  # one nvcc per source, together
        paths = list(ex.map(_build.library_path, KERNEL_SOURCES))
    cuda_em.library()
    cuda_scores.library()
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
    worst = {"em_counts": 0.0, "window_scores": 0.0}
    for name, case in checks.KERNEL_CASES.items():
        res = checks.check_kernel(case, device)
        worst["em_counts"] = max(worst["em_counts"], res["max_abs_err"])
        log(f"kernel em_counts {name}: " + json.dumps({k: float(v) for k, v in res.items()}))
    for name, case in checks.SCORE_CASES.items():
        res = checks.check_scores(case, device)
        worst["window_scores"] = max(worst["window_scores"], res["max_abs_err"])
        log(f"kernel window_scores {name}: " + json.dumps({k: float(v) for k, v in res.items()}))
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
    from bammmotif2_tpu.utils.alphabet import Alphabet
    from bammmotif2_tpu.utils.fasta import SequenceSet, write_fasta

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
    from bammmotif2_tpu.utils.alphabet import Alphabet
    from bammmotif2_tpu.utils.fasta import SequenceSet, write_fasta
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
    events: dict = {}
    with open(os.path.join(outdir, f"{base}.metrics.jsonl")) as fh:
        for e in map(json.loads, fh):
            events.setdefault(e["event"], []).append(e)
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


def full_slice(tag, fasta, meme, extra, device, tmp, m_fold) -> tuple:
    """--EM --scoreSeqset/--FDR through the kernels and under --no-pallas:
    every written file agrees (tests/torch_outputs.py, refined models), and
    both kernels launched in the kernel run."""
    outputs = load_by_path("bamm_torch_outputs", "tests/torch_outputs.py")
    k, p = run_pair(tag, fasta, meme, extra, device, tmp)
    if not all(k["launches"].values()):
        raise AssertionError(f"{tag}: a kernel did not launch: {k['launches']}")
    cmp = outputs.compare_dirs(os.path.join(tmp, tag + "_kernel"), os.path.join(tmp, tag + "_plain"),
                               refined=True, m_fold=m_fold)
    out = {
        "launches": k["launches"],
        "files_compared": cmp["files"],
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
    if not all(conv["launches"].values()):
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
    log("slice seconds: " + json.dumps(secs))
    return {"em_launches": conv["launches"], "scan_launches": c5["launches"]["window_scores"],
            "config5": c5, "config4": c4}


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
    }
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


def time_scores(device, tmp) -> dict:
    """window_scores_multi vs plain at config 5's geometry, M=1 and M=10,
    with the bytes it moves (cidx read, scores and mask written)."""
    import torch

    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.models.motif import log_odds_lut
    from bammmotif2_tpu_torch.models import seeds as seeds_mod
    from bammmotif2_tpu_torch.ops import cuda_scores, encode

    sset, _, _, planted, _pos, _has = planted_problem(tmp, C5_SEQS, "c5_timing")
    bg = BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False)
    pwm = np.full((W, 4), 0.1)
    pwm[np.arange(W), planted] = 0.7
    motif = seeds_mod.motif_from_pwm(pwm, K=2, f_bg=sset.base_frequencies())
    cidx, lens = encode.strand_indices(sset, 2, False, device)
    bg_flat = torch.as_tensor(bg.conditional_flat(2), dtype=torch.float32, device=device)
    base = log_odds_lut(tuple(torch.as_tensor(v, dtype=torch.float32, device=device)
                              for v in motif.v), bg_flat)
    rng = np.random.default_rng(1)
    out = {}
    S, N, L = cidx.shape
    n_win = L - W + 1
    for M in (1, 10):
        s_flat = torch.stack([base] + [
            base * float(rng.uniform(0.6, 1.4)) for _ in range(M - 1)]).contiguous()
        s_flat[:, -1, :] = 0.0
        args = (s_flat, cidx, lens)
        ms = time_cuda(lambda: cuda_scores.window_scores_multi(*args), N_TIMED)
        plain_ms = time_cuda(lambda: cuda_scores.window_scores_multi_ref(*args), 5 if M > 1 else N_TIMED)
        nbytes = S * N * L * 4 + M * S * N * n_win * 4 + N * n_win
        out[f"M{M}"] = {
            "ms": ms, "plain_ms": plain_ms,
            "bytes": nbytes, "kernel_GB_per_s": nbytes / ms / 1e6,
            "share_of_3.35TB_per_s": nbytes / ms / 1e6 / 3350.0,
            "windows_per_s": M * S * N * n_win / ms * 1e3,
        }
    log("timing window_scores (config 5 geometry 100k x 200 bp, W=12, K=2, S=2): "
        + json.dumps(out))
    return out


def phase_timing(device, tmp, slices: dict) -> dict:
    out = {"em": time_em(device, tmp), "scores": time_scores(device, tmp)}
    c5, c4 = slices["config5"], slices["config4"]
    e2e = {
        "config5_scan_windows_per_s_kernel": c5["scan_windows_per_s_kernel"],
        "config5_scan_windows_per_s_plain": c5["scan_windows_per_s_plain"],
        "config4_fdr_group_seconds_kernel": c4["fdr_group_seconds_kernel"],
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
    kernels = [{
        "name": "em_counts",
        "route": "cuda",
        "source": "bammmotif2_tpu_torch/csrc/em_counts.cu",
        "replaces": "bammmotif2_tpu/ops/pallas_em.py:345",
        "launches": slices["em_launches"],
        "max_abs_err": max_err["em_counts"],
        "ms": timing["em"]["kernel_ms"],
        "plain_ms": timing["em"]["plain_ms"],
    }, {
        "name": "window_scores",
        "route": "cuda",
        "source": "bammmotif2_tpu_torch/csrc/window_scores.cu",
        "replaces": "bammmotif2_tpu/ops/pallas_em.py:800",
        "launches": slices["scan_launches"],
        "max_abs_err": max_err["window_scores"],
        "ms": timing["scores"]["M1"]["ms"],
        "plain_ms": timing["scores"]["M1"]["plain_ms"],
    }]
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
