"""A/B between two checkouts on one GPU, in interleaved processes, with rank
tests.

    python -m bammmotif2_tpu_torch.tools.ab {cgs,counts,draws,fdr,flat,kernels,loops,sampler} \
        BASE_DIR CHANGE_DIR [--rounds N]
        [--M 1 4 10 16]

Each directory is the root of a checkout holding ``chip_smoke.py``.  Every
round starts one process per checkout, one at a time, base first in even
rounds and change first in odd ones (so two rounds run base, change, change,
base).  A process imports its checkout's package and ``chip_smoke`` and
measures, through that checkout's code:

``cgs``: CGS sweeps/s (``chip_smoke.time_cgs``: bench.py's problem, 10k x
  200 bp, W=12, K=2; two timed runs of 30 sweeps of each of its modes,
  interleaved: one chain through the kernels and plain, each graphed and
  eager, and ten chains through the kernels, graphed and eager), the mean
  of its two runs a mode.

``draws``: the CGS sweep's draw wrappers at bench's shapes: ``cuda_draws.
  cgs_z`` on 10k rows of 379 logits at M=1 and 10 and ``cgs_beta`` at M=1
  and 16 (shapes 8,001 and 2,000): the wrapper's ms (CUDA events over
  back-to-back calls), its kernel's device ms (``device_ms``) and its host
  µs a call (``host_us``).

``counts``: the two counts-from-r wrappers at bench's geometry (10k x 200
  bp, W=12, K=2, S=2, the sampler's 0/1 r): ``cuda_counts.
  counts_from_r_multi`` at M=1 and M=10 (and on a fractional r, a
  posterior's, as ``_frac``) and ``cuda_flat.counts_from_r``.
  For each, the device ms of its ``__global__`` (``counts_kernel``,
  ``flat_counts_kernel``) and of every operation the call enqueues
  (``device_ms``, which drops a profiler window that lost events), the
  wrapper's ms by CUDA events over back-to-back calls
  (``chip_smoke.time_cuda``) and its host µs a call
  (``host_us``); each device operation a call enqueues (``device_ops``)
  goes beside the metrics.

``flat``: the flat E+M and window-score wrappers beside the combined ones
  on the same sequences and LUT: ``cuda_flat.em_counts`` at bench's
  geometry (W=12, S=2) at K=2 and K=4 beside ``cuda_em.em_counts_multi``
  (M=1, ``em_K2_M1``, ``em_K4_M1``), and ``cuda_flat.window_scores`` at
  K=2, 3 and 4 on bench's 10k set and at K=2 on config 5's 100k set
  (``chip_smoke.c5_inputs``) beside ``cuda_scores.window_scores_multi``
  (M=1).  For each, the metrics ``counts`` records.

``kernels``: ``em_counts_kernel``'s and ``window_scores_kernel``'s device
  ms (``device_ms``: torch.profiler, 10 calls) on the E+M cases
  of ``chip_smoke.EM_DEVICE_CASES`` (bench's geometry at K=2 and 4, M=1 and
  4, and K=2 on homopolymer rows) and config 5's geometry (100k x 200 bp,
  K=2) at M=1 and M=10; everything ``counts`` and ``flat`` measure; ``--EM``
  iterations/s at bench's geometry (``chip_smoke.time_em``); config 4's
  EM-FDR and CGS-FDR seconds per (W, K) group, converged, through the
  kernels (``chip_smoke.config4_problem`` and ``run_cli``); config 5's scan
  windows/s through the kernels (the --scoreSeqset stage: 100k x 200 bp
  and 1M sampled negatives, ``chip_smoke.config5_slice``'s count).  With
  ``--M``, the E+M cases are bench's geometry at K=2 and 4 at each M
  (and on homopolymer rows at M=1), the window-score cases config 5's at
  each M and the counts cases bench's 0/1 r at each M (fractional r at M=1
  and 10 as without it).

``fdr``: config 4's EM-FDR and CGS-FDR seconds per (W, K) group through
  the CLI, as ``kernels`` measures them (a fresh process: each group's
  graphs are captured in its run), and each engine's groups through
  ``evaluation.fdr.evaluate_motifs`` called twice in the process, the second
  call's seconds (``warm_fdr_seconds_W.._K..``, ``warm_cgs_fdr_...``:
  its graphs replayed from the first call's captures); the problem is
  ``fdr_split.problem``'s (``tools/fdr_split.py``, loaded by path).

``loops``: the EM and CGS loops run eagerly (in BASE_DIR's processes) against
  the same loops as replayed CUDA graphs (in CHANGE_DIR's; pass one checkout
  twice to compare its own two modes): ``chip_smoke.loop_rates`` (EM its/s
  at a fixed budget at M=1 and M=4 through run_em / run_em_multi and through
  the CLI's --EM stage, CGS sweeps/s at M=1, each loop's capture ms) after
  the first-use cost, measured first in the fresh process
  (``chip_smoke.first_use_runs``: the --CGS stage's seconds, kernel path
  first in even rounds and plain path first in odd ones, in the process's
  mode).  Bench's problem throughout (10k x 200 bp, W=12, K=2).  With
  ``--M``, both checkouts run their loops graphed (parent against change):
  EM its/s at a fixed ``chip_smoke.LOOP_ITERS`` iterations (epsilon 0)
  and converged (the default epsilon) through run_em (M=1) or
  run_em_multi on bench's set at K=2 and 4 for each M (``seeds_problem``:
  the planted PWM, then softer ones), and CGS at K=2 for each M
  (``cgs_rate``: sweeps/s, device operations a sweep and the idle share,
  whether the checkout replays a sweep at a time or runs the sweeps as one
  WHILE-node graph); no first-use runs.

``sampler``: the negatives' sampler through ``seqgen.generate_neg_data``
  (sampling, reverse complement and k-mer encoding on the card, K=2, both
  strands), from the order-2 fit (--sOrder, --bgModelAlpha at their
  defaults) to config 5's 100k positives (``chip_smoke.planted_problem``):
  its ms (CUDA events, ``chip_smoke.time_cuda``) at config 5 (the 100k
  lengths 10 times: 1M rows of 200 bp) and at config 4's fold (2,000
  held-out lengths 10 times), and ``generate_neg_set``'s seconds at config
  5 (the codes brought to the host, as --scoreSeqset makes them); then
  config 5's --scoreSeqset stage through the CLI (``C5_ARGS``): its
  seconds (``scan_done``) and the CLI's.

The kernels' inputs are made once, before the first round, by this
checkout's ``chip_smoke`` and ``tests/test_torch_cuda.py`` (numpy and
torch CPU seeds) and saved, so both trees read the same tensors.

The summary gives, per metric, each checkout's per-process values and
medians and three two-sided tests (scipy): Mann-Whitney U of change against
base; the Wilcoxon signed-rank test of the rounds' paired differences (each
round holds one process of each, so slow drift of the host cancels); and
Mann-Whitney U of the first process of a round against the second, for an
order effect.  The card's name and power limit are printed, then the
summary as the last line; everything is written to
``chiprun_out/ab_<measure>.json`` under the working directory.  Imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

C4_ARGS = ["--maxPWM", "10", "--EM", "--optimizeQ", "--FDR", "-q", "0.5", "--mFold", "10",
           "--cvFold", "5"]
C4_CGS_ARGS = ["--maxPWM", "10", "--CGS", "--FDR", "-q", "0.5", "--mFold", "10", "--cvFold", "5"]
C5_ARGS = ["--scoreSeqset", "--mFold", "10", "--pvalCutoff", "1e-4", "-k", "2", "-K", "2"]
# bench.py's geometry (chip_smoke.N_SEQS, SEQ_LEN, W) with the sampler's 0/1 r
COUNTS_GEOMETRY = dict(N=10_000, L=200, W=12, K=2, S=2)


def host_us(fn, n: int = 300) -> float:
    """The host's µs a call: time.perf_counter around each of n calls after
    a warm-up, the device drained before each call and outside the timed
    span, so that no call waits on a full launch queue: what a wrapper
    costs its caller on the host, whatever its device time."""
    import torch

    fn()
    total = 0.0
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / n * 1e6


def device_ops(fn, n: int = 10) -> dict:
    """Every device operation a call enqueues (torch.profiler over n calls
    after a warm-up): its name -> [operations a call, device µs a call]."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:100]: [e.count / n, e.self_device_time_total / n]
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


LEAD_OPS = 32  # spin kernels that open a device_ms window


def device_ms(fn, n: int, kernel: str, attempts: int = 4, per_call: int = 1) -> dict:
    """Device time per call under torch.profiler over n calls after one
    warm-up: of the __global__ function ``kernel`` alone (its ``per_call``
    launches a call summed), and of every device operation the call
    enqueues (the wrapper's torch ops included).

    A profiler window of a long process sometimes drops device events, which
    would read low: on an H100 the first 14 device operations of a window
    went missing, window after window.  So a window opens with LEAD_OPS
    short spin kernels (``torch.cuda._sleep``, left out of the counts), and
    it counts only if it traced ``kernel`` exactly n * per_call times and
    every other device operation a whole multiple of n times;
    otherwise it is retried, ``attempts`` windows in all, and both times are
    "not measured" if none counts."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(LEAD_OPS):
                torch.cuda._sleep(1_000)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
        own = [e for e in evs if f"::{kernel}(" in e.key or f"::{kernel}<" in e.key]
        if sum(e.count for e in own) == n * per_call and all(e.count % n == 0 for e in evs):
            return {"kernel_device_ms": sum(e.self_device_time_total for e in own) / n / 1e3,
                    "call_device_ms": sum(e.self_device_time_total for e in evs) / n / 1e3}
        print(f"device_ms: window {attempt + 1} of {attempts} traced "
              f"{ {e.key[:60]: e.count for e in evs} }, want {kernel} {n * per_call} times",
              file=sys.stderr, flush=True)
    return {"kernel_device_ms": "not measured", "call_device_ms": "not measured"}


def make_inputs(out_dir: str, measure: str, Ms=None) -> None:
    """Saves the cases' inputs (CPU tensors) as <case>.pt (``Ms``: the
    seed counts of ``kernels --M``)."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from bammmotif2_tpu_torch.ops import encode

    def save(obj, name):
        torch.save(obj, os.path.join(out_dir, f"{name}.pt"))

    checks = chip_smoke.load_by_path("bamm_torch_cuda_checks", "tests/test_torch_cuda.py")
    if measure in ("counts", "kernels"):
        for M in (1, 10):
            for kind, tag in (("01", ""), ("frac", "_frac")):
                save(checks.counts_inputs(**COUNTS_GEOMETRY, M=M, r=kind), f"counts_M{M}{tag}")
        for M in Ms or ():
            save(checks.counts_inputs(**COUNTS_GEOMETRY, M=M, r="01"), f"counts_M{M}")
        x = checks.flat_inputs(**COUNTS_GEOMETRY)
        save((x["r"]["01"], x["qidx"], x["map5"], dict(A=x["A"], K=x["K"], W=x["W"], R=x["R"])),
             "flat_counts_K2")
    if measure == "counts":
        return
    for K in (2, 3, 4):  # flat_inputs' sequences and LUT are em_inputs' at M=1
        x = checks.flat_inputs(**{**COUNTS_GEOMETRY, "K": K})
        kw = dict(A=x["A"], K=K, W=x["W"])
        if K != 3:
            save((x["s_flat"], x["qidx"], x["lens"], x["q"], x["map5"], {**kw, "R": x["R"]}),
                 f"flat_em_K{K}")
            save(chip_smoke.em_inputs(f"K{K}_M1", "cpu"), f"em_K{K}_M1")
        save((x["s_flat"], x["qidx"], x["lens"], x["map5"], kw), f"flat_scores_10k_K{K}")
        save((x["s_multi"], x["cidx"], x["lens"]), f"scores_10k_K{K}_M1")
    with tempfile.TemporaryDirectory() as tmp:
        cidx, lens, base, sset = chip_smoke.c5_inputs("cpu", tmp)
    map5 = torch.as_tensor(encode.map_base5_to_combined(4, 2))
    save((base, encode.strand_base5_indices(sset, 2, False, "cpu"), lens, map5,
          dict(A=4, K=2, W=base.shape[1])), "flat_scores_c5")
    save((chip_smoke.c5_luts(base, 1), cidx, lens), "scores_c5_M1")
    if measure == "kernels" and Ms:
        for K in (2, 4):
            for M in Ms:
                save(checks.kernel_inputs(N=chip_smoke.N_SEQS, L=chip_smoke.SEQ_LEN,
                                          W=chip_smoke.W, K=K, M=M, S=2), f"em_K{K}_M{M}")
        save(chip_smoke.em_inputs("K2_M1_homopolymer", "cpu"), "em_K2_M1_homopolymer")
        for M in Ms:
            save((chip_smoke.c5_luts(base, M), cidx, lens), f"scores_c5_M{M}")
    elif measure == "kernels":
        for name in chip_smoke.EM_DEVICE_CASES:
            save(chip_smoke.em_inputs(name, "cpu"), f"em_{name}")
        save((chip_smoke.c5_luts(base, 10), cidx, lens), "scores_c5_M10")


def measure_cgs(chip_smoke, dev, _inputs) -> tuple:
    with tempfile.TemporaryDirectory() as tmp:
        out = chip_smoke.time_cgs(dev, tmp)
    runs = {k: v for k, v in out.items() if k.startswith("sweeps_per_s_")}
    return {k: sum(v) / len(v) for k, v in runs.items()}, {"runs": runs}


def measure_draws(chip_smoke, dev, _inputs) -> tuple:
    import numpy as np
    import torch

    from bammmotif2_tpu_torch.ops import cuda_draws

    metrics = {}

    def record(tag, call, kernel):
        metrics[f"{tag}_ms"] = chip_smoke.time_cuda(call, 100)
        metrics[f"{tag}_device_ms"] = device_ms(call, 10, kernel)["kernel_device_ms"]
        metrics[f"{tag}_host_us"] = host_us(call)

    C = 1 + 2 * (chip_smoke.SEQ_LEN - chip_smoke.W + 1)
    for M in (1, 10):
        flat = torch.randn((M, chip_smoke.N_SEQS, C),
                           generator=torch.Generator().manual_seed(M)).to(dev)
        keys = torch.as_tensor(np.random.default_rng(M).integers(0, 2 ** 32, (M, 2)), device=dev)
        record(f"z_M{M}", lambda flat=flat, keys=keys: cuda_draws.cgs_z(flat, keys),
               "cgs_z_kernel")
    for M in (1, 16):
        keys = torch.as_tensor(np.random.default_rng(M).integers(0, 2 ** 32, (M, 2)), device=dev)
        a = torch.full((M,), 8_001.0, device=dev)
        b = torch.full((M,), 2_000.0, device=dev)
        record(f"beta_M{M}", lambda a=a, b=b, keys=keys: cuda_draws.cgs_beta(
            a, b, keys, 1e-4, 1 - 1e-4), "cgs_beta_kernel")
    return metrics, {}


def case_call(name: str, args):
    """(the wrapper call of a saved case, its __global__'s name)."""
    from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em, cuda_flat, cuda_scores

    if name.startswith("em_"):
        return (lambda: cuda_em.em_counts_multi(*args)), "em_counts_kernel"
    if name.startswith("scores_"):
        return (lambda: cuda_scores.window_scores_multi(*args)), "window_scores_kernel"
    if name.startswith("counts_"):
        return (lambda: cuda_counts.counts_from_r_multi(*args)), "counts_kernel"
    *tensors, kw = args
    if name.startswith("flat_em_"):
        return (lambda: cuda_flat.em_counts(*tensors, **kw)), "flat_em_kernel"
    if name.startswith("flat_scores_"):
        return (lambda: cuda_flat.window_scores(*tensors, **kw)), "flat_scores_kernel"
    return (lambda: cuda_flat.counts_from_r(*tensors, **kw)), "flat_counts_kernel"


def measure_cases(chip_smoke, dev, inputs, full=("counts_", "flat_")) -> tuple:
    """Every saved case's kernel device ms; for the cases whose name starts
    with one of ``full`` also the call's device ms, events ms, host µs and
    device operations."""
    import torch

    metrics, ops = {}, {}
    for f in sorted(os.listdir(inputs)):
        name = f[:-3]
        args = torch.load(os.path.join(inputs, f), map_location=dev)
        fn, kernel = case_call(name, args)
        dev_ms = device_ms(fn, 10, kernel)
        if name.startswith(full):
            metrics[f"call_device_ms_{name}"] = dev_ms["call_device_ms"]
            metrics[f"wrapper_ms_{name}"] = chip_smoke.time_cuda(fn, 30)
            metrics[f"host_us_{name}"] = host_us(fn)
            ops[name] = device_ops(fn)
        metrics[f"device_ms_{name}"] = dev_ms["kernel_device_ms"]
        del args, fn
        torch.cuda.empty_cache()
    return metrics, {"device_ops": ops}


def measure_flat(chip_smoke, dev, inputs) -> tuple:
    return measure_cases(chip_smoke, dev, inputs, full=("",))


def config4_fdr(chip_smoke, dev, tmp: str) -> tuple:
    """Config 4's EM-FDR and CGS-FDR seconds per (W, K) group through the
    CLI (``C4_ARGS``, ``C4_CGS_ARGS``), and the EM run's metrics events."""
    fasta, meme = chip_smoke.config4_problem(tmp)
    run = chip_smoke.run_cli(os.path.join(tmp, "c4"), fasta, meme, C4_ARGS, dev)
    cgs = chip_smoke.run_cli(os.path.join(tmp, "c4_cgs"), fasta, meme, C4_CGS_ARGS, dev)
    metrics = {}
    for e in run["events"]["fdr_done"]:
        metrics[f"config4_fdr_seconds_W{e['W']}_K{e['K']}"] = e["group_seconds"]
    for e in cgs["events"]["fdr_done"]:
        metrics[f"config4_cgs_fdr_seconds_W{e['W']}_K{e['K']}"] = e["group_seconds"]
    metrics["config4_cli_seconds"] = run["seconds"]
    return metrics, run


def measure_fdr(chip_smoke, dev, _inputs) -> tuple:
    """``config4_fdr``, then each engine's groups again through
    ``evaluate_motifs`` in this process, twice: the second call's seconds a
    group (``warm_...``: its graphs captured by the first).  The problem
    comes from this tool's ``fdr_split.problem``, loaded by path, on the
    checkout's package."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "ab_fdr_split", os.path.join(os.path.dirname(os.path.abspath(__file__)), "fdr_split.py"))
    fdr_split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fdr_split)
    from bammmotif2_tpu_torch.evaluation import fdr

    with tempfile.TemporaryDirectory() as tmp:
        metrics, run = config4_fdr(chip_smoke, dev, tmp)
        for refine, tag in (("EM", "warm_fdr"), ("CGS", "warm_cgs_fdr")):
            seeds, bg, pos, params = fdr_split.problem(chip_smoke, tmp, refine, None)
            for _ in range(2):
                res = fdr.evaluate_motifs([m.copy() for m in seeds], bg, pos, params, device=dev)
                torch.cuda.synchronize()
            for m, r in zip(seeds, res):
                metrics[f"{tag}_seconds_W{m.W}_K{m.K}"] = r.group_seconds
    return metrics, {"config4_em_iterations": [e["iterations"] for e in run["events"]["em_done"]]}


def measure_kernels(chip_smoke, dev, inputs) -> tuple:
    metrics, extra = measure_cases(chip_smoke, dev, inputs)
    with tempfile.TemporaryDirectory() as tmp:
        metrics["em_iters_per_s"] = chip_smoke.time_em(dev, tmp)["em_iters_per_s_cuda"]
        c4, run = config4_fdr(chip_smoke, dev, tmp)
        metrics.update(c4)
        _s, fasta5, meme5, *_ = chip_smoke.planted_problem(tmp, chip_smoke.C5_SEQS, "c5")
        scan = chip_smoke.run_cli(os.path.join(tmp, "c5"), fasta5, meme5, C5_ARGS, dev)
    ev = scan["events"]["scan_done"][0]
    metrics["config5_scan_windows_per_s"] = ev["windows"] * (1 + chip_smoke.C5_MFOLD) / ev["seconds"]
    return metrics, {**extra,
                     "config4_em_iterations": [e["iterations"] for e in run["events"]["em_done"]]}


def seeds_problem(chip_smoke, tmp: str, K: int, M: int) -> dict:
    """Bench's planted set with M width-W seeds at order K (the planted PWM,
    then softer ones: 0.7 - 0.02 m on the planted base), in the form
    ``chip_smoke.em_rate`` takes."""
    import numpy as np

    from bammmotif2_tpu_torch.models import seeds as seeds_mod
    from bammmotif2_tpu_torch.models.background import BackgroundModel

    sset, _fasta, _meme, planted, _pos, _has = chip_smoke.planted_problem(tmp, tag=f"seeds_K{K}")
    W = chip_smoke.W
    seeds = []
    for m in range(M):
        pwm = np.full((W, 4), (0.3 + 0.02 * m) / 3)
        pwm[np.arange(W), planted] = 0.7 - 0.02 * m
        seeds.append(seeds_mod.motif_from_pwm(pwm, K=K, f_bg=sset.base_frequencies()))
    return {"sset": sset, "seeds": seeds,
            "bg": BackgroundModel.from_sequence_set(sset, order=2, alpha=10.0, ss=False)}


def cgs_rate(chip_smoke, dev, prob: dict, M: int = 1) -> dict:
    """CGS on ``prob``'s first M seeds (K=2, the kernel path, graphed: one
    launch of a WHILE-node graph a run where the checkout loops on the
    device, a replay a sweep where it does not), N_TIMED sweeps after an
    untimed run of the same length: sweeps/s, and over one more run under
    torch.profiler the device operations a sweep and the device's idle
    share.  The chains are keyed by ``gibbs.input_keys`` (``chain_keys`` in
    a checkout from before the reference's keys) or, before either, by
    seeded generators."""
    import numpy as np
    import torch

    from bammmotif2_tpu_torch.refinement import gibbs
    from bammmotif2_tpu_torch.refinement.em import prepare_data

    data = prepare_data(prob["sset"], prob["bg"], 2, False, dev)
    seeds = prob["seeds"][:M]
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)  # noqa: E731
    alphas = f32(np.stack([m.alphas for m in seeds]))
    v = tuple(f32(np.stack([m.v[k] for m in seeds])) for k in range(3))
    chains = (getattr(gibbs, "input_keys", None) or getattr(gibbs, "chain_keys", None)
              or gibbs.chain_generators)

    def sweeps():
        gibbs.gibbs_optimize(v, f32([0.9] * M), torch.log(alphas), chains(0, range(M), dev), data,
                             f32(seeds[0].f_bg), alphas, float(chip_smoke.N_SEQS), A=4, K=2,
                             W=chip_smoke.W, sample_z=True, sample_q=True, learn_alpha=True,
                             path="cuda", n_iters=chip_smoke.N_TIMED, graphs=True)
        torch.cuda.synchronize()

    sweeps()
    t0 = time.perf_counter()
    sweeps()
    rate = chip_smoke.N_TIMED / (time.perf_counter() - t0)
    prof = chip_smoke.profile_window(sweeps)
    return {f"cgs_sweeps_per_s_M{M}": rate,
            f"cgs_device_ops_per_sweep_M{M}": prof["kernel_launches"] / chip_smoke.N_TIMED,
            f"cgs_idle_share_M{M}": prof["device_idle_share"]}


def measure_seed_loops(chip_smoke, dev, Ms: list) -> tuple:
    """``loops --M``: graphed EM its/s at K=2 and 4 for each M, at a fixed
    budget and converged (the default epsilon, ``em_conv_...``; the
    iterations go beside the metrics), and CGS at K=2 for each M
    (``cgs_rate``), each timed run after an untimed one of its shape."""
    import torch

    from bammmotif2_tpu_torch.utils.config import Params

    # CUPTI records the kernels of a loop graph's WHILE body only where the
    # graph was instantiated after the process first traced: trace first
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
    metrics, iterations = {}, {}
    converged = Params(EM=True, optimizeQ=True)
    with tempfile.TemporaryDirectory() as tmp:
        for K in (2, 4):
            prob = seeds_problem(chip_smoke, tmp, K, max(Ms))
            for M in Ms:
                chip_smoke.em_rate(dev, prob, M, True)
                metrics[f"em_its_per_s_K{K}_M{M}"] = chip_smoke.em_rate(dev, prob, M, True)[0]
                chip_smoke.em_rate(dev, prob, M, True, converged)
                rate, its = chip_smoke.em_rate(dev, prob, M, True, converged)
                metrics[f"em_conv_its_per_s_K{K}_M{M}"] = rate
                iterations[f"K{K}_M{M}"] = its
            if K == 2:
                for M in Ms:
                    metrics.update(cgs_rate(chip_smoke, dev, prob, M))
    return metrics, {"graphed": True, "converged_iterations": iterations}


def measure_loops(chip_smoke, dev, _inputs, graphed: bool, first: str, Ms=None) -> tuple:
    """First use of --CGS in this fresh process (``first``: kernel_first or
    plain_first), then the loops' rates in the process's mode; with ``Ms``,
    ``measure_seed_loops``."""
    if Ms:
        return measure_seed_loops(chip_smoke, dev, Ms)
    with tempfile.TemporaryDirectory() as tmp:
        prob = chip_smoke.loops_problem(tmp)
        fu = chip_smoke.first_use_runs(dev, tmp, prob["fasta"], prob["meme"], first)
        metrics = chip_smoke.loop_rates(dev, tmp, prob, graphed)
    for order in ("kernel_first", "plain_first"):
        lead, then = order.split("_")[0], "plain" if order == "kernel_first" else "kernel"
        got = order == first
        metrics[f"first_use_{order}_{lead}_cgs_s"] = fu[lead]["cgs_seconds"] if got else "not measured"
        metrics[f"first_use_{order}_{then}_after_cgs_s"] = (fu[then]["cgs_seconds"] if got
                                                            else "not measured")
    return metrics, {"graphed": graphed, "first_use": fu}


def measure_sampler(chip_smoke, dev, _inputs) -> tuple:
    """``sampler`` (see the module docstring)."""
    import torch

    from bammmotif2_tpu_torch.generator import seqgen
    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.utils.config import Params

    p = Params()
    metrics = {}
    with tempfile.TemporaryDirectory() as tmp:
        sset, fasta, meme, *_ = chip_smoke.planted_problem(tmp, chip_smoke.C5_SEQS, "c5")
        bg = BackgroundModel.from_sequence_set(sset, order=p.sOrder, alpha=p.bgModelAlpha,
                                               ss=False)
        for tag, lens, n in (("config5", sset.lens, 5), ("config4_fold", sset.lens[:2_000], 20)):
            metrics[f"neg_data_ms_{tag}"] = chip_smoke.time_cuda(
                lambda lens=lens: seqgen.generate_neg_data(bg, lens, 10, p.seed, 2, False,
                                                           device=dev), n)
        seqgen.generate_neg_set(bg, sset.lens, 10, p.seed, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seqgen.generate_neg_set(bg, sset.lens, 10, p.seed, device=dev)
        metrics["neg_set_s_config5"] = time.perf_counter() - t0
        scan = chip_smoke.run_cli(os.path.join(tmp, "c5"), fasta, meme, C5_ARGS, dev)
    metrics["config5_scan_seconds"] = scan["events"]["scan_done"][0]["seconds"]
    metrics["config5_cli_seconds"] = scan["seconds"]
    return metrics, {}


MEASURES = {"cgs": measure_cgs, "counts": measure_cases, "draws": measure_draws,
            "fdr": measure_fdr,
            "flat": measure_flat, "kernels": measure_kernels, "loops": measure_loops,
            "sampler": measure_sampler}


def one(measure: str, root: str, inputs: str, graphed: bool = True,
        first: str = "kernel_first", Ms=None) -> None:
    """Measure with ``root``'s checkout and print one JSON line
    (``graphed``, ``first`` and ``Ms`` are the ``loops`` measure's mode)."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke
    import bammmotif2_tpu_torch

    for mod in (chip_smoke, bammmotif2_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    opts = (graphed, first, Ms) if measure == "loops" else ()
    metrics, extra = MEASURES[measure](chip_smoke, torch.device("cuda"), inputs, *opts)
    print("AB " + json.dumps({"metrics": metrics, **extra}), flush=True)


def run(measure: str, root: str, inputs: str, timeout: float, mode: tuple = ()) -> dict:
    # run by path, so that only ``root``'s packages are importable in it
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), measure, root, inputs,
                           "--one", *mode], capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stdout[-2000:]}"
                           f"\n{proc.stderr[-4000:]}")
    res = json.loads(lines[-1][len("AB "):])
    res["dropped_profiler_windows"] = proc.stderr.count("device_ms: window")
    return res


def _median(xs: list) -> float:
    return float(sorted(xs)[len(xs) // 2])


def summary(procs: list) -> dict:
    """Rank tests over the processes' metrics (see the module docstring).  A
    process whose metric is not a number ("not measured") is left out of
    that metric's tests and counted; a test without values on both sides is
    null."""
    from scipy import stats

    def mw(a, b):
        return float(stats.mannwhitneyu(a, b, alternative="two-sided").pvalue) if a and b else None

    out = {}
    for k in procs[0]["metrics"]:
        got = [x for x in procs if isinstance(x["metrics"][k], (int, float))]
        by = {t: [x["metrics"][k] for x in got if x["tree"] == t] for t in ("base", "change")}
        rounds = {t: {x["round"]: x["metrics"][k] for x in got if x["tree"] == t}
                  for t in ("base", "change")}
        paired = [c - rounds["base"][r] for r, c in rounds["change"].items() if r in rounds["base"]]
        first = [x["metrics"][k] for x in got if x["position"] == 0]
        second = [x["metrics"][k] for x in got if x["position"] == 1]
        out[k] = {
            "base": by["base"], "change": by["change"], "not_measured": len(procs) - len(got),
            "median_base": _median(by["base"]) if by["base"] else None,
            "median_change": _median(by["change"]) if by["change"] else None,
            "mannwhitney_p_change_vs_base": mw(by["change"], by["base"]),
            "wilcoxon_p_paired_rounds": float(stats.wilcoxon(paired).pvalue) if paired else None,
            "median_paired_change_minus_base": _median(paired) if paired else None,
            "mannwhitney_p_first_vs_second": mw(first, second),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("measure", choices=sorted(MEASURES))
    ap.add_argument("base")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per process")
    ap.add_argument("--M", type=int, nargs="+", default=None,
                    help="loops, kernels: seed counts (see the measures)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--eager", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--first", default="kernel_first", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:  # base is the checkout, change the inputs' directory
        one(args.measure, args.base, args.change, not args.eager, args.first, args.M)
        return 0
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    trees = {"base": args.base, "change": args.change}
    procs = []
    with tempfile.TemporaryDirectory() as inputs:
        if args.measure not in ("cgs", "draws", "fdr", "loops", "sampler"):
            make_inputs(inputs, args.measure, args.M)
        seeds = ("--M", *map(str, args.M)) if args.M else ()
        for rnd in range(args.rounds):
            order = ("base", "change") if rnd % 2 == 0 else ("change", "base")
            for pos, tree in enumerate(order):
                mode = seeds if args.measure == "loops" else ()
                if args.measure == "loops" and not args.M:  # base eager, change graphed
                    mode = (*(("--eager",) if tree == "base" else ()),
                            "--first", ("kernel_first", "plain_first")[rnd % 2])
                res = run(args.measure, trees[tree], inputs, args.timeout, mode)
                res.update(tree=tree, round=rnd, position=pos)
                print("process " + json.dumps(res), flush=True)
                procs.append(res)
    result = {"gpu": gpu, "measure": args.measure, "processes": procs, "tests": summary(procs)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"ab_{args.measure}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(gpu)
    print(json.dumps(result["tests"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
