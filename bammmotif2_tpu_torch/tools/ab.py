"""A/B between two checkouts on one GPU, in interleaved processes, with rank
tests.

    python -m bammmotif2_tpu_torch.tools.ab {cgs,kernels} BASE_DIR CHANGE_DIR [--rounds N]

Each directory is the root of a checkout holding ``chip_smoke.py``.  Every
round starts one process per checkout, one at a time, base first in even
rounds and change first in odd ones (so two rounds run base, change, change,
base).  A process imports its checkout's package and ``chip_smoke`` and
measures, through that checkout's code:

``cgs``: CGS sweeps/s (``chip_smoke.time_cgs``: bench.py's problem, 10k x
  200 bp, W=12, K=2, one chain; two timed runs of 30 sweeps through the
  kernels and two plain, interleaved), the mean of its two runs a path.

``kernels``: ``em_counts_kernel``'s and ``window_scores_kernel``'s device
  ms (``chip_smoke.device_ms``: torch.profiler, 10 calls) on inputs made
  once, before the first round, by this checkout's ``chip_smoke`` (numpy
  seeds) and saved: the E+M cases of ``chip_smoke.EM_DEVICE_CASES``
  (bench's geometry at K=2 and 4, M=1 and 4, and K=2 on homopolymer rows)
  and config 5's geometry (100k x 200 bp, K=2) at M=1 and M=10; ``--EM``
  iterations/s at bench's geometry (``chip_smoke.time_em``); config 4's
  EM-FDR seconds per (W, K) group, converged, through the kernels
  (``chip_smoke.config4_problem`` and ``run_cli``).

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

C4_ARGS = ["--maxPWM", "10", "--EM", "--optimizeQ", "--FDR", "-q", "0.5", "--mFold", "10",
           "--cvFold", "5"]


def make_inputs(out_dir: str) -> None:
    """Saves the ``kernels`` cases' inputs (CPU tensors) as <case>.pt."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke

    for name in chip_smoke.EM_DEVICE_CASES:
        torch.save(chip_smoke.em_inputs(name, "cpu"), os.path.join(out_dir, f"em_{name}.pt"))
    with tempfile.TemporaryDirectory() as tmp:
        cidx, lens, base, _sset = chip_smoke.c5_inputs("cpu", tmp)
    for M in (1, 10):
        torch.save((chip_smoke.c5_luts(base, M), cidx, lens),
                   os.path.join(out_dir, f"scores_c5_M{M}.pt"))


def measure_cgs(chip_smoke, dev, _inputs) -> tuple:
    with tempfile.TemporaryDirectory() as tmp:
        out = chip_smoke.time_cgs(dev, tmp)
    runs = {f"sweeps_per_s_{p}": out[f"sweeps_per_s_{p}"] for p in ("cuda", "plain")}
    return {k: sum(v) / len(v) for k, v in runs.items()}, {"runs": runs}


def measure_kernels(chip_smoke, dev, inputs) -> tuple:
    import torch

    from bammmotif2_tpu_torch.ops import cuda_em, cuda_scores

    metrics = {}
    for f in sorted(os.listdir(inputs)):
        name = f[:-3]
        args = torch.load(os.path.join(inputs, f), map_location=dev)
        if name.startswith("em_"):
            fn, kernel = (lambda: cuda_em.em_counts_multi(*args)), "em_counts_kernel"
        else:
            fn, kernel = (lambda: cuda_scores.window_scores_multi(*args)), "window_scores_kernel"
        metrics[f"device_ms_{name}"] = chip_smoke.device_ms(fn, 10, kernel)["kernel_device_ms"]
        del args
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        metrics["em_iters_per_s"] = chip_smoke.time_em(dev, tmp)["em_iters_per_s_cuda"]
        fasta, meme = chip_smoke.config4_problem(tmp)
        run = chip_smoke.run_cli(os.path.join(tmp, "c4"), fasta, meme, C4_ARGS, dev)
    for e in run["events"]["fdr_done"]:
        metrics[f"config4_fdr_seconds_W{e['W']}_K{e['K']}"] = e["group_seconds"]
    metrics["config4_cli_seconds"] = run["seconds"]
    return metrics, {"config4_em_iterations": [e["iterations"] for e in run["events"]["em_done"]]}


MEASURES = {"cgs": measure_cgs, "kernels": measure_kernels}


def one(measure: str, root: str, inputs: str) -> None:
    """Measure with ``root``'s checkout and print one JSON line."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke
    import bammmotif2_tpu_torch

    for mod in (chip_smoke, bammmotif2_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    metrics, extra = MEASURES[measure](chip_smoke, torch.device("cuda"), inputs)
    print("AB " + json.dumps({"metrics": metrics, **extra}), flush=True)


def run(measure: str, root: str, inputs: str, timeout: float) -> dict:
    # run by path, so that only ``root``'s packages are importable in it
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), measure, root, inputs,
                           "--one"], capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stdout[-2000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("AB "):])


def _median(xs: list) -> float:
    return float(sorted(xs)[len(xs) // 2])


def summary(procs: list) -> dict:
    """Rank tests over the processes' metrics (see the module docstring)."""
    from scipy import stats

    out = {}
    for k in procs[0]["metrics"]:
        by = {t: [x["metrics"][k] for x in procs if x["tree"] == t] for t in ("base", "change")}
        paired = [c["metrics"][k] - b["metrics"][k] for b, c in zip(
            (x for x in procs if x["tree"] == "base"), (x for x in procs if x["tree"] == "change"))]
        first = [x["metrics"][k] for x in procs if x["position"] == 0]
        second = [x["metrics"][k] for x in procs if x["position"] == 1]
        out[k] = {
            "base": by["base"], "change": by["change"],
            "median_base": _median(by["base"]), "median_change": _median(by["change"]),
            "mannwhitney_p_change_vs_base": float(
                stats.mannwhitneyu(by["change"], by["base"], alternative="two-sided").pvalue),
            "wilcoxon_p_paired_rounds": float(stats.wilcoxon(paired).pvalue),
            "median_paired_change_minus_base": _median(paired),
            "mannwhitney_p_first_vs_second": float(
                stats.mannwhitneyu(first, second, alternative="two-sided").pvalue),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("measure", choices=sorted(MEASURES))
    ap.add_argument("base")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per process")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:  # base is the checkout, change the inputs' directory
        one(args.measure, args.base, args.change)
        return 0
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    trees = {"base": args.base, "change": args.change}
    procs = []
    with tempfile.TemporaryDirectory() as inputs:
        if args.measure == "kernels":
            make_inputs(inputs)
        for rnd in range(args.rounds):
            order = ("base", "change") if rnd % 2 == 0 else ("change", "base")
            for pos, tree in enumerate(order):
                res = run(args.measure, trees[tree], inputs, args.timeout)
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
