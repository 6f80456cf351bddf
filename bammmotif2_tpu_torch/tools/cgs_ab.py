"""A/B of CGS sweeps/s between two checkouts on one GPU, with rank tests.

    python -m bammmotif2_tpu_torch.tools.cgs_ab BASE_DIR CHANGE_DIR [--rounds 12]

Each directory is the root of a checkout holding ``chip_smoke.py``.  Every
round starts one process per checkout, in alternating order (base first in
even rounds, change first in odd ones), one at a time.  A process imports its
checkout's ``chip_smoke`` and runs ``time_cgs``: bench.py's problem (10k x
200 bp, W=12, K=2, one chain), two timed runs of 30 sweeps through the
kernels and two plain, interleaved.  Its rate for a path is the mean of its
two runs.

The summary gives, per path, each checkout's per-process rates and medians
and three two-sided tests (scipy): Mann-Whitney U of change against base; the
Wilcoxon signed-rank test of the rounds' paired differences (each round
holds one process of each, so slow drift of the host cancels); and
Mann-Whitney U of the first process of a round against the second, for an
order effect.  It is printed as the last line and written to
``chiprun_out/cgs_ab.json`` under the working directory.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

PATHS = ("cuda", "plain")


def one(root: str) -> None:
    """Time CGS sweeps with ``root``'s chip_smoke and print one JSON line."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        out = chip_smoke.time_cgs(torch.device("cuda"), tmp)
    import bammmotif2_tpu_torch

    for mod in (chip_smoke, bammmotif2_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    rates = {p: sum(out[f"sweeps_per_s_{p}"]) / len(out[f"sweeps_per_s_{p}"]) for p in PATHS}
    print("CGS_AB " + json.dumps({"rates": rates, "runs": {p: out[f"sweeps_per_s_{p}"]
                                                           for p in PATHS}}), flush=True)


def run(root: str, timeout: float) -> dict:
    # run by path, so that only ``root``'s packages are importable in it
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                          capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("CGS_AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stdout[-2000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("CGS_AB "):])


def summary(procs: list) -> dict:
    """Rank tests over the processes' rates (see the module docstring)."""
    from scipy import stats

    out = {}
    for p in PATHS:
        by = {t: [x["rates"][p] for x in procs if x["tree"] == t] for t in ("base", "change")}
        paired = [c["rates"][p] - b["rates"][p] for b, c in zip(
            (x for x in procs if x["tree"] == "base"), (x for x in procs if x["tree"] == "change"))]
        first = [x["rates"][p] for x in procs if x["position"] == 0]
        second = [x["rates"][p] for x in procs if x["position"] == 1]
        out[p] = {
            "base": by["base"], "change": by["change"],
            "median_base": float(sorted(by["base"])[len(by["base"]) // 2]),
            "median_change": float(sorted(by["change"])[len(by["change"]) // 2]),
            "mannwhitney_p_change_vs_base": float(
                stats.mannwhitneyu(by["change"], by["base"], alternative="two-sided").pvalue),
            "wilcoxon_p_paired_rounds": float(stats.wilcoxon(paired).pvalue),
            "median_paired_change_minus_base": float(sorted(paired)[len(paired) // 2]),
            "mannwhitney_p_first_vs_second": float(
                stats.mannwhitneyu(first, second, alternative="two-sided").pvalue),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", nargs="?")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds per process")
    ap.add_argument("--one", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        one(args.one)
        return 0
    if not (args.base and args.change):
        ap.error("give BASE_DIR and CHANGE_DIR")
    trees = {"base": args.base, "change": args.change}
    procs = []
    for rnd in range(args.rounds):
        order = ("base", "change") if rnd % 2 == 0 else ("change", "base")
        for pos, tree in enumerate(order):
            res = run(trees[tree], args.timeout)
            res.update(tree=tree, round=rnd, position=pos)
            print("process " + json.dumps(res), flush=True)
            procs.append(res)
    result = {"processes": procs, "tests": summary(procs)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "cgs_ab.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result["tests"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
