"""Where the seconds of one FDR group go: config 4's (W, K) group on one GPU.

    python -m bammmotif2_tpu_torch.tools.fdr_split ROOT [--W 10] [--runs 2] [--tag T]

ROOT is the root of a checkout holding ``chip_smoke.py``; the tool imports
that checkout's package (run it by path, ``python
bammmotif2_tpu_torch/tools/fdr_split.py ROOT``, so that only ROOT's packages
are importable) and drives ``evaluation.fdr.evaluate_motifs`` on BASELINE
config 4's set (``chip_smoke.config4_problem``: 10k x 200 bp, --mFold 10,
--cvFold 5, -q 0.5) for the seeds of width ``--W`` at K=2, once with EM
(--optimizeQ) and once with CGS (100 sweeps), each after an untimed warm-up
run of the same group:

  * ``group_seconds``: ``FDRResult.group_seconds`` of ``--runs`` plain runs;
  * ``stages``: one more run with the stage functions of ``STAGES`` that the
    checkout has wrapped in timers, each of which drains the device before
    and after its call, so a stage's seconds hold its host and device time.
    A stage called inside another one is taken out of the outer one's
    seconds, and a call made while a CUDA graph is being captured is not
    timed (it launches nothing).  ``other_host`` is the run's group
    seconds less the stages' sum: Python, the reads and syncs no stage
    holds;
  * ``profiled``: one more run under torch.profiler: its wall ms, the
    device's busy ms (the device operations' summed self time) and idle
    share (1 - busy / wall), the device operations launched and the largest
    by time.  The profiler adds host time per operation, so its wall ms
    exceeds the plain runs'.

Prints the card's name and power limit, then one JSON line, and writes it to
``chiprun_out/fdr_split[_TAG].json`` under the working directory.  Imports no
JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

# (stage, module under the package, attribute): the parent's fold loop and
# the group program name their pieces differently; a checkout times those
# it has
STAGES = (
    ("preparation", "evaluation.fdr", "_prepare_group"),
    ("background_fits", "evaluation.fdr", "fold_backgrounds"),
    ("background_fits", "models.background", "BackgroundModel.from_sequence_set"),
    ("refinement", "evaluation.fdr", "batched_while_loop"),
    ("refinement", "evaluation.fdr", "_cgs_fold"),
    ("fold_tail", "evaluation.fdr", "_run_tail"),
    ("log_odds_lut", "evaluation.fdr", "log_odds_lut"),
    ("scoring", "evaluation.fdr", "_score_rows"),
    ("negatives", "generator.seqgen", "generate_neg_data"),
    ("mops_sweeps", "evaluation.prcurve", "threshold_sweep_device"),
    ("mops_sweeps", "evaluation.fdr", "_mops_ranks"),
    ("fetch", "evaluation.fdr", "_fetch"),
    ("zoops_sweeps", "evaluation.prcurve", "threshold_sweep"),
    ("zoops_sweeps", "evaluation.fdr", "empirical_pvalues"),
)
ARGS = {"EM": ["--FDR", "--optimizeQ", "-q", "0.5", "--mFold", "10", "--cvFold", "5"],
        "CGS": ["--CGS", "--FDR", "-q", "0.5", "--mFold", "10", "--cvFold", "5"]}


class Timers:
    """Stage timers patched over a package's functions (``STAGES``)."""

    def __init__(self, package: str):
        self.seconds: dict = {}
        self._open: list = []  # [seconds of the nested stages] of each stage running
        self._undo = []
        for stage, mod, attr in STAGES:
            owner = importlib.import_module(f"{package}.{mod}")
            *path, name = attr.split(".")
            for p in path:
                owner = getattr(owner, p, None)
            if owner is None or name not in vars(owner):
                continue
            raw = vars(owner)[name]
            kind = type(raw) if isinstance(raw, (classmethod, staticmethod)) else None
            fn = raw.__func__ if kind else raw
            wrapped = self._wrap(stage, fn)
            setattr(owner, name, kind(wrapped) if kind else wrapped)
            self._undo.append((owner, name, raw))

    def _wrap(self, stage: str, fn):
        import torch

        def timed(*a, **k):
            if torch.cuda.is_current_stream_capturing():
                return fn(*a, **k)
            torch.cuda.synchronize()
            self._open.append([0.0])
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                torch.cuda.synchronize()
            finally:
                took = time.perf_counter() - t0
                nested = self._open.pop()[0]
                if self._open:
                    self._open[-1][0] += took
            self.seconds[stage] = self.seconds.get(stage, 0.0) + took - nested
            return out

        return timed

    def close(self) -> None:
        for owner, name, raw in reversed(self._undo):
            setattr(owner, name, raw)


def problem(chip_smoke, tmp: str, refine: str, W: int | None) -> tuple:
    """(seeds of width W, or all ten where W is None; background; positives;
    params) of config 4 for ``refine`` ('EM' or 'CGS')."""
    from bammmotif2_tpu_torch import cli
    from bammmotif2_tpu_torch.models.background import BackgroundModel
    from bammmotif2_tpu_torch.models.motifset import load_motifs
    from bammmotif2_tpu_torch.utils.alphabet import Alphabet
    from bammmotif2_tpu_torch.utils.fasta import read_fasta

    fasta, meme = chip_smoke.config4_problem(tmp)
    params = cli.params_from_args([tmp, fasta, "--PWMFile", meme, "--maxPWM", "10",
                                   *ARGS[refine]])
    alphabet = Alphabet.from_type(params.alphabetType)
    pos = read_fasta(fasta, alphabet)
    bg = BackgroundModel.from_sequence_set(pos, order=params.bgModelOrder,
                                           alpha=params.bgModelAlpha, ss=params.ss)
    seeds = [m for m in load_motifs(params, pos.base_frequencies(), alphabet) if W in (None, m.W)]
    return seeds, bg, pos, params


def split(fdr, package: str, seeds, bg, pos, params, runs: int) -> dict:
    """The measurements of the module docstring for one group."""
    import torch
    from torch.autograd import DeviceType

    dev = torch.device("cuda")

    def group():
        res = fdr.evaluate_motifs([m.copy() for m in seeds], bg, pos, params, device=dev)
        torch.cuda.synchronize()
        return res[0].group_seconds

    # CUPTI records the kernels of a loop graph's WHILE body only where the
    # graph was instantiated after the process first traced: trace first
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
    group()  # builds, captures
    out = {"seeds": len(seeds), "group_seconds": [group() for _ in range(runs)]}
    timers = Timers(package)
    try:
        secs = group()
    finally:
        timers.close()
    out["timed_run_group_seconds"] = secs
    out["stages"] = timers.seconds
    out["other_host"] = secs - sum(timers.seconds.values())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        group()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in ops)
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    out["profiled"] = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / wall_us if busy_us else "not measured",
        "device_operations": sum(e.count for e in ops),
        "top_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }
    return out


def measure(root: str, W: int, runs: int) -> dict:
    """Both engines' splits through ``root``'s checkout."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke
    import bammmotif2_tpu_torch
    from bammmotif2_tpu_torch.evaluation import fdr

    for mod in (chip_smoke, bammmotif2_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for refine in ("EM", "CGS"):
            seeds, bg, pos, params = problem(chip_smoke, tmp, refine, W)
            out[refine] = split(fdr, "bammmotif2_tpu_torch", seeds, bg, pos, params, runs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--W", type=int, default=10, help="the group's motif width (8, 10 or 12)")
    ap.add_argument("--runs", type=int, default=2, help="plain timed runs")
    ap.add_argument("--tag", default="")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    res = {"gpu": gpu, "root": a.root, "W": a.W, "K": 2, **measure(a.root, a.W, a.runs)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"fdr_split{'_' + a.tag if a.tag else ''}.json"),
              "w") as fh:
        json.dump(res, fh, indent=1)
    print(gpu)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
