"""How long one FDR group takes: config 4's (W, K) group on one GPU.

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
  * ``profiled``: one more run under torch.profiler: its wall ms, the
    device's busy ms (the device operations' summed self time) and idle
    share (1 - busy / wall), the device operations launched and the largest
    by time.  The profiler adds host time per operation, so its wall ms
    exceeds the plain runs'.

Where the seconds go by stage is the program's own record: the ``fdr.*``
spans of ``utils.metrics`` (``chip_smoke.time_fdr_group`` reads them).
``problem`` also serves ``tools/ab.py`` and ``chip_smoke.py``.

Prints the card's name and power limit, then one JSON line, and writes it to
``chiprun_out/fdr_split[_TAG].json`` under the working directory.  Imports no
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

ARGS = {"EM": ["--FDR", "--optimizeQ", "-q", "0.5", "--mFold", "10", "--cvFold", "5"],
        "CGS": ["--CGS", "--FDR", "-q", "0.5", "--mFold", "10", "--cvFold", "5"]}


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


def measure(root: str, W: int, runs: int) -> dict:
    """Both engines' measurements through ``root``'s checkout."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import chip_smoke
    import bammmotif2_tpu_torch
    from bammmotif2_tpu_torch.evaluation import fdr

    for mod in (chip_smoke, bammmotif2_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"imported {mod.__file__}, not from {root}")
    import torch
    from torch.autograd import DeviceType

    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for refine in ("EM", "CGS"):
            seeds, bg, pos, params = problem(chip_smoke, tmp, refine, W)

            def group():
                res = fdr.evaluate_motifs([m.copy() for m in seeds], bg, pos, params, device=dev)
                torch.cuda.synchronize()
                return res[0].group_seconds

            # CUPTI records the kernels of a loop graph's WHILE body only where
            # the graph was instantiated after the process first traced: trace
            # first
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(1, device=dev).add_(1)
            group()  # builds, captures
            res = {"seeds": len(seeds), "group_seconds": [group() for _ in range(runs)]}
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                group()
                wall_us = (time.perf_counter() - t0) * 1e6
            ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            busy_us = sum(e.self_device_time_total for e in ops)
            top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
            res["profiled"] = {
                "wall_ms": wall_us / 1e3,
                "device_busy_ms": busy_us / 1e3,
                "device_idle_share": 1 - busy_us / wall_us if busy_us else "not measured",
                "device_operations": sum(e.count for e in ops),
                "top_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
            }
            out[refine] = res
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
