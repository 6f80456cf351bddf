#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process:

    python3 benchmark/readings.py --workload CELL --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--fault NAME] [--out FILE]

For each of --seeds, the program's numbers: one job of the cell, the pool's
first input made from that seed as a run makes it, run through the port on
the card and judged by the cell's check (``benchmark/reference/
check_*.py``), as a run judges its jobs; with --fault, the program with
that fault planted (``FAULTS``).  For each of --control-seeds, the
control's numbers: the plain reference put in the program's place,
computed in bfloat16 with float32 sums (the precision below the float32
that the configurations state), its outputs written in the program's
formats and judged by the same check.  A limit lies above the program's
readings and below the control's.  Prints one JSON line a reading and
writes them all to --out (JSON).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import torch  # noqa: E402

from benchlib import spec as spec_mod, traffic  # noqa: E402
from reference import check_em, flags  # noqa: E402

LOW = dict(dtype=torch.bfloat16, acc=torch.float32)


def write_em(outdir: str, base: str, codes, meme: str, argv: list) -> None:
    """The control's --EM outputs: each seed's model (``.ihbcp``, five
    digits as the program writes them) and its em_done event."""
    opts = flags.parse(argv)
    names = [n for n, _p, _s in check_em.seeds(meme, opts)]
    ref = check_em.run(codes, meme, argv, stop_dtype=torch.bfloat16, **LOW)
    with open(os.path.join(outdir, f"{base}.metrics.jsonl"), "w") as ev:
        for i, name in enumerate(names):
            own = ref[i]["own"]
            ev.write(json.dumps({"event": "em_done", "motif": name, "iterations": own["its"],
                                 "ll": own["ll"], "q": own["q"]}) + "\n")
            v = [x.numpy() for x in own["v"]]
            with open(os.path.join(outdir, f"{base}_{name}.ihbcp"), "w") as fh:
                fh.write(f"# W = {v[0].shape[1]}\n# K = {len(v) - 1}\n# alphabet = STANDARD\n\n")
                for j in range(v[0].shape[1]):
                    for vk in v:
                        fh.write(" ".join("%.4e" % x for x in vk[:, j]) + "\n")
                    fh.write("\n")


CONTROLS = {"check_em": write_em}


def loose_stop(cli) -> None:
    """A fault planted in the program: its EM stop test takes 100 times the
    epsilon that the job's command line states (the reference reads the
    command line, so it judges by the stated one)."""
    real = cli.params_from_args

    def params_from_args(argv):
        p = real(argv)
        p.epsilon *= 100
        return p

    cli.params_from_args = params_from_args


FAULTS = {"loose_stop": loose_stop}


def readings(cell, seeds: list, control_seeds: list, device, work: str) -> list:
    """[{"seed", "side" ("program" or "control"), "numbers", "seconds"}]."""
    import run as run_mod

    judge = spec_mod.check(cell.workload["check"])
    out = []
    sides = [("program", s) for s in seeds] + [("control", s) for s in control_seeds]
    for side, seed in sides:
        d = tempfile.mkdtemp(dir=work)
        inp = traffic.make_input(cell.config, d, [seed & (2 ** 64 - 1), 0], "pool0")
        outdir = os.path.join(d, "out")
        argv = [outdir, inp.fasta, "--PWMFile", inp.meme, "--jsonl", "--seed",
                str(run_mod.job_seed(seed, 0)), *cell.argv_flags]
        t0 = time.perf_counter()
        if side == "program":
            from bammmotif2_tpu_torch import cli

            run_mod.run_job(cli, device, cell, inp, outdir, run_mod.job_seed(seed, 0))
        else:
            os.makedirs(outdir)
            CONTROLS[cell.workload["check"]](
                outdir, "pool0", torch.as_tensor(inp.codes, device=device), inp.meme, argv)
        secs = time.perf_counter() - t0
        nums = judge({"codes": inp.codes, "meme": inp.meme, "argv": argv, "outdir": outdir},
                     device)
        rec = {"seed": seed, "side": side, "numbers": nums, "seconds": secs}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        shutil.rmtree(d)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="plant this fault in the program for its --seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    cell = spec_mod.cell(args.workload)
    if args.fault:
        from bammmotif2_tpu_torch import cli

        FAULTS[args.fault](cli)
    work = tempfile.mkdtemp(prefix="readings_", dir=tempfile.gettempdir())
    try:
        recs = readings(cell, args.seeds, args.control_seeds, torch.device("cuda", 0), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"workload": args.workload, "fault": args.fault, "card": torch.cuda.get_device_name(0),
                       "readings": recs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
