#!/usr/bin/env python3
"""``readings.py`` for cells whose check is ``check_fdr`` (``BENCHMARK.json``
lists none yet: ``c4.em_fdr``'s runs spread wider than its bound holds,
PERF.md §7):

    python3 benchmark/readings_fdr.py --workload CELL --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--fault NAME] [--out FILE]

The same readings, with the control of ``--EM --FDR`` jobs beside
``readings.CONTROLS``' own: the plain evaluation of ``reference.
check_fdr`` computed in bfloat16 with float32 sums (each fold's EM to its
own stop), its ``.zoops.stats`` and ``.mops.stats`` tables, ``fdr_done``
events and fold iterations written in the program's formats.  Faults:
``readings.FAULTS``, and ``shifted_negatives`` (each fold's negatives
sampled from the key of --seed + fold + 1).
"""

from __future__ import annotations

import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]

import torch  # noqa: E402

import readings  # noqa: E402
from reference import check_em, check_fdr, flags  # noqa: E402


def write_fdr(outdir: str, base: str, codes, meme: str, argv: list) -> None:
    """The control's --FDR outputs, as the program writes them."""
    opts = flags.parse(argv)
    names = [n for n, _p, _s in check_em.seeds(meme, opts)]
    ref = check_fdr.run(codes.to(torch.int64), meme, argv, stop_dtype=torch.bfloat16,
                        **readings.LOW)
    groups, *_ = check_em.models(codes.to(torch.int64), meme, opts)
    with open(os.path.join(outdir, f"{base}.metrics.jsonl"), "w") as ev:
        for W, (idx, _v0, _al) in groups.items():
            its = [[ref[i]["folds"][f]["its"] for i in idx]
                   for f in range(len(ref[idx[0]]["folds"]))]
            ev.write(json.dumps({"event": "span", "name": "fdr.group", "id": 2 * W,
                                 "parent": None, "attrs": {"W": W}}) + "\n")
            ev.write(json.dumps({"event": "span", "name": "fdr.fetch", "id": 2 * W + 1,
                                 "parent": 2 * W, "attrs": {"iterations": its}}) + "\n")
        for i, name in enumerate(names):
            ev.write(json.dumps({"event": "fdr_done", "motif": name,
                                 "avrec_zoops": round(ref[i]["avrec_zoops"], 4),
                                 "avrec_mops": round(ref[i]["avrec_mops"], 4)}) + "\n")
            for tag in ("zoops", "mops"):
                s = ref[i][tag]
                with open(os.path.join(outdir, f"{base}_{name}.{tag}.stats"), "w") as fh:
                    fh.write("score\tTP\tFP\tprecision\trecall\tp-value\n")
                    for row in zip(s["score"], s["tp"], s["fp"], s["precision"], s["recall"]):
                        fh.write("%.6g\t%.3f\t%.3f\t%.6f\t%.6f\t1.0000e+00\n" % row)


def shifted_negatives(cli) -> None:
    """A fault planted in the program: each fold samples its negatives from
    the key of --seed + fold + 1, the next fold's."""
    from bammmotif2_tpu_torch.evaluation import fdr

    real = fdr.threefry

    class Shifted:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def prng_key(seed, device="cpu"):
            return real.prng_key(seed + 1, device)

    fdr.threefry = Shifted()


readings.CONTROLS["check_fdr"] = write_fdr
readings.FAULTS["shifted_negatives"] = shifted_negatives

if __name__ == "__main__":
    sys.exit(readings.main())
