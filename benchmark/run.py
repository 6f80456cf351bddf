#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (bammmotif2_tpu_torch), one cell a
run, on one machine's cards.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell (``BENCHMARK.json``'s ``workloads``; ``benchmark/workloads/
<cell>.json``) is a configuration's inputs (``benchmark/configs/
<config>.json``) under one set of CLI flags.  A run is a closed loop of one
client: jobs back to back, as a pipeline worker or a motif-discovery web
server runs users' jobs, each one call of the port's CLI entry point
(``cli.run_pipeline(cli.params_from_args(argv), device)``, loops graphed)
on one FASTA file and seed MEME file of the run's pool.

Set-up (``setup_s``, from the start of this process): the pool of the
cell's ``pool`` inputs, made by the frozen generators (``benchlib.
traffic``) and written under TMPDIR; then one warm-up job, which loads or
builds the port's libraries (in the checkout's ``bammmotif2_tpu_torch/
_build/``) and captures the cell's loop graphs, as every CLI invocation
does.  The window: jobs cycle through the pool in an order drawn from
--seed, job j passing its own --seed (from --seed and j), until the first
job that ends at or after --seconds; a job-time metric is the window's
seconds over its completed jobs.  The pool is the same set of inputs
whatever --seed (``POOL_ENTROPY``): the iterations EM takes to converge,
and so a job's work, change with every input, and runs of other seeds
would otherwise measure other work.

With --trace 1 the same set-up and window run, then two more jobs run
under torch.profiler, and the line carries the per-layer metrics and
``breakdown`` instead of the end-to-end ones.  CUPTI records a WHILE
node's body only for loop graphs instantiated after the process first
traced, so a short trace comes first, then the graph cache is emptied and
one job, untraced and not counted, builds the loop graphs again; the two
traced jobs replay them, as the window's jobs do, and are what the
trace's readers read.

After the window, with the device's peak memory read and the program's
state freed, ``correct`` compares what the jobs wrote against the plain
reference of ``benchmark/reference/`` (the cell's ``check``), for
``check_jobs`` of the window's jobs drawn from --seed: every number under
its limit (the cell's ``limits``), and no job failed.

The last line of standard output is the result (JSON); the numbers
compared, beside their limits, are the last lines of standard error and
the result's last key.  Exits non-zero, printing no result, without a CUDA
device (or with fewer than the cell asks for), without the port, or when
the process holds a module of JAX or of the JAX package after the window.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

T_START = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]

from benchlib import spec as spec_mod, trace as trace_mod, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "bammmotif2_tpu")
POOL_ENTROPY = 0  # the pool's input p comes from np.random.default_rng([POOL_ENTROPY, p])
TRACED_JOBS = 2


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def job_seed(seed: int, j: int) -> int:
    """The CLI's --seed of job j of a run: 31 bits of a hash of both."""
    h = hashlib.sha256(f"{seed}:{j}".encode()).digest()
    return int.from_bytes(h[:4], "little") >> 1


def nvidia_smi() -> dict:
    """The card's name, power limit and highest SM clock, as nvidia-smi
    reads them (empty where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30).stdout
        name, limit, clock = (x.strip() for x in out.splitlines()[0].split(","))
        return {"name": name, "power_limit_w": float(limit), "clock_max_mhz": float(clock)}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


class Run:
    """What a run has measured, for the metrics' readers: ``setup_s``,
    ``window_s`` and ``jobs`` (the window's completed jobs: each a dict of
    ``index``, ``input``, ``argv``, ``outdir``, ``seconds``, ``result`` (what
    ``run_pipeline`` returned) and ``events`` (its ``--jsonl`` events by
    kind)); with --trace 1 also ``traced`` (the two traced jobs), ``window``
    (``benchlib.trace.Window`` over them), ``card`` (``nvidia_smi``) and
    ``cell``; ``inputs``: the pool."""

    def __init__(self, cell, inputs):
        self.cell, self.inputs = cell, inputs
        self.setup_s = self.window_s = 0.0
        self.jobs: list = []
        self.traced: list = []
        self.window = None
        self.card: dict = {}


def run_job(cli, device, cell, inp, outdir: str, seed: int) -> dict:
    import torch

    argv = [outdir, inp.fasta, "--PWMFile", inp.meme, "--jsonl", "--seed", str(seed),
            *cell.argv_flags]
    t0 = time.perf_counter()
    result = cli.run_pipeline(cli.params_from_args(argv), device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    return {"argv": argv, "outdir": outdir, "seconds": secs, "result": result}


def read_events(job: dict) -> None:
    base = os.path.splitext(os.path.basename(job["argv"][1]))[0]
    job["events"] = {}
    with open(os.path.join(job["outdir"], f"{base}.metrics.jsonl")) as fh:
        for line in fh:
            e = json.loads(line)
            job["events"].setdefault(e["event"], []).append(e)


def measure(cell, seed: int, seconds: float, trace: bool, device, work: str) -> tuple:
    """Set-up, the window and (``trace``) the traced jobs of one run in
    ``work``; returns (Run, failed jobs, device peak bytes)."""
    import torch

    from bammmotif2_tpu_torch import cli
    from bammmotif2_tpu_torch.refinement import graphs

    on_card = torch.device(device).type == "cuda"
    import numpy as np

    if on_card:
        torch.empty(0, device=device)  # the CUDA context
    t_ctx = time.perf_counter()
    pool_dir = os.path.join(work, "pool")
    os.makedirs(pool_dir)
    inputs = [traffic.make_input(cell.config, pool_dir, [POOL_ENTROPY, p], f"pool{p}")
              for p in range(cell.workload["pool"])]
    order = np.random.default_rng([seed & (2 ** 64 - 1), 0]).permutation(len(inputs))
    run = Run(cell, inputs)
    t_pool = time.perf_counter()
    warm = run_job(cli, device, cell, inputs[0], os.path.join(work, "warmup"), job_seed(seed, -1))
    shutil.rmtree(warm["outdir"])
    run.setup_s = time.perf_counter() - T_START
    log(f"set-up {run.setup_s:.3f} s: imports and CUDA context {t_ctx - T_START:.3f} s, "
        f"pool {t_pool - t_ctx:.3f} s, warm-up job {warm['seconds']:.3f} s")

    failed, j = 0, 0
    jobs_dir = os.path.join(work, "jobs")
    t0 = time.perf_counter()
    while True:
        p = int(order[j % len(inputs)])
        outdir = os.path.join(jobs_dir, f"job{j}")
        try:
            job = run_job(cli, device, cell, inputs[p], outdir, job_seed(seed, j))
            job.update(index=j, input=p)
            run.jobs.append(job)
            log(f"job {j}: input {p}, {job['seconds']:.4f} s")
        except Exception:  # a job that raises counts as failed; the loop goes on
            failed += 1
            log(f"job {j} failed:\n{traceback.format_exc()}")
        j += 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    log(f"window {run.window_s:.3f} s, {len(run.jobs)} jobs, {failed} failed")

    if trace:
        if on_card:
            trace_mod.open_window().stop()  # the process's first trace
        graphs.clear()  # rebuilt now, after the first trace, so that CUPTI sees their bodies
        capture = run_job(cli, device, cell, inputs[int(order[j % len(inputs)])],
                          os.path.join(work, "capture"), job_seed(seed, j))
        shutil.rmtree(capture["outdir"])
        j += 1
        prof = trace_mod.open_window() if on_card else None
        for t in range(TRACED_JOBS):
            p = int(order[j % len(inputs)])
            with trace_mod.span(t):
                job = run_job(cli, device, cell, inputs[p], os.path.join(jobs_dir, f"job{j}"),
                              job_seed(seed, j))
            job.update(index=j, input=p)
            run.traced.append(job)
            j += 1
        if prof is not None:
            prof.stop()
            run.window = trace_mod.Window(prof.events())
            del prof
        run.card = nvidia_smi()
    for job in run.jobs + run.traced:
        read_events(job)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    graphs.clear()
    return run, failed, peak


def judge(cell, run: Run, seed: int, device) -> dict:
    """The cell's check on ``check_jobs`` jobs drawn from ``seed``: each
    number's largest value over them, beside its limit."""
    import numpy as np

    judge_fn = spec_mod.check(cell.workload["check"])
    done = run.jobs + run.traced
    n = min(cell.workload["check_jobs"], len(done))
    pick = np.random.default_rng([seed & (2 ** 64 - 1), 1]).choice(len(done), n, replace=False)
    worst: dict = {}
    for i in sorted(int(x) for x in pick):
        job = done[i]
        nums = judge_fn({"codes": run.inputs[job["input"]].codes,
                         "meme": run.inputs[job["input"]].meme,
                         "argv": job["argv"], "outdir": job["outdir"]}, device)
        log(f"check of job {job['index']}: {json.dumps(nums)}")
        for k, v in nums.items():
            worst[k] = max(worst.get(k, float("-inf")), v)
    limits = cell.workload["limits"]
    return {k: {"value": worst.get(k, float("inf")), "limit": lim} for k, lim in limits.items()}


def metrics(cell, run: Run, trace: bool, root: str) -> dict:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones,
    each from its reader; a reader that finds nothing leaves its metric
    out."""
    out = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec_mod.reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def bench_run(cell, seed: int, seconds: float, trace: bool, device, root: str = ROOT) -> dict:
    """One run of ``cell`` (``benchlib.spec.Cell``) on ``device``: the result
    line's dict, the checked numbers under ``checks`` (its last key)."""
    import torch

    work = tempfile.mkdtemp(prefix="bench_", dir=tempfile.gettempdir())
    try:
        run, failed, peak = measure(cell, seed, seconds, trace, device, work)
        line = {"correct": None, "attempted": len(run.jobs) + len(run.traced) + failed,
                "failed": failed, "metrics": metrics(cell, run, trace, root)}
        on_card = torch.device(device).type == "cuda"
        line["device"] = {"platform": "gpu" if on_card else "cpu",
                          "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                          "count": cell.chips, "memory_peak_bytes": int(peak)}
        if trace and run.window is not None:
            line["device"].update(busy_s=run.window.busy_s, window_s=run.window.window_s)
            line["breakdown"] = {"device_ops": run.window.device_ops(),
                                 "idle_gaps": run.window.idle_gaps()}
        for job in run.jobs + run.traced:
            job["result"] = None  # the program's state goes before the reference runs
        run.window = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        checks = judge(cell, run, seed, device)
        log(f"checks {time.perf_counter() - t0:.3f} s")
        line["correct"] = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
        line["checks"] = checks
        return line
    finally:
        shutil.rmtree(work, ignore_errors=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = spec_mod.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    try:
        import bammmotif2_tpu_torch.cli  # noqa: F401
    except ImportError as e:
        log(f"the port (bammmotif2_tpu_torch) cannot be imported: {e}")
        return 3
    line = bench_run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 4
    card = nvidia_smi()
    log(f"card: {card.get('name')}, power limit {card.get('power_limit_w')} W")
    for k, c in line["checks"].items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
