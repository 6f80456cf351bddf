"""What the metrics' readers (``benchmark/metrics/<name>.py``) share: each
reads a ``Run`` (``run.py``) and returns a number, or None where the run
holds nothing to read."""

from __future__ import annotations

from reference import bamm, flags


def job_s(run):
    """The window's seconds over its completed jobs."""
    return run.window_s / len(run.jobs) if run.jobs else None


def idle_share(run):
    """100 (1 - the device's busy seconds / the traced jobs' seconds)."""
    w = run.window
    if w is None or w.busy_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)


def mean(xs: list):
    return sum(xs) / len(xs) if xs else None


def em_groups(job: dict) -> dict:
    """{(W, K): (group seconds, [iterations of each seed])} of a job's EM
    stage, from what ``run_pipeline`` returned."""
    out: dict = {}
    for m, r in zip(job["result"]["motifs"], job["result"].get("em_results") or []):
        secs, its = out.get((m.W, m.K), (r.group_seconds, []))
        out[(m.W, m.K)] = (secs, its + [r.iterations])
    return out


def shape(run, job: dict) -> tuple:
    """(S strands, N rows, L length, parsed flags) of a job's input."""
    opts = flags.parse(job["argv"])
    N, L = run.inputs[job["input"]].codes.shape
    return (1 if opts.get("--ss") else 2), N, L, opts


def rows_r1(K: int) -> int:
    """Combined-table rows of an order-K model with its sentinel."""
    return bamm.offsets(K)[-1] + 1


def roofline_share(run, kernel: str, least_ms) -> float | None:
    """100 x the least time of the traced jobs' work (``least_ms(job)``,
    ms) over the device time of ``kernel`` in them."""
    if run.window is None:
        return None
    n, device_s = run.window.kernel(kernel)
    if n == 0 or device_s <= 0:
        return None
    return 100.0 * sum(least_ms(job) for job in run.traced) / 1e3 / device_s

