"""What the readers of the program's spans share.  A job run with
``--jsonl`` ends its event file with one ``span`` event a span of the
port's tracer (``bammmotif2_tpu_torch/utils/metrics.py``: ``name``,
``start_ns``, ``end_ns``, ``id``, ``parent``, ``run``, ``attrs``); a
program without the tracer writes none, and its readers return None."""

from __future__ import annotations


def seconds(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e9


def per_job_mean(run, per_job):
    """The mean over the window's jobs of ``per_job(spans)``, None where a
    job has no spans."""
    values = []
    for job in run.jobs:
        spans = job["events"].get("span")
        if not spans:
            return None
        values.append(per_job(spans))
    return sum(values) / len(values) if values else None


def total(name: str):
    """A job's seconds in spans named ``name``."""
    return lambda spans: sum(seconds(s) for s in spans if s["name"] == name)


def less_inner(outer: str, inner: str):
    """A job's seconds in spans named ``outer`` less those of the spans
    named ``inner`` below them."""
    def per_job(spans):
        by_id = {s["id"]: s for s in spans}

        def below_outer(s):
            while s["parent"] is not None:
                s = by_id[s["parent"]]
                if s["name"] == outer:
                    return True
            return False

        return total(outer)(spans) - sum(seconds(s) for s in spans
                                         if s["name"] == inner and below_outer(s))
    return per_job
