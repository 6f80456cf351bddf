"""Structured run metrics: the JSONL event stream and the run's spans.

The port's copy of ``bammmotif2_tpu.utils.metrics``: an upgrade of the
reference's stdout prints (``main.cpp`` runtime
printouts, ``--verbose`` per-iteration log-likelihoods — SURVEY.md §5
Metrics/logging row): every pipeline stage emits one JSON object per line
to ``<outdir>/<basename>.metrics.jsonl`` when ``--jsonl`` is set, carrying
the numbers a production deployment monitors (per-motif EM iterations,
final log-likelihood, q, windows/sec, scan hit counts, FDR summaries,
wall-clock per stage).

Beside the events, the port traces itself.  ``tracing()`` makes a run's
``Trace`` the active one (``cli.run_pipeline`` opens one a call); while it
is active, ``span(name, **attrs)`` records each block it wraps (name,
``start_ns``/``end_ns`` on ``time.time_ns``'s Unix clock, ``id``, the
enclosing span's id as ``parent``, the run's id as ``run``, ``attrs``) and
``count(name, n)`` adds to the run's counters.  A span times its block
whether or not a trace is active (``.seconds``).  Under ``torch.profiler``
each span also opens ``record_function("bamm::<name>")``, so the stages
lie on the profiler's timeline: Kineto stamps its events with the same
Unix clock.  Under ``--jsonl`` the run ends with one ``span`` event a span
(the record's keys), then one ``counts`` event (``run``, ``counts``: name
-> total), then ``run_done``.  No span or counter runs inside a captured
CUDA graph or a loop's iterations, and none reads the device.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import time
import uuid

import torch
from torch.autograd import profiler as _autograd_profiler

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("bamm_trace", default=None)


class Trace:
    """One run's spans (records, in the order they ended) and counters."""

    def __init__(self):
        self.run = uuid.uuid4().hex[:16]
        self.spans: list = []
        self.counts: dict = {}
        self._ids = itertools.count(1)
        self._open: list = []  # ids of the spans open now, outermost first

    def export(self) -> dict:
        return {"spans": list(self.spans), "counts": dict(self.counts)}


@contextlib.contextmanager
def tracing():
    """Make a new ``Trace`` the active one for the block; yields it."""
    trace = Trace()
    token = _ACTIVE.set(trace)
    try:
        yield trace
    finally:
        _ACTIVE.reset(token)


class span:
    """Times its block (``.seconds``); records it in the active trace, if
    any, and annotates it for a running profiler.  ``attrs`` may be added
    to inside the block: the record takes them at its end."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "_trace", "_id", "_parent", "_annot")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "span":
        self._annot = None
        if _autograd_profiler._is_profiler_enabled:
            self._annot = torch.profiler.record_function(f"bamm::{self.name}")
            self._annot.__enter__()
        trace = self._trace = _ACTIVE.get()
        if trace is not None:
            self._id = next(trace._ids)
            self._parent = trace._open[-1] if trace._open else None
            trace._open.append(self._id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        trace = self._trace
        if trace is not None:
            trace._open.pop()
            trace.spans.append({"name": self.name, "start_ns": self.start_ns,
                                "end_ns": self.end_ns, "id": self._id, "parent": self._parent,
                                "run": trace.run, "attrs": self.attrs})
        if self._annot is not None:
            self._annot.__exit__(*exc)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the active trace's counter ``name`` (no trace: nothing)."""
    trace = _ACTIVE.get()
    if trace is not None:
        trace.counts[name] = trace.counts.get(name, 0) + n


def self_seconds(spans: list) -> dict:
    """id -> a span's self time: its duration less the part of it that its
    children's spans cover."""
    children: dict = {}
    for s in spans:
        children.setdefault(s["parent"], []).append((s["start_ns"], s["end_ns"]))
    out = {}
    for s in spans:
        covered, end = 0, s["start_ns"]
        for a, b in sorted(children.get(s["id"], ())):
            a, b = max(a, end), min(b, s["end_ns"])
            if b > a:
                covered += b - a
                end = b
        out[s["id"]] = (s["end_ns"] - s["start_ns"] - covered) / 1e9
    return out


class MetricsLogger:
    """Append-only JSONL event writer; a no-op when disabled."""

    def __init__(self, path: str | None):
        self.path = path
        self._fh = open(path, "w") if path else None
        self.t0 = time.perf_counter()

    def event(self, kind: str, **fields) -> None:
        if self._fh is None:
            return
        rec = {"event": kind, "t": round(time.perf_counter() - self.t0, 4)}
        rec.update(fields)
        self._fh.write(json.dumps(rec, default=_jsonable) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(x):
    try:
        import numpy as np

        if isinstance(x, (np.integer,)):
            return int(x)
        if isinstance(x, (np.floating,)):
            return float(x)
        if isinstance(x, np.ndarray):
            return x.tolist()
    except ImportError:
        pass
    return str(x)
