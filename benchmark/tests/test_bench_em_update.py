"""The yardstick of ``em_update_roofline`` (``benchlib/update_bytes.py``)
against a hand count, and the readers of the two metrics that read what
the program's tracer adds for order-4 models, ``em_update_roofline`` and
``write_values_per_s``, on hand-made runs, and on runs of a program that
records neither."""

import pytest

import run
from benchlib import roofline, spec, update_bytes


def test_seed_pass_bytes_by_hand():
    # K=2, W=10, N=10,000: R = 84, R1 = 85
    counts = 2 * 8 * 85 * 10      # float64 counts read and zeroed
    logz = 4 * 10_000             # the pass's log marginals
    v = 2 * 4 * 84 * 10           # conditionals read and written
    lut = 4 * 84 * 10             # the LUT's rows but the sentinel
    small = 4 * 3 * 10 + 4 * 84   # alphas, the background's conditionals
    assert update_bytes.seed_pass_bytes(85, 10, 10_000, 2) == counts + logz + v + lut + small
    assert counts + logz + v + lut + small == 64_136
    # K=4, W=12: 1,365 rows
    assert update_bytes.seed_pass_bytes(1365, 12, 10_000, 4) == (
        16 * 1365 * 12 + 40_000 + 12 * 1364 * 12 + 4 * 5 * 12 + 4 * 1364)
    b = update_bytes.update_bound(100, 85, 10, 10_000, 2)
    assert b["bytes"] == 100 * 64_136 and b["bound_term"] == "bytes"
    assert b["bound_ms"] == pytest.approx(100 * 64_136 / roofline.HBM_BYTES_PER_S * 1e3)


class FakeWindow:
    def __init__(self, device_s):
        self.device_s = device_s

    def kernel(self, name):
        return (3, self.device_s) if name == "em_update_kernel" else (0, 0.0)


class FakeInput:
    def __init__(self, n, length):
        import numpy as np

        self.codes = np.zeros((n, length), np.int8)


def group(W, K, its, R1=None):
    attrs = {"W": W, "K": K, "M": len(its), "iterations": its}
    if R1 is not None:
        attrs["R1"] = R1
    return {"event": "span", "name": "em.group", "attrs": attrs}


def traced_run(spans, device_s=1e-3):
    r = run.Run(None, [FakeInput(10_000, 200)])
    r.traced = [{"input": 0, "argv": ["out", "in.fasta"], "events": {"span": spans}}]
    r.window = FakeWindow(device_s)
    return r


def test_update_roofline_reads_the_groups_passes():
    spans = [group(8, 4, [10, 20], 1365), group(12, 4, [5], 1365)]
    want_ms = (update_bytes.update_bound(30, 1365, 8, 10_000, 4)["bound_ms"]
               + update_bytes.update_bound(5, 1365, 12, 10_000, 4)["bound_ms"])
    got = spec.reader("em_update_roofline")(traced_run(spans, 2e-3))
    assert got == pytest.approx(100 * want_ms / 1e3 / 2e-3, rel=1e-12)


def test_update_roofline_finds_nothing_without_r1():
    read = spec.reader("em_update_roofline")
    assert read(traced_run([group(8, 2, [10])])) is None  # a program without the attribute
    assert read(traced_run([])) is None
    r = traced_run([group(8, 4, [10], 1365)])
    r.window = None  # untraced
    assert read(r) is None


def job(values, write_ms):
    spans = [{"name": "write", "start_ns": 0, "end_ns": int(write_ms * 1e6)}]
    counts = {} if values is None else {"write.values": values}
    return {"events": {"span": spans, "counts": [{"counts": counts}]}}


def test_write_values_per_s():
    read = spec.reader("write_values_per_s")
    r = run.Run(None, [])
    r.jobs = [job(1000, 10), job(3000, 30)]
    assert read(r) == pytest.approx(4000 / 0.040, rel=1e-12)
    r.jobs = [job(1000, 10), job(None, 30)]  # a program without the counter
    assert read(r) is None
    r.jobs = []
    assert read(r) is None
