"""The readers of the program's spans on hand-made runs whose span events
are known, and on a run of a program that writes none."""

import pytest

from benchlib import spec

import run

MS = 10 ** 6


def sp(i, name, parent, start_ms, end_ms):
    return {"event": "span", "name": name, "id": i, "parent": parent, "run": "r",
            "start_ns": start_ms * MS, "end_ns": end_ms * MS, "attrs": {}}


def job_spans(scale: int) -> list:
    """One --EM job's spans, its times scaled by ``scale``: read 4, background
    10, a write 1, seeds 3, em 100 holding two groups with loops of 30 and 40
    (a loop outside ``em`` is not taken off it), a write 5."""
    k = scale
    return [sp(2, "read", 1, 0, 4 * k), sp(3, "background", 1, 4 * k, 14 * k),
            sp(4, "write", 1, 14 * k, 15 * k), sp(5, "seeds", 1, 15 * k, 18 * k),
            sp(7, "em.prepare", 6, 18 * k, 20 * k), sp(8, "em.loop", 6, 20 * k, 50 * k),
            sp(6, "em.group", 9, 18 * k, 55 * k), sp(11, "em.loop", 10, 55 * k, 95 * k),
            sp(10, "em.group", 9, 55 * k, 100 * k), sp(9, "em", 1, 18 * k, 118 * k),
            sp(12, "em.loop", 1, 118 * k, 119 * k), sp(13, "write", 1, 119 * k, 124 * k),
            sp(1, "run", None, 0, 125 * k)]


def make_run(*span_lists) -> "run.Run":
    r = run.Run(None, [])
    r.jobs = [{"events": {"span": spans} if spans else {"em_done": []}} for spans in span_lists]
    return r


# the readers' values (s) on job_spans(1) and job_spans(3)
EXPECTED = {"read_s.refine": (0.004, 0.012), "background_s.refine": (0.010, 0.030),
            "seeds_s.refine": (0.003, 0.009), "em_host_s.refine": (0.030, 0.090),
            "write_s.refine": (0.006, 0.018)}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_means_each_jobs_sum(name):
    read = spec.reader(name)
    one, three = EXPECTED[name]
    assert read(make_run(job_spans(1))) == pytest.approx(one, rel=1e-12)
    assert read(make_run(job_spans(1), job_spans(3))) == pytest.approx((one + three) / 2,
                                                                      rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_spans(name):
    read = spec.reader(name)
    assert read(make_run()) is None
    assert read(make_run(None, None)) is None
    assert read(make_run(job_spans(1), None)) is None


def test_the_five_and_the_loops_cover_the_run():
    """read + background + seeds + em_host + write + the loops in em: 123 of
    the run's 125 ms (the loop outside em, 1 ms, is not counted)."""
    r = make_run(job_spans(1))
    parts = sum(spec.reader(name)(r) for name in EXPECTED)
    assert parts + 0.070 == pytest.approx(0.123, rel=1e-12)
