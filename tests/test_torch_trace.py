"""The port's tracer (``bammmotif2_tpu_torch/utils/metrics.py``): spans and
counters of a run, their clock against torch.profiler's, and the spans the
CLI records and writes under --jsonl."""

import json
import os
import time

import pytest
import torch

from bammmotif2_tpu_torch import cli
from bammmotif2_tpu_torch.ops import cuda_update
from bammmotif2_tpu_torch.refinement import multi
from bammmotif2_tpu_torch.utils import metrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS = os.path.join(ROOT, "examples", "positives.fasta")
MEME = os.path.join(ROOT, "examples", "seed.meme")
RECORD_KEYS = {"name", "start_ns", "end_ns", "id", "parent", "run", "attrs"}

EM_SPANS = {"run", "read", "background", "seeds", "write", "em", "em.group", "em.prepare",
            "em.loop", "em.fetch"}
FDR_SCAN_SPANS = EM_SPANS | {"scan", "scan.negatives", "scan.score", "scan.occurrences", "fdr",
                             "fdr.group", "fdr.prepare", "fdr.folds", "fdr.fetch", "fdr.sweeps"}
# each span's parent, but "write"'s, which lies under the stage that writes
PARENT = {"run": None, "read": "run", "background": "run", "seeds": "run", "em": "run",
          "scan": "run", "fdr": "run", "em.group": "em", "em.prepare": "em.group",
          "em.loop": "em.group", "em.fetch": "em.group", "scan.negatives": "scan",
          "scan.score": "scan", "scan.occurrences": "scan", "fdr.group": "fdr",
          "fdr.prepare": "fdr.group", "fdr.folds": "fdr.group", "fdr.fetch": "fdr.group",
          "fdr.sweeps": "fdr.group"}


def inside(child: dict, parent: dict) -> bool:
    return parent["start_ns"] <= child["start_ns"] <= child["end_ns"] <= parent["end_ns"]


def test_spans_nest_with_parent_ids_and_the_trace_run_id():
    with metrics.tracing() as trace:
        with metrics.span("a", x=1):
            with metrics.span("b"):
                pass
            with metrics.span("c") as c:
                c.attrs["n"] = 2  # taken at the span's end
        with metrics.span("d"):
            pass
    assert [s["name"] for s in trace.spans] == ["b", "c", "a", "d"]  # in the order they ended
    by = {s["name"]: s for s in trace.spans}
    assert all(set(s) == RECORD_KEYS for s in trace.spans)
    assert by["a"]["parent"] is None and by["d"]["parent"] is None
    assert by["b"]["parent"] == by["c"]["parent"] == by["a"]["id"]
    assert len({s["id"] for s in trace.spans}) == 4
    assert {s["run"] for s in trace.spans} == {trace.run}
    assert by["a"]["attrs"] == {"x": 1} and by["c"]["attrs"] == {"n": 2}
    assert inside(by["b"], by["a"]) and inside(by["c"], by["a"])
    assert by["b"]["end_ns"] <= by["c"]["start_ns"] and by["a"]["end_ns"] <= by["d"]["start_ns"]
    assert trace.export() == {"spans": trace.spans, "counts": {}}


def test_self_seconds_take_off_the_children_once():
    s = 10 ** 9
    spans = [{"name": "p", "id": 1, "parent": None, "start_ns": 0, "end_ns": 10 * s},
             # two overlapping children and one past the parent's end
             {"name": "c", "id": 2, "parent": 1, "start_ns": 1 * s, "end_ns": 3 * s},
             {"name": "c", "id": 3, "parent": 1, "start_ns": 2 * s, "end_ns": 5 * s},
             {"name": "c", "id": 4, "parent": 1, "start_ns": 9 * s, "end_ns": 12 * s},
             {"name": "g", "id": 5, "parent": 2, "start_ns": 1 * s, "end_ns": 2 * s}]
    assert metrics.self_seconds(spans) == {1: 5.0, 2: 1.0, 3: 3.0, 4: 3.0, 5: 1.0}


def test_counters_and_seconds_with_and_without_a_trace():
    metrics.count("graph.hit")  # no trace: nothing, and no error
    with metrics.span("untraced") as sp:
        time.sleep(0.002)
    assert sp.seconds >= 0.002
    with metrics.tracing() as trace:
        metrics.count("graph.hit")
        metrics.count("graph.hit", 2)
        metrics.count("graph.evict")
        with metrics.tracing() as inner:  # a run inside a run keeps its own records
            metrics.count("graph.hit")
            with metrics.span("inner"):
                pass
        with metrics.span("outer") as sp:
            pass
    with metrics.span("after"):
        pass
    assert trace.counts == {"graph.hit": 3, "graph.evict": 1}
    assert inner.counts == {"graph.hit": 1}
    assert [s["name"] for s in trace.spans] == ["outer"] and sp.seconds >= 0
    assert [s["name"] for s in inner.spans] == ["inner"] and inner.run != trace.run
    assert trace.spans[0]["parent"] is None


def test_spans_lie_on_the_profiler_clock():
    """Each span starts within 2 ms of its bamm:: annotation on the
    profiler's absolute clock.  A process's first annotation takes
    milliseconds to open (the profiler's lazy set-up), so a first span
    warms it and is not compared."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with metrics.span("warm"):
            pass
        with metrics.tracing() as trace:
            for i in range(3):
                with metrics.span(f"step{i}"):
                    torch.ones(64).add_(1)
                    time.sleep(0.003)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    annot = {e.name: t0 + e.time_range.start * 1e3 for e in prof.events()
             if e.name.startswith("bamm::")}
    assert sorted(annot) == ["bamm::step0", "bamm::step1", "bamm::step2", "bamm::warm"]
    assert [s["name"] for s in trace.spans] == ["step0", "step1", "step2"]
    for s in trace.spans:
        assert abs(s["start_ns"] - annot[f"bamm::{s['name']}"]) <= 2e6, (s, annot)


def test_record_function_only_under_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def record(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", record)
    with metrics.tracing():
        with metrics.span("quiet"):
            pass
    with metrics.span("quiet"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with metrics.span("annotated"):
            pass
    assert entered == ["bamm::annotated"]


def run_cli(out, flags) -> list:
    assert cli.main([str(out), POS, "--PWMFile", MEME, "--jsonl", "--single-device", *flags],
                    device="cpu") == 0
    with open(out / "positives.metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


# the counters: no graphs on the CPU; the k-mer index built once, by the
# background fit, and read again by EM (and the scan's fit, FDR's data and
# its fold backgrounds); beside them the EM loops' seed passes (the EM
# stage's and FDR's folds' iterations), none skipped on the PyTorch update
@pytest.mark.parametrize("flags, names, counts", [
    (["--EM", "--maxEMIterations", "20"], EM_SPANS,
     {"kmer_index.build": 1, "kmer_index.hit": 1}),
    (["--EM", "--maxEMIterations", "4", "--FDR", "--scoreSeqset", "--cvFold", "2", "--mFold",
      "1"], FDR_SCAN_SPANS, {"kmer_index.build": 1, "kmer_index.hit": 4}),
], ids=["EM", "FDR_scoreSeqset"])
def test_cli_writes_its_spans(tmp_path, flags, names, counts):
    events = run_cli(tmp_path / "out", flags)
    kinds = [e["event"] for e in events]
    n = kinds.count("span")
    # the spans, then the counters, then run_done, last
    assert kinds[-n - 2:] == ["span"] * n + ["counts", "run_done"]
    spans = [{k: e[k] for k in RECORD_KEYS} for e in events if e["event"] == "span"]
    assert {s["name"] for s in spans} == names
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "run" and {s["run"] for s in spans} == {root["run"]}
    got = dict(events[-2]["counts"])
    passes = sum(e["iterations"] for e in events if e["event"] == "em_done") + sum(
        sum(map(sum, e["attrs"]["iterations"])) for e in events
        if e["event"] == "span" and e["name"] == "fdr.fetch")
    assert got.pop("em.seed_passes") == passes > 0 and got.pop("em.seed_passes_skipped") == 0
    assert got.pop("write.values") == file_values(tmp_path / "out")
    assert events[-2]["run"] == root["run"] and got == counts
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s["parent"] is None or inside(s, by_id[s["parent"]]), s
    top = [s for s in spans if s["parent"] == root["id"]]
    covered = sum(s["end_ns"] - s["start_ns"] for s in top)
    assert covered >= 0.95 * (root["end_ns"] - root["start_ns"])
    for s in spans:
        parent = by_id[s["parent"]]["name"] if s["parent"] else None
        if s["name"] == "write":
            assert parent in ("run", "scan.occurrences", "fdr"), s
        else:
            assert parent == PARENT[s["name"]], s
    (group,) = [s for s in spans if s["name"] == "em.group"]
    em = [e for e in events if e["event"] == "em_done"]
    assert group["attrs"]["iterations"] == [e["iterations"] for e in em]
    assert group["attrs"]["W"] == 8 and group["attrs"]["M"] == len(em) == 1
    assert group["attrs"]["windows"] > 0
    if "fdr.fetch" in names:
        (fetch,) = [s for s in spans if s["name"] == "fdr.fetch"]
        its = fetch["attrs"]["iterations"]
        assert len(its) == 2 and all(len(f) == 1 and 1 <= f[0] <= 4 for f in its), its
        assert {s["attrs"]["what"] for s in spans if s["name"] == "write"} == {
            "background", "models", "occurrences", "PR curves"}


def file_values(outdir) -> int:
    """The numbers in the model files (.ihbcp, .ihbp, .hbcp, .hbp) of a run."""
    n = 0
    for name in os.listdir(outdir):
        if name.endswith((".ihbcp", ".ihbp", ".hbcp", ".hbp")):
            with open(outdir / name) as fh:
                n += sum(len(line.split()) for line in fh if not line.startswith("#"))
    return n


@pytest.mark.parametrize("K, R1", [(2, 85), (4, 1365)])
def test_em_group_carries_the_kernels_plan(tmp_path, K, R1):
    """The em.group span of an --EM run at K=2 and K=4 carries R1, the
    update's table (shared memory while a seed's float table fits
    SMEM_TABLE) and B1's plan; write.values counts every number of the
    model files written, the background's and each seed's initial and
    refined BaMM."""
    events = run_cli(tmp_path / "out", ["--EM", "-k", str(K), "--maxEMIterations", "3",
                                        "--saveInitialBaMMs"])
    (group,) = [e for e in events if e["event"] == "span" and e["name"] == "em.group"]
    attrs = group["attrs"]
    assert attrs["R1"] == R1 and attrs["K"] == K and attrs["W"] == 8
    assert attrs["update_table"] == ("smem" if 4 * R1 * 8 <= cuda_update.SMEM_TABLE else "device")
    assert attrs["update_table"] == "smem"  # K=4 fits at W=8 (43.7 KB)
    assert attrs["seeds_per_block"] == 1 and attrs["smem_lut"] is True
    assert attrs["counts"] == "fixed"
    counts = events[-2]["counts"]
    # the background (2 x 84 values at -K 2) and two BaMMs of 2 x R x W values
    assert counts["write.values"] == file_values(tmp_path / "out") == 2 * 84 + 4 * (R1 - 1) * 8


@pytest.mark.parametrize("K, W, table, counts, lut", [
    (2, 12, "smem", "fixed", True), (2, 30, "smem", "fixed", True),
    (3, 30, "smem", "fixed", True), (4, 8, "smem", "fixed", True),
    (4, 10, "device", "fixed", True), (4, 12, "device", "fixed", True),
    (4, 20, "device", "float", False), (5, 12, "device", "global", False)])
def test_plan_attrs_follow_the_kernels_tables(K, W, table, counts, lut):
    """``plan_attrs`` at c4's and c3's rows (10k x 200 bp, both strands):
    the update's table leaves shared memory past SMEM_TABLE (A=4: K=4 from
    W=10), B1's counts go float where fixed point does not fit and global
    where neither does, and the LUT stays in shared memory beside fixed
    counts only."""
    attrs = multi.plan_attrs(4, K, W, 4, (2, 10_000, 200))
    R1 = sum(4 ** (k + 1) for k in range(K + 1)) + 1
    assert attrs["R1"] == R1 and attrs["seeds_per_block"] == 1
    assert attrs["update_table"] == table == (
        "smem" if 4 * R1 * W <= cuda_update.SMEM_TABLE else "device")
    assert attrs["counts"] == counts and attrs["smem_lut"] is lut


def test_run_pipeline_returns_its_trace_and_reads_seconds_from_spans(tmp_path):
    """One run id a run_pipeline call; the EM results' group seconds are
    their em.loop span's."""
    runs = []
    for i in range(2):
        params = cli.params_from_args([str(tmp_path / f"out{i}"), POS, "--PWMFile", MEME, "--EM",
                                       "--maxEMIterations", "3", "--single-device"])
        out = cli.run_pipeline(params, "cpu")
        spans = out["trace"]["spans"]
        assert {s["run"] for s in spans} == {spans[0]["run"]}
        runs.append(spans[0]["run"])
        (loop,) = [s for s in spans if s["name"] == "em.loop"]
        assert out["em_results"][0].group_seconds == (loop["end_ns"] - loop["start_ns"]) / 1e9
        (root,) = [s for s in spans if s["name"] == "run"]
        assert (root["end_ns"] - root["start_ns"]) / 1e9 <= out["runtime_seconds"]
    assert runs[0] != runs[1]


def test_profile_trace_holds_the_spans(tmp_path):
    trace = tmp_path / "trace"
    assert cli.main([str(tmp_path / "out"), POS, "--PWMFile", MEME, "--EM", "-k", "1",
                     "--maxEMIterations", "2", "--profile", str(trace)], device="cpu") == 0
    (name,) = os.listdir(trace)
    with open(trace / name) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"bamm::run", "bamm::em", "bamm::em.group", "bamm::em.loop", "bamm::write"} <= names
