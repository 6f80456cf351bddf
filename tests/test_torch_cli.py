"""Port parity: the CLI's --EM, --CGS, --scoreSeqset and --FDR stages against
the JAX package's CLI on examples/, the port's import hygiene, and
--profile."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bammmotif2_tpu import cli as jcli
from bammmotif2_tpu.utils.fasta import read_fasta, write_fasta
from bammmotif2_tpu_torch import cli
from bammmotif2_tpu_torch.models.motif import _read_position_blocks

from tests import torch_outputs
from tests.test_em import planted_set

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS = os.path.join(ROOT, "examples", "positives.fasta")
MEME = os.path.join(ROOT, "examples", "seed.meme")


def _em_events(outdir):
    with open(os.path.join(outdir, "positives.metrics.jsonl")) as fh:
        return [e for e in map(json.loads, fh) if e["event"] == "em_done"]


@pytest.mark.parametrize("extra", [
    ["-k", "0"],
    ["-k", "2", "--saveInitialBaMMs"],
    ["-k", "2", "--ss", "--optimizeQ"],
    ["-k", "2", "--checkpointEvery", "4"],
], ids=["k0", "k2", "k2_ss", "k2_checkpoint"])
def test_cli_matches_jax(tmp_path, extra):
    # --single-device keeps the reference on one device (the port ignores it)
    argv = [POS, "--PWMFile", MEME, "--EM", "--jsonl", "--single-device", *extra]
    jout, out = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcli.main([jout, *argv])
    assert cli.main([out, *argv], device="cpu") == 0
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout))
    for name in ("positives.hbcp", "positives.hbp"):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(jout, name), "rb") as b:
            assert a.read() == b.read(), name
    for name in os.listdir(out):
        if name.endswith((".ihbcp", ".ihbp")):
            a, b = (np.concatenate([np.concatenate(blk) for blk in _read_position_blocks(os.path.join(d, name))])
                    for d in (out, jout))
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=name)
    ev, jev = _em_events(out), _em_events(jout)
    assert [e["iterations"] for e in ev] == [e["iterations"] for e in jev]
    np.testing.assert_allclose([e["ll"] for e in ev], [e["ll"] for e in jev], rtol=1e-5)


def test_scan_and_fdr_match_jax(tmp_path):
    """--EM --scoreSeqset --FDR with numpy-made user negatives: every file
    the two CLIs write agrees within the bars of tests/torch_outputs.py
    (EM-refined models differ by rounding).  A fixed EM budget: converged,
    this run stops on |dll| < epsilon at 38 iterations in one package and 43
    in the other, rounding noise in the stop rule (ROADMAP C)."""
    neg = str(tmp_path / "neg.fasta")
    write_fasta(neg, planted_set(n=300, l=100, motif="ACGTACGT", q=0.0, noise=1.0, seed=11))
    argv = [POS, "--PWMFile", MEME, "--EM", "--scoreSeqset", "--FDR", "--negSeqFile", neg,
            "--savePvalues", "--saveLogOdds", "--jsonl", "--single-device", "-k", "2",
            "--cvFold", "3", "--maxEMIterations", "20"]
    jout, out = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcli.main([jout, *argv])
    assert cli.main([out, *argv], device="cpu") == 0
    m_fold = 300 / read_fasta(POS).n
    res = torch_outputs.compare_dirs(out, jout, refined=True, m_fold=m_fold)
    assert res["files"] == 9 and res["rows_near_cutoff"] <= 2, res
    events = {}
    for d in (out, jout):
        with open(os.path.join(d, "positives.metrics.jsonl")) as fh:
            events[d] = {e["event"]: e for e in map(json.loads, fh)}
    assert events[out]["scan_done"]["windows"] == events[jout]["scan_done"]["windows"]
    assert abs(events[out]["scan_done"]["hits"] - events[jout]["scan_done"]["hits"]) <= 2
    for k in ("avrec_zoops", "avrec_mops"):
        assert events[out]["fdr_done"][k] == pytest.approx(events[jout]["fdr_done"][k], abs=1e-3)


def test_cli_imports_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from bammmotif2_tpu_torch import cli\n"
        f"cli.main([{str(tmp_path)!r}, {POS!r}, '--PWMFile', {MEME!r}, '--EM', '-k', '1',"
        " '--scoreSeqset', '--FDR', '--mFold', '2', '--cvFold', '2', '--CGS',"
        " '--maxCGSIterations', '2'], device='cpu')\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
        "print('no jax')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout
    for ext in ("ihbcp", "occurrence", "zoops.stats", "mops.stats"):
        assert os.path.exists(tmp_path / f"positives_motif_1.{ext}")


@pytest.mark.parametrize("flags", [["--CGS"], ["--FDR", "--CGS"], ["--profile=trace"]],
                         ids=["--CGS", "--FDR --CGS", "--profile=trace"])
def test_unported_stages_raise_before_work(tmp_path, flags):
    """The stages that once raised NotImplementedError before any work
    (--CGS, --FDR --CGS, --profile) run on the CPU and write their outputs."""
    out = tmp_path / "out"
    flags = [f.replace("=trace", f"={tmp_path / 'trace'}") for f in flags]
    assert cli.main([str(out), POS, "--PWMFile", MEME, "--EM", "-k", "1", "--maxEMIterations", "3",
                     "--maxCGSIterations", "3", "--cvFold", "2", "--mFold", "1", "--jsonl", *flags],
                    device="cpu") == 0
    assert (out / "positives_motif_1.ihbcp").exists()
    with open(out / "positives.metrics.jsonl") as fh:
        events = [e["event"] for e in map(json.loads, fh)]
    assert ("cgs_done" in events) == ("--CGS" in flags)
    assert (out / "positives_motif_1.zoops.stats").exists() == ("--FDR" in flags)
    assert (tmp_path / "trace").exists() == any(f.startswith("--profile") for f in flags)


def test_profile_writes_trace(tmp_path):
    """--profile DIR: one Chrome trace of the run in DIR, holding the
    pipeline's ops."""
    trace = tmp_path / "trace"
    cli.main([str(tmp_path / "out"), POS, "--PWMFile", MEME, "--EM", "-k", "1",
              "--maxEMIterations", "2", "--profile", str(trace)], device="cpu")
    files = os.listdir(trace)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json"), files
    with open(trace / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


@pytest.mark.parametrize("stages", [["--CGS"], ["--EM", "--CGS"]], ids=["CGS", "EM_CGS"])
def test_cgs_matches_jax(tmp_path, stages):
    """--CGS (and --EM then --CGS) under --noZSampling --noQSampling: every
    file the two CLIs write agrees within the bars of tests/torch_outputs.py,
    and each cgs_done event reports the same sweeps and q, at the default
    100 sweeps.  A fixed EM budget (see test_scan_and_fdr_match_jax)."""
    argv = [POS, "--PWMFile", MEME, *stages, "--noZSampling", "--noQSampling", "--jsonl",
            "--single-device", "-k", "2", "--maxEMIterations", "20"]
    jout, out = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcli.main([jout, *argv])
    assert cli.main([out, *argv], device="cpu") == 0
    res = torch_outputs.compare_dirs(out, jout, refined=True)
    assert res["files"] == 4, res
    events = {}
    for d in (out, jout):
        with open(os.path.join(d, "positives.metrics.jsonl")) as fh:
            events[d] = [e for e in map(json.loads, fh) if e["event"] == "cgs_done"]
    assert len(events[out]) == len(events[jout]) == 1
    for e, je in zip(events[out], events[jout]):
        assert e["iterations"] == je["iterations"] == 100 and e["q"] == je["q"] == pytest.approx(0.9)
        assert e["seconds"] >= 0


def test_cgs_verbose_prints_as_the_reference(tmp_path, capsys):
    """--CGS --verbose: the port prints no `CGS ` line (the reference's CGS
    stage prints nothing) and the same lines as the reference, the run
    time's digits aside."""
    argv = [POS, "--PWMFile", MEME, "--CGS", "--verbose", "--single-device", "-k", "1",
            "--maxCGSIterations", "3", "--noZSampling", "--noQSampling"]
    jcli.main([str(tmp_path / "jax"), *argv])
    jout = capsys.readouterr().out
    assert cli.main([str(tmp_path / "torch"), *argv], device="cpu") == 0
    out = capsys.readouterr().out

    def lines(text):
        return [re.sub(r"Runtime: [0-9.]+s", "Runtime: s", ln) for ln in text.splitlines()]

    assert not any(ln.startswith("CGS ") for ln in out.splitlines()), out
    assert lines(out) == lines(jout) and any(ln.startswith("Runtime") for ln in lines(out))


def test_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(tmp_path), POS, "--PWMFile", MEME, "--EM"])


def test_reference_command_lines_parse():
    """Both CLIs read a reference command line into the same fields (each
    package has its own Params class, so fields are compared, not objects)."""
    p = cli.params_from_args(
        ["out", "pos.fa", "--PWMFile", "s.meme", "--EM", "--FDR", "-k", "4", "-K", "3",
         "-q", "0.5", "--mFold", "5", "--ss", "--extend", "2", "3", "--no-pallas"]
    )
    assert dataclasses.asdict(p) == dataclasses.asdict(jcli.params_from_args(
        ["out", "pos.fa", "--PWMFile", "s.meme", "--EM", "--FDR", "-k", "4", "-K", "3",
         "-q", "0.5", "--mFold", "5", "--ss", "--extend", "2", "3", "--no-pallas"]
    ))
    assert p.modelOrder == 4 and p.extend == (2, 3) and not p.use_pallas
