"""The five canonical configs of BASELINE.json at CI scale, through both
packages: the twin of tests/test_baseline_configs.py.

Each test runs the JAX package and the port on the same planted set
(``tests.test_em.planted_set``) and holds the port to the parity bar of
ROADMAP's North star: the same EM iteration count, ll and q within rtol
1e-5, models within atol 1e-5; and to the JAX test's own checks of the
result.  Two configs involve negatives, whose sampled streams differ
between the packages, so both run on user negatives: config 4's FDR takes
them as ``neg_set`` (as tests/test_torch_fdr.py does), config 5 scans with
``--negSeqFile``; their written files are held to tests/torch_outputs.py's
bars.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bammmotif2_tpu import cli as jcli
from bammmotif2_tpu.evaluation import fdr as jfdr
from bammmotif2_tpu.evaluation.prcurve import average_recall as javerage_recall
from bammmotif2_tpu.models import seeds as jseeds
from bammmotif2_tpu.models.background import BackgroundModel as JBackgroundModel
from bammmotif2_tpu.refinement import em as jem
from bammmotif2_tpu.refinement import multi as jmulti
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu.utils.fasta import write_fasta
from bammmotif2_tpu_torch import cli, convert
from bammmotif2_tpu_torch.evaluation import fdr
from bammmotif2_tpu_torch.evaluation.prcurve import average_recall
from bammmotif2_tpu_torch.refinement import multi

from tests import torch_outputs
from tests.test_em import planted_set

torch.set_num_threads(1)

MOTIF = "TGACTCAG"


@pytest.fixture(scope="module")
def chipseq_like():
    """(JAX set, its background, the port's copies of both)."""
    sset = planted_set(n=250, l=120, motif=MOTIF, q=0.85, noise=0.05)
    jbg = JBackgroundModel.from_sequence_set(sset, order=2)
    return sset, jbg, convert.sequence_set(sset), convert.background(jbg)


def _seed(sset, K, soft=0.6):
    return jseeds.motif_from_pwm(jseeds.iupac_to_pwm(MOTIF, soft=soft), K=K,
                                 f_bg=sset.base_frequencies())


def _consensus(m) -> str:
    return "".join("ACGT"[i] for i in m.v[0].argmax(axis=0))


def _assert_parity(r, jr, m, jm) -> None:
    assert r.iterations == jr.iterations and r.converged == jr.converged
    np.testing.assert_allclose(r.ll, jr.ll, rtol=1e-5)
    np.testing.assert_allclose(r.q, jr.q, rtol=1e-5)
    for a, b in zip(m.v, jm.v):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("config,K", [(1, 0), (2, 2), (3, 4)])
def test_single_seed_em_configs(chipseq_like, config, K):
    """Config 1: order-0 (PWM) EM; config 2: order-2 BaMM with interpolated
    pseudo-counts; config 3: order-4 BaMM with an order-2 background."""
    sset, jbg, psset, bg = chipseq_like
    params = Params(EM=True, q=0.5, modelOrder=K)
    jm = _seed(sset, K)
    m = convert.motif(jm)
    jr = jem.run_em(jm, jbg, sset, params)
    r = multi.run_em(m, bg, psset, convert.params(params), device="cpu")
    _assert_parity(r, jr, m, jm)
    assert _consensus(m) == _consensus(jm) == MOTIF and np.isfinite(r.ll)
    assert len(m.v) == K + 1 and m.v[K].shape[0] == 4 ** (K + 1)
    if config < 3:
        assert r.converged
    for vk in m.v:  # context-normalised at every order
        np.testing.assert_allclose(vk.reshape(-1, 4, vk.shape[1]).sum(axis=1), 1.0, atol=1e-4)


def test_config4_multiseed_fdr(chipseq_like):
    """Config 4: batched refinement of four seeds, then FDR of the first
    refined seed, here with user negatives."""
    sset, jbg, psset, bg = chipseq_like
    params = Params(EM=True, FDR=True, q=0.5, cvFold=2, mFold=3)
    jms = [_seed(sset, 2, soft=s) for s in (0.5, 0.6, 0.7, 0.8)]
    ms = [convert.motif(m) for m in jms]
    jres = jmulti.run_em_multi(jms, jbg, sset, params)
    res = multi.run_em_multi(ms, bg, psset, convert.params(params), device="cpu")
    for r, jr, m, jm in zip(res, jres, ms, jms):
        _assert_parity(r, jr, m, jm)

    neg = planted_set(n=250, l=120, motif="ACGTACGT", q=0.0, noise=1.0, seed=7)
    jf = jfdr.evaluate_motif(jms[0], jbg, sset, params, neg_set=neg)
    f = fdr.evaluate_motif(ms[0], bg, psset, convert.params(params),
                           neg_set=convert.sequence_set(neg), device="cpu")
    # the reference's per-fold iteration counts: its single-seed EM on the
    # same train-masked lengths (its FDRResult keeps none)
    jdata = jem.prepare_data(sset, jbg, 2, False)
    jits = []
    for fold in range(params.cvFold):
        train = np.arange(sset.n) % params.cvFold != fold
        tdata = {**jdata, "lens": jnp.asarray(np.where(train, sset.lens, 0).astype(np.int32))}
        jits.append(jem.run_em(jms[0].copy(), jbg, sset, params, data=tdata,
                               n_real=int(train.sum())).iterations)
    assert f.fold_iterations == jits
    for tag in ("zoops", "mops"):
        a, b = getattr(f, tag), getattr(jf, tag)
        np.testing.assert_allclose(a["score"], b["score"], atol=1e-4, err_msg=tag)
        assert average_recall(a) == pytest.approx(javerage_recall(b), abs=1e-3)
    np.testing.assert_allclose(f.pos_pvalues, jf.pos_pvalues, atol=1e-3)
    # the planted motif separates the positives from the negatives
    assert average_recall(f.zoops) > 0.5 and (f.pos_pvalues < 0.5).mean() > 0.6


def test_config5_scan_with_user_negatives(tmp_path):
    """Config 5: EM, then occurrence scanning with p-values, through both
    CLIs; every written file within tests/torch_outputs.py's bars."""
    sset = planted_set(n=2000, l=100, motif=MOTIF, q=0.5, noise=0.05)
    neg = planted_set(n=2000, l=100, motif="ACGTACGT", q=0.0, noise=1.0, seed=11)
    fasta, neg_fasta = tmp_path / "scan.fasta", tmp_path / "neg.fasta"
    write_fasta(fasta, sset)
    write_fasta(neg_fasta, neg)
    meme = tmp_path / "seed.meme"
    meme.write_text(
        "MEME version 4\n\nMOTIF m1\n"
        "letter-probability matrix: alength= 4 w= 8 nsites= 50\n"
        + "".join(" ".join(f"{p:.3f}" for p in row) + "\n"
                  for row in jseeds.iupac_to_pwm(MOTIF, soft=0.7))
    )
    argv = [str(fasta), "--PWMFile", str(meme), "--EM", "--scoreSeqset", "--pvalCutoff", "0.01",
            "-q", "0.5", "--no-pallas", "--basename", "t", "--negSeqFile", str(neg_fasta)]
    jout, out = tmp_path / "jax", tmp_path / "torch"
    assert jcli.main([str(jout), *argv]) == 0
    assert cli.main([str(out), *argv], device="cpu") == 0
    cmp = torch_outputs.compare_dirs(str(out), str(jout), refined=True)
    assert cmp["files"] == 5
    lines = (out / "t_motif_1.occurrence").read_text().splitlines()
    assert lines[0].startswith("header\t")
    assert len(lines) > 500  # about half the 2000 sequences carry a planted site
    assert os.path.exists(out / "t.hbcp")
