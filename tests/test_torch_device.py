"""The port's public entry points run on the card unless the caller asks
for the CPU: called without a device where there is no CUDA, each raises
the error that says to pass device='cpu' (nothing falls back to the CPU
quietly); called with device='cpu', each runs."""

import os

import numpy as np
import pytest
import torch

from bammmotif2_tpu_torch import cli
from bammmotif2_tpu_torch.evaluation import fdr
from bammmotif2_tpu_torch.generator import seqgen
from bammmotif2_tpu_torch.models import seeds
from bammmotif2_tpu_torch.models.background import BackgroundModel
from bammmotif2_tpu_torch.refinement import gibbs, multi
from bammmotif2_tpu_torch.scoring import scan
from bammmotif2_tpu_torch.utils.alphabet import Alphabet
from bammmotif2_tpu_torch.utils.config import Params
from bammmotif2_tpu_torch.utils.fasta import SequenceSet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    rng = np.random.default_rng(0)
    sset = SequenceSet(rng.integers(0, 4, (24, 30)).astype(np.int8), np.full(24, 30, np.int32),
                       [f"s{i}" for i in range(24)], Alphabet.standard())
    bg = BackgroundModel.from_sequence_set(sset, order=1)
    motif = seeds.motif_from_pwm(seeds.iupac_to_pwm("TGACTC", soft=0.7), 1, sset.base_frequencies())
    return sset, bg, motif, str(tmp_path_factory.mktemp("device"))


def _em(t, **kw):
    return multi.run_em(t[2].copy(), t[1], t[0], Params(EM=True, maxEMIterations=2), **kw)


def _em_multi(t, **kw):
    return multi.run_em_multi([t[2].copy()], t[1], t[0], Params(EM=True, maxEMIterations=2), **kw)


def _gibbs(t, **kw):
    return gibbs.run_gibbs(t[2].copy(), t[1], t[0], Params(CGS=True, maxCGSIterations=2), **kw)


def _gibbs_multi(t, **kw):
    return gibbs.run_gibbs_multi([t[2].copy()], t[1], t[0], Params(CGS=True, maxCGSIterations=2),
                                 **kw)


FDR_PARAMS = Params(FDR=True, cvFold=2, mFold=1, maxEMIterations=2)
ENTRY_POINTS = {
    "run_em": _em,
    "run_em_multi": _em_multi,
    "run_gibbs": _gibbs,
    "run_gibbs_multi": _gibbs_multi,
    "evaluate_motifs": lambda t, **kw: fdr.evaluate_motifs([t[2]], t[1], t[0], FDR_PARAMS, **kw),
    "evaluate_motif": lambda t, **kw: fdr.evaluate_motif(t[2], t[1], t[0], FDR_PARAMS, **kw),
    "score_set_multi": lambda t, **kw: scan.score_set_multi([t[2]], t[1], t[0], **kw),
    "score_set": lambda t, **kw: scan.score_set(t[2], t[1], t[0], **kw),
    "generate_neg_set": lambda t, **kw: seqgen.generate_neg_set(t[1], t[0].lens, **kw),
    "generate_neg_data": lambda t, **kw: seqgen.generate_neg_data(t[1], t[0].lens, 1, 3, 1, False,
                                                                  **kw),
    "mask_motif": lambda t, **kw: seqgen.mask_motif(t[0], t[2], t[1], m_fold=1, **kw),
    "cli.main": lambda t, **kw: cli.main(
        [os.path.join(t[3], f"cli_{len(kw)}"), os.path.join(ROOT, "examples", "positives.fasta"),
         "--PWMFile", os.path.join(ROOT, "examples", "seed.meme")], **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_no_device_without_cuda_raises(small, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu' to run on the CPU"):
        ENTRY_POINTS[name](small)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_device_runs(small, name):
    assert ENTRY_POINTS[name](small, device="cpu") is not None
