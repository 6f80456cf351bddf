"""Port parity: background model, BaMM math, seeds and the MotifSet
(models/*.py) against the JAX package."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bammmotif2_tpu.models import background as jbackground
from bammmotif2_tpu.models import motif as jmotif
from bammmotif2_tpu.models import motifset as jmotifset
from bammmotif2_tpu.utils.config import Params
from bammmotif2_tpu_torch import convert
from bammmotif2_tpu_torch.models import background, motif, motifset, seeds
from bammmotif2_tpu_torch.ops import encode
from bammmotif2_tpu_torch.utils import alphabet as palphabet
from bammmotif2_tpu_torch.utils.config import Params as PParams

from tests.test_torch_encode import ragged_set

torch.set_num_threads(1)

EXAMPLES_MEME = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "seed.meme")


def _blocks(path):
    return np.concatenate([np.concatenate(b) for b in motif._read_position_blocks(path)])


@pytest.mark.parametrize("A,K", [(4, 0), (4, 2), (4, 4), (5, 3)])
def test_model_math_matches_jax(A, K):
    rng = np.random.default_rng(A * 10 + K)
    W, M = 7, 3
    R = encode.num_rows(A, K)
    C = rng.gamma(2.0, 3.0, (M, R + 1, W)).astype(np.float32)
    alphas = rng.uniform(0.5, 20, (M, K + 1, W)).astype(np.float32)
    f_bg = rng.dirichlet(np.ones(A)).astype(np.float32)
    bg_flat = rng.uniform(0.05, 0.5, R).astype(np.float32)
    # the port's math is batch-generic: all M seeds in one call
    counts = motif.counts_from_combined(convert.floats(C[:, :R], "cpu"), A, K)
    v = motif.update_v(counts, convert.floats(alphas, "cpu"), convert.floats(f_bg, "cpu"))
    s_flat = motif.log_odds_lut(v, convert.floats(bg_flat, "cpu"))
    v2 = motif.update_v_from_combined(
        convert.floats(C, "cpu"), convert.floats(alphas, "cpu"), convert.floats(f_bg, "cpu"), A=A, K=K
    )
    for m in range(M):
        jc = jmotif.counts_from_combined(jnp.asarray(C[m, :R]), A, K)
        jv = jmotif.update_v(jc, jnp.asarray(alphas[m]), jnp.asarray(f_bg))
        js = jmotif.log_odds_lut(jv, jnp.asarray(bg_flat))
        for k in range(K + 1):
            np.testing.assert_allclose(counts[k][m].numpy(), np.asarray(jc[k]), rtol=1e-6)
            np.testing.assert_allclose(v[k][m].numpy(), np.asarray(jv[k]), rtol=1e-6)
            np.testing.assert_array_equal(v2[k][m].numpy(), v[k][m].numpy())
        # log-odds are log(v) - log(bg) with |log| ~ 1: the absolute floor
        # is 2 f32 spacings at 1 (2.4e-7), whatever the difference's size
        np.testing.assert_allclose(s_flat[m].numpy(), np.asarray(js), rtol=1e-6, atol=2.4e-7)
        assert s_flat.dtype == torch.float32 and not s_flat[m, -1].any()


@pytest.mark.parametrize("alphabet", ["STANDARD", "METHYLC"])
@pytest.mark.parametrize("order,ss", [(0, False), (2, False), (2, True), (3, False)])
def test_background_files_byte_identical(tmp_path, order, ss, alphabet):
    sset = ragged_set(alphabet, n=40, seed=order)
    psset = convert.sequence_set(sset)
    bg = background.BackgroundModel.from_sequence_set(psset, order=order, alpha=10.0, ss=ss)
    jbg = jbackground.BackgroundModel.from_sequence_set(sset, order=order, alpha=10.0, ss=ss)
    paths = bg.write(str(tmp_path / "t"), "bg")
    jpaths = jbg.write(str(tmp_path / "j"), "bg")
    for p, jp in zip(paths, jpaths):
        with open(p, "rb") as a, open(jp, "rb") as b:
            assert a.read() == b.read()
    for K in (0, order, 4):
        np.testing.assert_array_equal(bg.conditional_flat(K), jbg.conditional_flat(K))
    back = background.BackgroundModel.read(paths[0], psset.alphabet)
    np.testing.assert_allclose(np.concatenate(back.v), np.concatenate(bg.v), rtol=1e-6)


def _seed_params(tmp_path, **kw):
    sites = tmp_path / "sites.txt"
    sites.write_text("TGACTCAG\nTGAGTCAG\n# comment\nTTACTCAG\nTGACTCAT\n")
    base = dict(PWMFile=None, modelOrder=2, modelAlpha=1.0, modelBeta=7.0, modelGamma=3.0)
    base.update(kw)
    if base.pop("sites", False):
        base["bindingSiteFile"] = str(sites)
    return Params(**base)


@pytest.mark.parametrize(
    "seed_kw",
    [
        dict(PWMFile=EXAMPLES_MEME),
        dict(PWMFile=EXAMPLES_MEME, modelOrder=4, extend=(2, 1)),
        dict(pattern="TGASTCA;BDHVN", modelOrder=1),
        dict(sites=True, modelOrder=3),
        dict(sites=True, modelOrder=0, modelAlpha=3.0, extend=(0, 2)),
    ],
    ids=["meme", "meme_k4_extend", "iupac", "sites_k3", "sites_k0_extend"],
)
def test_seeded_models_match_jax(tmp_path, seed_kw):
    params = _seed_params(tmp_path, **seed_kw)
    f_bg = np.array([0.3, 0.2, 0.2, 0.3])
    ms = motifset.load_motifs(convert.params(params), f_bg)
    jms = jmotifset.load_motifs(params, f_bg)
    assert [m.name for m in ms] == [m.name for m in jms]
    for m, jm in zip(ms, jms):
        assert (m.W, m.K) == (jm.W, jm.K)
        np.testing.assert_array_equal(m.alphas, jm.alphas)
        p = m.write(str(tmp_path / "t"), f"init_{m.name}")
        jp = jm.write(str(tmp_path / "j"), f"init_{m.name}")
        for a, b in zip(p, jp):
            np.testing.assert_allclose(_blocks(a), _blocks(b), rtol=1e-6, atol=1e-10)
        back = motif.Motif.read(p[0], f_bg=f_bg)
        np.testing.assert_allclose(np.concatenate(back.v), np.concatenate(m.v), rtol=1e-3)


def test_bamm_file_with_base_background(tmp_path):
    jbg = jbackground.BackgroundModel(0, 10.0, [np.array([0.1, 0.4, 0.4, 0.1])])
    hbcp, _ = jbg.write(str(tmp_path), "base")
    seed = seeds.motif_from_pwm(seeds.iupac_to_pwm("TGACTCA"), 2, np.full(4, 0.25))
    ihbcp, _ = seed.write(str(tmp_path), "saved")
    params = Params(BaMMFile=ihbcp, baseBgModelFile=hbcp, modelOrder=2, extend=(1, 1))
    (m,) = motifset.load_motifs(convert.params(params), np.full(4, 0.25))
    (jm,) = jmotifset.load_motifs(params, np.full(4, 0.25))
    np.testing.assert_array_equal(m.f_bg, jm.f_bg)
    for a, b in zip(m.v, jm.v):
        np.testing.assert_array_equal(a, b)


def test_seed_readers_and_errors(tmp_path):
    from bammmotif2_tpu.models import seeds as jseeds

    for pat in ("A", "R", "B", "N", "TGASTCA"):
        np.testing.assert_array_equal(seeds.iupac_to_pwm(pat), jseeds.iupac_to_pwm(pat))
    with pytest.raises(ValueError):
        seeds.iupac_to_pwm("TGAZ")
    ours = seeds.read_meme(EXAMPLES_MEME)
    theirs = jseeds.read_meme(EXAMPLES_MEME)
    assert [dataclasses.astuple(s)[0::2] for s in ours] == [dataclasses.astuple(s)[0::2] for s in theirs]
    np.testing.assert_array_equal(ours[0].pwm, theirs[0].pwm)
    with pytest.raises(ValueError):
        motifset.load_motifs(PParams(pattern="TGA", alphabetType="METHYLC"), np.full(5, 0.2),
                             palphabet.Alphabet.from_type("METHYLC"))
    with pytest.raises(ValueError):
        motifset.load_motifs(PParams(), np.full(4, 0.25))


def test_convert_casts_to_float32():
    jm = jmotif.Motif(3, 1, [np.full((4, 3), 0.25), np.full((16, 3), 0.25)],
                      jmotif.Motif.default_alphas(1, 3), np.full(4, 0.25), name="x")
    v, alphas, f_bg = convert.motif_state(jm, "cpu")
    assert all(t.dtype == torch.float32 for t in (*v, alphas, f_bg))
    m = convert.motif(jm)
    assert isinstance(m, motif.Motif) and m.name == "x" and m.v[1].shape == (16, 3)
    assert isinstance(m.alphabet, palphabet.Alphabet) and m.alphabet.name == jm.alphabet.name
    data = convert.em_data(np.zeros((2, 3, 5), np.int64), np.array([5, 4, 0]), np.ones(20), "cpu")
    assert data["cidx"].dtype == torch.int32 and data["bg_flat"].dtype == torch.float32
