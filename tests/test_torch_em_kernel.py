"""Port parity: the plain version of the fused E+M pass
(``ops.cuda_em.em_counts_multi_ref``, which CPU tensors take) against the
JAX package's Pallas kernel in interpret mode and its gather path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bammmotif2_tpu.models import background as jbackground
from bammmotif2_tpu.models import motif as jmotif
from bammmotif2_tpu.models import seeds as jseeds
from bammmotif2_tpu.ops import escore as jescore
from bammmotif2_tpu.ops import pallas_em
from bammmotif2_tpu.refinement import em as jem
from bammmotif2_tpu.utils.alphabet import Alphabet
from bammmotif2_tpu.utils.fasta import SequenceSet
from bammmotif2_tpu_torch import convert
from bammmotif2_tpu_torch.ops import cuda_em, encode

torch.set_num_threads(1)


def em_problem(K, W, M, A=4, ss=False, ragged=False, n=24, length=30, seed=0):
    """Planted-motif sequences (numpy seed) through the JAX prepare_data,
    with M log-odds LUTs (seed 0's from the planted PWM, the others
    perturbed, zero sentinel kept).  Returns (luts, qs, jax data)."""
    rng = np.random.default_rng(seed)
    alphabet = Alphabet.from_type("STANDARD" if A == 4 else "METHYLC")
    letters = np.array(list(alphabet.letters))
    planted = rng.integers(0, A, W)
    seqs = []
    for i in range(n):
        lo = 0 if ragged else W + 2
        s = letters[rng.integers(0, A, int(rng.integers(lo, length + 1)))]
        if len(s) >= W and rng.random() < 0.7:
            p = int(rng.integers(0, len(s) - W + 1))
            s[p : p + W] = letters[planted]
        if i % 4 == 0 and len(s) > 3:
            s[2] = "N"
        seqs.append("".join(s))
    if ragged:
        seqs[:3] = ["", "".join(letters[planted[: W - 1]]), "".join(letters[planted])]
    sset = SequenceSet.from_sequences(seqs, alphabet=alphabet)
    bg = jbackground.BackgroundModel.from_sequence_set(sset, order=min(2, K), ss=ss)
    pwm = np.full((W, A), 0.3 / (A - 1))
    pwm[np.arange(W), planted] = 0.7
    m = jseeds.motif_from_pwm(pwm, K, sset.base_frequencies(), alphabet=alphabet)
    data = jem.prepare_data(sset, bg, K, ss)
    base = np.asarray(jmotif.log_odds_lut(tuple(jnp.asarray(v, jnp.float32) for v in m.v), data["bg_flat"]))
    luts = np.stack([
        base if i == 0 else base * rng.uniform(0.6, 1.4) + rng.normal(0, 0.05, base.shape)
        for i in range(M)
    ]).astype(np.float32)
    luts[:, -1, :] = 0.0
    return luts, rng.uniform(0.3, 0.95, M).astype(np.float32), data


CASES = {
    "K0_short_and_empty_rows": dict(K=0, W=6, M=1, ragged=True),
    "K2_M3": dict(K=2, W=8, M=3),
    "K4_ss": dict(K=4, W=6, M=1, ss=True),
    "K5_M3": dict(K=5, W=6, M=3),  # the one K=5 interpret-mode call
    "A5_M3": dict(K=2, W=6, M=3, A=5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_em_pass_matches_jax(name):
    case = CASES[name]
    luts, qs, jdata = em_problem(**case)
    A, K, W, M = case.get("A", 4), case["K"], case["W"], case["M"]
    R = encode.num_rows(A, K)
    data = convert.em_data(jdata["cidx"], jdata["lens"], jdata["bg_flat"], "cpu")
    launches = cuda_em.em_counts_multi.launches
    C, ll = cuda_em.em_counts_multi(convert.floats(luts, "cpu"), data["cidx"], data["lens"],
                                    convert.floats(qs, "cpu"))
    assert cuda_em.em_counts_multi.launches == launches  # CPU tensors: no kernel
    assert C.shape == (M, R + 1, W) and C.dtype == torch.float32 and ll.shape == (M,)

    # the gather path, one seed at a time: counts atol 1e-5, ll rtol 1e-5
    for m in range(M):
        scores, mask = jescore.window_scores(jnp.asarray(luts[m]), jdata["cidx"], jdata["lens"], W)
        r, _r0, jll = jescore.zoops_posterior(scores, mask, jnp.float32(qs[m]))
        jC = jescore.mstep_counts(r, jdata["cidx"], R, W)
        np.testing.assert_allclose(C[m].numpy(), np.asarray(jC), atol=1e-5)
        np.testing.assert_allclose(float(ll[m]), float(jll), rtol=1e-5)

    # the Pallas kernel (interpret mode), seeds stacked: counts atol 1e-4
    pC, pll = pallas_em.em_counts_multi(
        jnp.asarray(luts), jdata["cidx"], jdata["lens"], jnp.asarray(qs),
        A=A, K=K, W=W, R=R, interpret=True,
    )
    np.testing.assert_allclose(C.numpy(), np.asarray(pC), atol=1e-4)
    # the Pallas kernel's bf16 residual splits leave ~1e-6 per sequence in
    # log Z (it differs from the JAX gather path by as much); these lls sum
    # 24 rows and can sit near 0, where rtol alone says nothing
    np.testing.assert_allclose(ll.numpy(), np.asarray(pll), rtol=1e-5, atol=1e-5)
    # every window deposits its responsibility once at motif position 0
    np.testing.assert_allclose(C[:, :, 0].sum(1).numpy(), C[:, :, -1].sum(1).numpy(), rtol=1e-5)


def test_launch_plan():
    # bench's K=2, W=12, rows of 200 bp on both strands: a warp a sequence;
    # LUT (4 KB a seed) and fixed-point counts (8 KB) in shared memory, one
    # seed a block
    plan = cuda_em.launch_plan(3, encode.num_rows(4, 2) + 1, 12, S=2, L=200)
    assert (plan.seeds_per_block, plan.smem_lut, plan.smem_counts, plan.fixed_counts,
            plan.team) == (1, True, True, True, 32)
    # K=4 (65 KB a seed): fixed-point counts and the LUT fill one block's
    # shared memory
    plan = cuda_em.launch_plan(2, encode.num_rows(4, 4) + 1, 12)
    assert (plan.seeds_per_block, plan.smem_lut, plan.smem_counts, plan.fixed_counts) == (
        1, True, True, True)
    # K=4 at W=30: only float counts fit, the LUT goes through L1
    plan = cuda_em.launch_plan(2, encode.num_rows(4, 4) + 1, 30)
    assert (plan.smem_lut, plan.smem_counts, plan.fixed_counts) == (False, True, False)
    # A=4, K=5 (262 KB a seed) goes to global memory
    plan = cuda_em.launch_plan(2, encode.num_rows(4, 5) + 1, 12)
    assert (plan.seeds_per_block, plan.smem_lut, plan.smem_counts) == (1, False, False)
    # rows of 9,000 bp take a block each, and so do rows of 512 bp
    assert cuda_em.launch_plan(2, encode.num_rows(4, 2) + 1, 12, S=2, L=9_000).team == 256
    assert cuda_em.launch_plan(2, encode.num_rows(4, 2) + 1, 12, S=2, L=512).team == 256


def test_plain_pass_rejects_width_beyond_length():
    cidx = torch.zeros((2, 3, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_em.em_counts_multi(torch.zeros((1, 2, 6)), cidx, torch.tensor([5, 5, 5], dtype=torch.int32),
                                torch.tensor([0.5]))
