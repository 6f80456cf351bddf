"""The draw kernels' wrappers and bounds on the CPU: ``ops/cuda_draws.py``'s
``cgs_z`` and ``cgs_beta`` raise on inputs their kernels do not take (meta
tensors stand in for the card's), the work constants equal their
derivations, ``chip_smoke.bound`` names the term that bounds each draw
kernel at its path's shapes, and ``tools/sass_mix.py`` counts a kernel's
opcodes.  Imports no JAX."""

from __future__ import annotations

import importlib.util
import os

import pytest
import torch

from bammmotif2_tpu_torch.ops import cuda_draws, threefry
from bammmotif2_tpu_torch.tools import sass_mix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = (1e-4, 1 - 1e-4)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("bamm_chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


KEYS = ((3, 2), torch.int64)

Z_BAD = {  # name -> (flat, keys, error)
    "meta": (_meta((3, 5, 7)), _meta(*KEYS), ValueError),
    "cpu_beside_meta": (torch.zeros(3, 5, 7), _meta(*KEYS), ValueError),
    "flat_f64": (_meta((3, 5, 7), torch.float64), _meta(*KEYS), TypeError),
    "keys_int32": (_meta((3, 5, 7)), _meta((3, 2), torch.int32), TypeError),
    "flat_2d": (_meta((5, 7)), _meta(*KEYS), ValueError),
    "keys_of_other_m": (_meta((3, 5, 7)), _meta((2, 2), torch.int64), ValueError),
    "no_logits": (_meta((3, 5, 0)), _meta(*KEYS), ValueError),
    "flat_strided": (_meta((3, 7, 5)).transpose(1, 2), _meta(*KEYS), ValueError),
    "keys_strided": (_meta((3, 5, 7)), _meta((2, 3), torch.int64).t(), ValueError),
}


@pytest.mark.parametrize("case", list(Z_BAD))
def test_z_wrapper_rejects(case):
    flat, keys, error = Z_BAD[case]
    before = cuda_draws.cgs_z.launches
    with pytest.raises(error):
        cuda_draws.cgs_z(flat, keys)
    assert cuda_draws.cgs_z.launches == before


def test_z_wrapper_rejects_rows_past_32_bits():
    with pytest.raises(ValueError, match="32-bit"):
        cuda_draws.cgs_z(_meta((3, 5, 7)), _meta(*KEYS), 2 ** 32 - 4)


BETA_BAD = {  # name -> (a, b, keys, error)
    "meta": (_meta((3,)), _meta((3,)), _meta(*KEYS), ValueError),
    "cpu_beside_meta": (torch.ones(3), torch.ones(3), _meta(*KEYS), ValueError),
    "a_f64": (_meta((3,), torch.float64), _meta((3,)), _meta(*KEYS), TypeError),
    "keys_f32": (_meta((3,)), _meta((3,)), _meta((3, 2)), TypeError),
    "b_short": (_meta((3,)), _meta((2,)), _meta(*KEYS), ValueError),
    "keys_1d": (_meta((3,)), _meta((3,)), _meta((6,), torch.int64), ValueError),
    "keys_3_words": (_meta((3,)), _meta((3,)), _meta((3, 3), torch.int64), ValueError),
    "no_chains": (_meta((0,)), _meta((0,)), _meta((0, 2), torch.int64), ValueError),
    "a_strided": (_meta((6,))[::2], _meta((3,)), _meta(*KEYS), ValueError),
    "keys_strided": (_meta((3,)), _meta((3,)), _meta((2, 3), torch.int64).t(), ValueError),
}


@pytest.mark.parametrize("draw", [True, False], ids=["draw", "advance"])
@pytest.mark.parametrize("case", list(BETA_BAD))
def test_beta_wrapper_rejects(case, draw):
    a, b, keys, error = BETA_BAD[case]
    before = cuda_draws.cgs_beta.launches
    with pytest.raises(error):
        cuda_draws.cgs_beta(a, b, keys, *Q, draw=draw)
    assert cuda_draws.cgs_beta.launches == before


def test_threefry_int_ops_is_its_derivation():
    """2 key adds, add, rotate and xor in each of 5 x 4 rounds (the
    rotations' table), 2 adds in each of 5 key injections, the bits' xor."""
    rounds = 5 * len(threefry.ROTATIONS[0])
    assert rounds == 20
    assert cuda_draws.THREEFRY_INT_OPS == 2 + 3 * rounds + 2 * 5 + 1 == 73


def test_gumbel_f32_ops_is_its_derivation(monkeypatch):
    """Two logs of 9 fused multiply-adds (counted here through the plain
    version's fma32) and 11 other operations each, the uniform's 3 and the
    logit's add."""
    calls = []
    fma = threefry.fma32

    def counted(*args):
        calls.append(1)
        return fma(*args)

    monkeypatch.setattr(threefry, "fma32", counted)
    threefry.gumbel_of(torch.tensor([12345, 2 ** 31], dtype=torch.int64))
    assert len(calls) == 2 * 9
    assert cuda_draws.GUMBEL_F32_OPS == 2 * (9 * 2 + 11) + 3 + 1 == 62


def test_threefry_alu_ops_is_its_derivation():
    """The ALU pipe's share of a hash: a rotate and a xor in each of the 20
    rounds, and the bits' xor; the adds are the rest."""
    rounds = 5 * len(threefry.ROTATIONS[0])
    assert cuda_draws.THREEFRY_ALU_OPS == 2 * rounds + 1 == 41
    adds = cuda_draws.THREEFRY_INT_OPS - cuda_draws.THREEFRY_ALU_OPS
    assert adds == 2 + rounds + 2 * 5 == 32


CLOCK_MHZ = 1980.0  # the H100 SXM's highest SM clock
PIPE_PER_S = 132 * 64 * CLOCK_MHZ * 1e6  # one integer pipe's results a second


@pytest.mark.parametrize("M", [1, 10, 16])
def test_z_bound_is_its_integer_work_at_bench_shape(M):
    """At bench's 10k rows of 379 logits the Threefry hashes bound cgs_z: a
    hash an element and a row and one a chain, of whose operations the
    ALU pipe's (THREEFRY_ALU_OPS a hash) outweigh half of all; over 132
    SMs x 64 results a clock x the SM clock; bytes and f32 operations take
    less."""
    cs = _chip_smoke()
    N, C = 10_000, 379
    b = cs.z_bound(M, N, C, clock_mhz=CLOCK_MHZ)
    assert b["bound_term"] == "int32" and b["bound_by"] == "operations"
    hashes = M * N * (C + 1) + M
    assert b["int_ops"] == hashes * 73 and b["alu_ops"] == hashes * 41
    assert b["bound_ms"] == pytest.approx(b["alu_ops"] / PIPE_PER_S * 1e3, rel=1e-12)
    assert b["bytes"] / cs.HBM_BYTES_PER_S * 1e3 < b["bound_ms"]
    assert b["ops"] / cs.F32_OPS_PER_S * 1e3 < b["bound_ms"]


@pytest.mark.parametrize("int_ops, alu_ops, clocks", [
    (10 ** 12, 10 ** 11, 5 * 10 ** 11),  # adds fill both pipes
    (10 ** 12, 8 * 10 ** 11, 8 * 10 ** 11),  # the ALU pipe's own work binds
    (10 ** 12, 5 * 10 ** 11, 5 * 10 ** 11),  # the two balance
])
def test_bound_integer_term_is_the_busier_pipe(int_ops, alu_ops, clocks):
    """Integer work takes max(ALU-only operations, all of them / 2) results
    of one pipe: the ALU pipe's shifts and bitwise operations run there
    alone, the adds on it or on the FMA pipe."""
    cs = _chip_smoke()
    b = cs.bound(1, 0, int_ops, alu_ops, clock_mhz=CLOCK_MHZ)
    assert b["bound_term"] == "int32"
    assert b["bound_ms"] == pytest.approx(clocks / PIPE_PER_S * 1e3, rel=1e-12)


def test_bound_takes_the_largest_term():
    cs = _chip_smoke()
    assert cs.bound(10 ** 9, 1, 1, clock_mhz=CLOCK_MHZ)["bound_term"] == "bytes"
    assert cs.bound(1, 10 ** 12, 1, clock_mhz=CLOCK_MHZ)["bound_term"] == "f32"
    only = cs.bound(1000, 10)
    assert only["bound_term"] == "bytes" and only["int_ops"] == 0


def test_beta_bound_counts_the_attempts_taken():
    """A chain's 5 hashes and each gamma's 2, then 7 an attempt: the
    attempts this call's gammas took; without a draw the sweep's 3 splits."""
    cs = _chip_smoke()
    att = torch.tensor([[1, 1], [3, 1]], dtype=torch.int32)
    b = cs.beta_bound(att, clock_mhz=CLOCK_MHZ)
    hashes = 2 * (5 + 2 * 2) + 6 * 7
    assert b["int_ops"] == hashes * 73 and b["alu_ops"] == hashes * 41
    assert b["bound_term"] == "int32"
    assert cs.beta_bound(att, draw=False, clock_mhz=CLOCK_MHZ)["int_ops"] == 2 * 3 * 73


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_112cgs_z_kernelEPKfPKxPxxiix
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 IMAD.SHL.U32 R5, R4, 0x2000, RZ ;
        /*0020*/                   LOP3.LUT R5, R5, R6, R7, 0x96, !PT ;
        /*0030*/                   SHF.R.U32.HI R6, RZ, 0x13, R4 ;
        /*0040*/                   LOP3.LUT R5, R5, R6, R7, 0x96, !PT ;
\t\tFunction : _ZN12_GLOBAL__N_115cgs_beta_kernelEv
        /*0000*/                   EXIT ;
"""


@pytest.mark.parametrize("kernels, want", [
    (["cgs_z_kernel"], {"cgs_z_kernel": 5}),
    (None, {"cgs_z_kernel": 5, "cgs_beta_kernel": 1}),
], ids=["one", "all"])
def test_sass_mix_counts_each_kernels_opcodes(kernels, want):
    """Instructions a kernel, each opcode bare and with its modifiers; a
    predicate does not count as the opcode."""
    got = sass_mix.mix(SASS, kernels)
    short = {n: k for n in got for k in ("cgs_z_kernel", "cgs_beta_kernel") if k in n}
    assert {short[n]: v["instructions"] for n, v in got.items()} == want
    z = next(v["opcodes"] for n, v in got.items() if "cgs_z" in n)
    assert z["LOP3"] == z["LOP3.LUT"] == 2
    assert z["IMAD"] == z["IMAD.SHL.U32"] == 1 and z["SHF"] == 1 and z["LDC"] == 1
