"""The sampled paths' draws from the reference's ``jax.random`` streams: the
binding of ``csrc/jax_draws.cu`` and the kernels' plain versions.

Not Pallas kernels: the port's counterparts of the reference's
``jax.random`` code (``bammmotif2_tpu/generator/seqgen.py::
_sample_markov_batch``; ``refinement/gibbs.py::gibbs_step_multi``'s
``categorical`` of z and ``beta`` of q).  Each draws what the reference
draws from the same key (``ops/threefry.py`` states the streams):

  * ``markov_codes``: the sampled negatives' codes int8 [N, L] from one key
    [2]: position t of row n is the first argmax over a of log trans[ctx,
    a] + gumbel(split(key, L)[t], n A + a), PAD past the row's length;
  * ``cgs_z``: z [M, N] of M chains from their carried keys [M, 2]: row n
    of chain m the first argmax over c of flat[m, n, c] + gumbel(fold_in(
    split(key)[1], row0 + n), c);
  * ``cgs_beta``: q [M] = clip(beta(sub_q, a, b), lo, hi) with (key', sub_q)
    = split(split(key)[0]), and every chain's key advanced in place to key'
    (the reference's two splits a sweep, made whether or not it samples).

On CPU tensors a wrapper runs the plain version (``*_ref``: torch, the same
arithmetic as the kernel); on CUDA tensors it launches the kernel or
raises.  On the card the kernels and the plain versions agree bit for bit
(``chip_smoke.py``); on the CPU the plain versions agree with ``jax.random``
bit for bit but for beta's final ``exp`` (``tests/test_torch_threefry.py``).

Nothing here runs at import time: the library builds at first use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bammmotif2_tpu_torch.ops import _build, threefry
from bammmotif2_tpu_torch.ops.cuda_counts import current_stream
from bammmotif2_tpu_torch.utils.fasta import PAD

MAX_S_ORDER = 7  # csrc/jax_draws.cu: a row's table offsets

# The work the draws need, for their bounds (chip_smoke.py).  Threefry-2x32's
# 32-bit integer operations a hash (csrc/threefry.cuh): 2 key adds, 20
# rounds of add, rotate and xor, 5 key injections of 2 adds, and the xor
# that makes a draw's 32 bits of the two words.  Of them the rotates and
# xors run only on an SM's ALU pipe (a rotate is at least one shift there,
# SHF; a xor a LOP3); the adds may run on the FMA pipe too (IMAD.IADD).
THREEFRY_INT_OPS = 2 + 20 * 3 + 5 * 2 + 1
THREEFRY_ALU_OPS = 20 * 2 + 1
# f32 operations a gumbel-shifted logit costs: two of XLA's logs (9 fused
# multiply-adds, 2 operations each, and 11 other operations), the uniform's
# 3, the logit's add.
GUMBEL_F32_OPS = 2 * (9 * 2 + 11) + 3 + 1
# Threefry hashes of a chain's q: the sweep's split k1 and the two of (k2,
# sub_q), beta's (ka, kb); then per gamma 2 splits before its first attempt
# (loggamma's and _gamma_one's) and 7 an attempt (its key, x and U keys,
# the normal's key and subkey, the normal's and U's bits) whose normal is
# accepted at once.
BETA_CHAIN_HASHES, GAMMA_HASHES, ATTEMPT_HASHES = 5, 2, 7


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of csrc/jax_draws.cu) with its functions' argument
    and result types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.markov_codes_launch.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.cgs_z_launch.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, i, p]
    lib.cgs_beta_launch.argtypes = [p] * 5 + [i, ctypes.c_float, ctypes.c_float, i, i, p]
    lib.markov_codes_launch.restype = lib.cgs_z_launch.restype = lib.cgs_beta_launch.restype = i
    lib.cgs_beta_spec_lanes.argtypes = []
    lib.cgs_beta_spec_lanes.restype = i
    lib.jax_draws_error_string.argtypes = [i]
    lib.jax_draws_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    return bind(_build.load("jax_draws"))


def beta_spec_lanes() -> int:
    """cgs_beta's lanes a gamma: the attempts its kernel runs at once."""
    return library().cgs_beta_spec_lanes()


def _raise(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.jax_draws_error_string(err).decode()}")


def _check(*named) -> None:
    """Raises unless each (name, tensor, dtype) of ``named`` is of its dtype
    and contiguous."""
    for name, t, dtype in named:
        if t.dtype is not dtype:
            raise TypeError(f"{name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _device(*tensors) -> int:
    """The index of the one CUDA device that all ``tensors`` lie on, else
    raises.  Reads the tensors' attributes only: no device objects."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"inputs on {[str(t.device) for t in tensors]}; all must share one "
                             "CUDA device")
    return index


# ---- the plain versions ----

def markov_codes_ref(key: torch.Tensor, trans: tuple, lens: torch.Tensor, *, L: int,
                     s_order: int, A: int) -> torch.Tensor:
    """The plain version of ``markov_codes`` (the reference's
    ``_sample_markov_batch``), on the device of ``lens``."""
    N, dev = lens.shape[0], lens.device
    logits = tuple(threefry.xla_log(t.reshape(-1, A).to(torch.float32)) for t in trans)
    keys = threefry.split(key.to(dev), L)
    codes = torch.empty((N, L), dtype=torch.int8, device=dev)
    ctx = torch.zeros(N, dtype=torch.int64, device=dev)
    for t in range(L):
        order = min(t, s_order)
        g = threefry.gumbel_of(threefry.random_bits(keys[t], (N, A)))
        c = torch.argmax(g + logits[order][ctx], dim=1)
        codes[:, t] = c.to(torch.int8)
        if order < s_order:
            ctx = ctx * A + c
        elif s_order > 0:
            ctx = (ctx % (A ** (s_order - 1))) * A + c
    t_idx = torch.arange(L, device=dev)[None, :]
    return codes.masked_fill_(t_idx >= lens[:, None], PAD)


def cgs_z_ref(flat: torch.Tensor, keys: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """The plain version of ``cgs_z``, on the tensors' device."""
    M, N, C = flat.shape
    sub = threefry.split(keys)[:, 1]  # [M, 2]
    rows = torch.arange(row0, row0 + N, dtype=torch.int64, device=flat.device)
    row_keys = threefry.fold_in(sub[:, None, :], rows[None, :])  # [M, N, 2]
    w0, w1 = threefry.threefry2x32(row_keys[:, :, None, :], 0,
                                   torch.arange(C, dtype=torch.int64, device=flat.device))
    return torch.argmax(threefry.gumbel_of(w0 ^ w1) + flat, dim=-1)


def cgs_beta_ref(a: torch.Tensor, b: torch.Tensor, keys: torch.Tensor, lo: float, hi: float,
                 draw: bool = True, attempts: bool = False):
    """The plain version of ``cgs_beta``, on the tensors' device: updates
    ``keys`` in place and returns q (None where ``draw`` is False), with
    ``attempts`` also the gammas' attempts int32 [M, 2].  Raises on a shape
    below 1."""
    k1 = threefry.split(keys)[:, 0]
    k2, sub_q = threefry.split(k1).unbind(dim=1)
    out = None
    if draw:
        if not bool(((a >= 1) & (b >= 1)).all()):
            raise ValueError(f"Beta shapes must be >= 1, got a={a.tolist()}, b={b.tolist()}")
        q, n = threefry.beta(sub_q, a, b, attempts=True)
        q = q.clamp(float(torch.tensor(lo, dtype=torch.float32)),
                    float(torch.tensor(hi, dtype=torch.float32)))
        out = (q, n.to(torch.int32)) if attempts else q
    keys.copy_(k2)
    return out


# ---- the kernels ----

def markov_codes(key: torch.Tensor, trans: tuple, lens: torch.Tensor, *, L: int, s_order: int,
                 A: int) -> torch.Tensor:
    """The sampled codes int8 [N, L] of rows of lengths ``lens`` (int32
    [N]) from ``key`` ([2] int64) and the conditionals ``trans`` (order m's
    [A^(m+1)] float32, m = 0 .. s_order), in one launch.  No host sync, so a
    CUDA graph can capture it.  ``markov_codes.launches`` counts
    launches."""
    if key.is_cpu and lens.is_cpu:
        return markov_codes_ref(key, trans, lens, L=L, s_order=s_order, A=A)
    if len(trans) != s_order + 1 or not 0 <= s_order <= MAX_S_ORDER:
        raise ValueError(f"want s_order in [0, {MAX_S_ORDER}] and its {s_order + 1} tables, "
                         f"got {len(trans)}")
    table = torch.cat([t.reshape(-1) for t in trans])
    _check(("lens", lens, torch.int32), ("key", key, torch.int64), ("trans", table, torch.float32))
    if tuple(key.shape) != (2,) or lens.dim() != 1:
        raise ValueError(f"want key [2] and lens [N], got {tuple(key.shape)}, "
                         f"{tuple(lens.shape)}")
    index = _device(lens, key, table)
    if table.numel() != sum(A ** (m + 1) for m in range(s_order + 1)):
        raise ValueError(f"trans holds {table.numel()} probabilities, not "
                         f"A^1 + .. + A^{s_order + 1}")
    N = lens.shape[0]
    codes = lens.new_empty((N, L), dtype=torch.int8)
    lib = library()
    _raise(lib, "markov_codes", lib.markov_codes_launch(
        key.data_ptr(), table.data_ptr(), lens.data_ptr(), codes.data_ptr(), N, L, s_order, A,
        table.numel(), index, current_stream(index)))
    markov_codes.launches += 1
    return codes


markov_codes.launches = 0


def cgs_z(flat: torch.Tensor, keys: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """z int64 [M, N]: each row's categorical draw from its logits ``flat``
    (float32 [M, N, C]) under the chains' carried ``keys`` ([M, 2] int64,
    read only), rows numbered from ``row0``; one launch.
    ``cgs_z.launches`` counts launches."""
    if flat.is_cpu and keys.is_cpu:
        return cgs_z_ref(flat, keys, row0)
    _check(("flat", flat, torch.float32), ("keys", keys, torch.int64))
    if flat.dim() != 3:
        raise ValueError(f"want flat [M, N, C], got {tuple(flat.shape)}")
    M, N, C = flat.shape
    if keys.shape != (M, 2) or M < 1 or C < 1:
        raise ValueError(f"want keys [{M}, 2], M >= 1 and C >= 1, got {tuple(keys.shape)}, C={C}")
    if not (0 <= row0 and row0 + N <= 2 ** 32):
        raise ValueError(f"rows {row0} .. {row0 + N - 1} outside fold_in's 32-bit data")
    index = _device(flat, keys)
    z = keys.new_empty((M, N))
    lib = library()
    _raise(lib, "cgs_z", lib.cgs_z_launch(flat.data_ptr(), keys.data_ptr(), z.data_ptr(), row0, N,
                                          C, M, index, current_stream(index)))
    cgs_z.launches += 1
    return z


cgs_z.launches = 0


def cgs_beta(a: torch.Tensor, b: torch.Tensor, keys: torch.Tensor, lo: float, hi: float,
             draw: bool = True, attempts: bool = False):
    """q float32 [M] = clip(beta(sub_q, a[m], b[m]), lo, hi) (a, b float32
    [M], each >= 1) for the chains' ``keys`` ([M, 2] int64), which advance
    in place by the sweep's two splits; one launch.  ``draw`` False only
    advances the keys and returns None.  With ``attempts`` also the
    gammas' Marsaglia-Tsang attempts int32 [M, 2].  ``cgs_beta.launches``
    counts launches."""
    if a.is_cpu and b.is_cpu and keys.is_cpu:
        return cgs_beta_ref(a, b, keys, lo, hi, draw, attempts)
    _check(("keys", keys, torch.int64), ("a", a, torch.float32), ("b", b, torch.float32))
    M = keys.shape[0] if keys.dim() == 2 else 0
    if M < 1 or keys.shape[1] != 2 or a.shape != (M,) or b.shape != (M,):
        raise ValueError(f"want keys [M, 2] with M >= 1 and a, b [M], got {tuple(keys.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    index = _device(keys, a, b)
    q = torch.empty_like(a) if draw else None
    n = torch.empty_like(keys, dtype=torch.int32) if attempts and draw else None
    lib = library()
    _raise(lib, "cgs_beta", lib.cgs_beta_launch(
        a.data_ptr(), b.data_ptr(), keys.data_ptr(), None if q is None else q.data_ptr(),
        None if n is None else n.data_ptr(), draw, lo, hi, M, index, current_stream(index)))
    cgs_beta.launches += 1
    if not draw:
        return None
    return (q, n) if attempts else q


cgs_beta.launches = 0
