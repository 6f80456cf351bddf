"""The collapsed Gibbs sweep's counter-based draws: the binding of
``csrc/cgs_draws.cu`` and the kernels' plain versions.

Not a Pallas kernel: the port's counterpart of the reference's
``jax.random`` draws in ``bammmotif2_tpu/refinement/gibbs.py``
(``fold_in(sub, n)`` for z, ``jax.random.beta`` for q).  Each draw is
Philox4x32-10 of (counter, key): the key is a chain's
``gibbs.chain_seed`` as two 32-bit words (``keys`` [M, 2] int64), the
counter holds the draw's indices and the sweep index ``sweep`` ([1] int64),
which the kernels read on the device, so a captured sweep that a CUDA graph
repeats draws anew each time (``refinement/graphs.py``).  The streams:

  * ``uniforms``: u [M, n] for the z draws of rows row0 .. row0+n-1, row r
    from counter (r, i, 0, 0): u = (x0 >> 8) 2^-24, exact in float32;
  * ``beta``: q [M] = clip(X / (X + Y), lo, hi) with X ~ Gamma(a), Y ~
    Gamma(b) by Marsaglia and Tsang, candidate j of X (Y) from counter
    (j, i, 1 (2), 0), the first accepted of ``BETA_CAP``; a, b >= 1.

csrc/cgs_draws.cu states the arithmetic.  On CPU tensors a wrapper runs the
plain version (``uniforms_ref``, ``beta_ref``: the same Philox in int64
arithmetic, the same candidate order); on CUDA tensors it launches the
kernel or raises.  The plain versions serve the CPU path and the tests.

Nothing here runs at import time: the library builds at first use.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bammmotif2_tpu_torch.ops import _build
from bammmotif2_tpu_torch.ops.cuda_counts import current_stream

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
BETA_CAP = 64  # gamma candidates a draw (csrc/cgs_draws.cu: kBetaCap)
TAG_X, TAG_Y = 1, 2  # the counters' third word of the gamma draws (z: 0)


@functools.cache
def library() -> ctypes.CDLL:
    lib = _build.load("cgs_draws")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cgs_uniforms_launch.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, p]
    lib.cgs_beta_launch.argtypes = [p] * 6 + [ctypes.c_float, ctypes.c_float, i, i, p]
    lib.cgs_uniforms_launch.restype = lib.cgs_beta_launch.restype = i
    lib.cgs_draws_error_string.argtypes = [i]
    lib.cgs_draws_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.cgs_draws_error_string(err).decode()}")


# ---- the plain versions ----

def _mulhilo(a: int, b: torch.Tensor) -> tuple:
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the words ``b`` (int64 holding values below 2^32), in halves of 16 bits
    so no int64 product overflows."""
    bl, bh = b & 0xFFFF, b >> 16
    pl, ph = a * bl, a * bh  # each below 2^48
    t = pl + ((ph & 0xFFFF) << 16)
    return (ph >> 16) + (t >> 32), t & MASK32


def philox4x32_10(ctr: tuple, key: tuple) -> tuple:
    """Philox4x32-10 (``csrc/philox.cuh``) in int64 arithmetic: ``ctr`` four
    and ``key`` two int64 tensors (or ints) of 32-bit words, broadcast
    together; returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms_ref(keys: torch.Tensor, sweep: torch.Tensor, row0: int, n: int) -> torch.Tensor:
    """The plain version of ``uniforms``, on the tensors' device."""
    rows = torch.arange(row0, row0 + n, dtype=torch.int64, device=keys.device)
    x0, *_ = philox4x32_10((rows[None], sweep & MASK32, 0, 0),
                           (keys[:, 0:1], keys[:, 1:2]))
    return (x0 >> 8).to(torch.float32) * 2.0 ** -24


def gamma_ref(keys: torch.Tensor, sweep: torch.Tensor, shape: torch.Tensor, tag: int) -> tuple:
    """Gamma(shape[m]) per chain by Marsaglia and Tsang from candidates
    0 .. BETA_CAP-1 of counter (j, sweep, tag, 0): (draws float64 [M], the
    accepted candidate's index int64 [M], BETA_CAP where none was and the
    draw is d)."""
    j = torch.arange(BETA_CAP, dtype=torch.int64, device=keys.device)
    x0, x1, x2, _x3 = philox4x32_10((j[None], sweep & MASK32, tag, 0),
                                    (keys[:, 0:1], keys[:, 1:2]))
    u1 = (x0.to(torch.float64) + 1.0) * 2.0 ** -32
    u2 = x1.to(torch.float64) * 2.0 ** -32
    ua = x2.to(torch.float64) * 2.0 ** -32
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    d = shape.to(torch.float64)[:, None] - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    t = 1.0 + c * z
    v = t * t * t
    z2 = z * z
    accept = (v > 0) & ((ua < 1.0 - 0.0331 * (z2 * z2))
                        | (torch.log(ua) < 0.5 * z2 + d * (1.0 - v + torch.log(v))))
    found = accept.any(dim=1)
    first = torch.where(found, accept.to(torch.int8).argmax(dim=1), BETA_CAP)
    value = (d * v).gather(1, first.clamp(max=BETA_CAP - 1)[:, None])[:, 0]
    return torch.where(found, value, d[:, 0]), first


def beta_ref(keys: torch.Tensor, sweep: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             lo: float, hi: float, candidates: bool = False):
    """The plain version of ``beta``, on the tensors' device.  Raises on a
    shape below 1 (Marsaglia and Tsang's method needs a boost there, which
    the sampler's shapes, counts plus one, never need)."""
    if not bool(((a >= 1) & (b >= 1)).all()):
        raise ValueError(f"Beta shapes must be >= 1, got a={a.tolist()}, b={b.tolist()}")
    x, ix = gamma_ref(keys, sweep, a, TAG_X)
    y, iy = gamma_ref(keys, sweep, b, TAG_Y)
    q = (x / (x + y)).to(torch.float32).clamp(lo, hi)
    return (q, torch.stack([ix, iy], dim=1).to(torch.int32)) if candidates else q


# ---- the kernels ----

def _check(keys, sweep, *rest) -> None:
    dev = keys.device
    for name, t, dtype in (("keys", keys, torch.int64), ("sweep", sweep, torch.int64), *rest):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}; all inputs must share one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.shape[0] < 1:
        raise ValueError(f"want keys [M, 2] with M >= 1, got {tuple(keys.shape)}")
    if tuple(sweep.shape) != (1,):
        raise ValueError(f"want sweep [1], got {tuple(sweep.shape)}")


def uniforms(keys: torch.Tensor, sweep: torch.Tensor, row0: int, n: int) -> torch.Tensor:
    """The z draws' uniforms u f32 [M, n] in [0, 1) of rows row0 ..
    row0+n-1 at sweep ``sweep`` ([1] int64) for the chains of ``keys``
    ([M, 2] int64), in one launch.  ``uniforms.launches`` counts them."""
    if keys.device.type == "cpu" and sweep.device.type == "cpu":
        return uniforms_ref(keys, sweep, row0, n)
    _check(keys, sweep)
    if keys.shape[0] > 65535:
        raise ValueError(f"at most 65535 chains a launch, got {keys.shape[0]}")
    if not (0 <= row0 and row0 + n <= 2 ** 32 and 1 <= n < 2 ** 31):
        raise ValueError(f"rows {row0} .. {row0 + n - 1} outside the 32-bit counter")
    dev = keys.device
    u = torch.empty((keys.shape[0], n), dtype=torch.float32, device=dev)
    lib = library()
    _raise(lib, "cgs_uniforms", lib.cgs_uniforms_launch(
        keys.data_ptr(), sweep.data_ptr(), u.data_ptr(), row0, n, keys.shape[0], dev.index,
        current_stream(dev)))
    uniforms.launches += 1
    return u


uniforms.launches = 0


def beta(keys: torch.Tensor, sweep: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         lo: float, hi: float, candidates: bool = False):
    """q f32 [M] = clip(X / (X + Y), lo, hi), X ~ Gamma(a[m]), Y ~
    Gamma(b[m]) (a, b f32 [M], each >= 1), drawn at sweep ``sweep`` for the
    chains of ``keys``, in one launch; with ``candidates`` also the accepted
    candidates' indices int32 [M, 2].  ``beta.launches`` counts launches."""
    if all(t.device.type == "cpu" for t in (keys, sweep, a, b)):
        return beta_ref(keys, sweep, a, b, lo, hi, candidates)
    _check(keys, sweep, ("a", a, torch.float32), ("b", b, torch.float32))
    M = keys.shape[0]
    if tuple(a.shape) != (M,) or tuple(b.shape) != (M,):
        raise ValueError(f"want a, b [{M}], got {tuple(a.shape)}, {tuple(b.shape)}")
    dev = keys.device
    q = torch.empty((M,), dtype=torch.float32, device=dev)
    cand = torch.empty((M, 2), dtype=torch.int32, device=dev) if candidates else None
    lib = library()
    _raise(lib, "cgs_beta", lib.cgs_beta_launch(
        keys.data_ptr(), sweep.data_ptr(), a.data_ptr(), b.data_ptr(), q.data_ptr(),
        None if cand is None else cand.data_ptr(), lo, hi, M, dev.index, current_stream(dev)))
    beta.launches += 1
    return (q, cand) if candidates else q


beta.launches = 0


def philox_pairs(ctrs: torch.Tensor, keys: torch.Tensor) -> tuple:
    """A known-answer check, not a kernel of the port's paths
    (``csrc/philox_check.cu``): ``philox.cuh``'s Philox4x32-10 and cuRAND's
    ``curand_Philox4x32_10`` on the card, on the pairs of ctrs [n, 4] and
    keys [n, 2] (int64 CUDA tensors of 32-bit words).  Returns (mine,
    cuRAND's), each int64 [n, 4]."""
    lib = _build.load("philox_check")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.philox_check_launch.argtypes = [p] * 4 + [i, i, p]
    lib.philox_check_error_string.argtypes = [i]
    lib.philox_check_error_string.restype = ctypes.c_char_p
    ctrs, keys = ctrs.contiguous(), keys.contiguous()
    mine, theirs = torch.empty_like(ctrs), torch.empty_like(ctrs)
    dev = ctrs.device
    err = lib.philox_check_launch(ctrs.data_ptr(), keys.data_ptr(), mine.data_ptr(),
                                  theirs.data_ptr(), ctrs.shape[0], dev.index, current_stream(dev))
    if err != 0:
        raise RuntimeError(f"philox_check launch failed: "
                           f"{lib.philox_check_error_string(err).decode()}")
    return mine, theirs
