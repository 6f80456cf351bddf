"""The reference's random streams: ``jax.random``'s threefry2x32 functions
in torch, the plain versions of ``csrc/jax_draws.cu``.

The reference draws every sampled quantity from ``jax.random`` keys: the
sampled negatives (``generator/seqgen.py``), CGS's z by ``categorical`` and
q by ``beta`` (``refinement/gibbs.py``).  ``jax.random`` is counter-based
Threefry-2x32 (Salmon et al., SC 2011) with a fully specified derivation of
keys and bits, so the port computes the same streams and draws what the
reference draws.  These are the port's copies of the pieces of
``jax/_src/prng.py`` and ``jax/_src/random.py`` (jax 0.9.0, whose
``jax_threefry_partitionable`` is True) that the reference reaches:

  * a key is two 32-bit words, here an int64 tensor [..., 2];
    ``prng_key(seed)`` = (seed >> 32, seed & 0xFFFFFFFF);
  * ``threefry2x32``: 20 rounds, rotations (13, 15, 26, 6) / (17, 29, 16,
    24), key word 3 = k0 ^ k1 ^ 0x1BD11BDA;
  * ``split(key, n)[i]`` = threefry(key, (0, i)); ``fold_in(key, d)`` =
    threefry(key, (0, d));
  * ``random_bits(key, shape)``: word0 ^ word1 of threefry(key, (j >> 32,
    j & 0xFFFFFFFF)) at the element's flat index j;
  * ``uniform``: the bits' top 23 as the mantissa of a float in [1, 2),
    minus 1, scaled, shifted, then max(minval, .);
  * ``gumbel`` (mode "low") = -log(-log(uniform(tiny, 1))); ``categorical``
    = the first argmax of logits + gumbel, the gumbel's counter the flat
    index into the logits' shape;
  * ``normal`` = sqrt(2) erf_inv(uniform(nextafter(-1, 0), 1)) with XLA's
    float32 ``erf_inv`` (``erf_inv``: Giles' single-precision polynomial,
    as XLA lowers ``chlo.erf_inv``);
  * ``loggamma`` (Marsaglia and Tsang in log space, ``_gamma_one`` with its
    key splits an attempt) and ``beta`` = the ratio of two loggammas.

All arithmetic is torch int64 on 32-bit words (add, mask, rotate, xor: no
products) and float32 in the reference's order of operations, so it runs
on any device.  The float functions are XLA's CPU ones, not torch's: log
and log1p (``xla_log``, ``xla_log1p``: Cephes' polynomials with fused
multiply-adds, ``fma32`` rounding each fused step once) and the square
root bit for bit, so every draw equals the reference's on the CPU but
beta's, whose last step is an exp (``exp32``, within an ulp of XLA's).  A
kernel of ``csrc/threefry.cuh`` computes the same operations and agrees
with these plain versions bit for bit on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's float32 erf_inv (Giles, "Approximating the erfinv function", GPU
# Computing Gems, 2011): the coefficients for w < 5 and for w >= 5
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU log (Cephes' logf): the polynomial, ln 2 in two parts, sqrt(1/2)
LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
         1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
         3.3333331174e-1)
LOG_Q1, LOG_Q2 = -2.12194440e-4, 0.693359375
LOG_SQRTHF = float(np.float32(0.707106781186547524))
# XLA's CPU log1p below |x| = sqrt(2) - 1: Cephes' log1p numerator and
# denominator, highest degree first
LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
           6.5787325942061044846969e0, 2.9911919328553073277375e1,
           6.0949667980987787057556e1, 5.7112963590585538103336e1,
           2.0039553499201281259648e1)
LOG1P_Q = (1.0, 1.5062909083469192198e1, 8.3047565967967209469434e1,
           2.2176239823732856465394e2, 3.0909872225312059774938e2,
           2.1642788614495947685003e2, 6.0118660497603843919306e1)
LOG1P_SMALL = float(np.float32(0.41421356237309504880))
THIRD = float(np.float32(1.0 / 3.0))
SQUEEZE = float(np.float32(0.0331))


def _words(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x0, x1) -> tuple:
    """Threefry-2x32 of the counter words (x0, x1) under ``key`` [..., 2]
    (int64 tensors of 32-bit words, broadcast together): the two output
    words as int64 tensors."""
    k0, k1 = key[..., 0], key[..., 1]
    dev = key.device
    x0, x1 = _words(x0, dev), _words(x1, dev)
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key [2] int64 (seed >> 32, seed &
    0xFFFFFFFF); a negative (32-bit) seed keeps its low word."""
    seed = int(seed)
    hi = (seed >> 32) & MASK32 if seed >= 0 else 0
    return torch.tensor([hi, seed & MASK32], dtype=torch.int64, device=device)


def from_jax_key(key) -> torch.Tensor:
    """A JAX key's words (a uint32 array [..., 2], e.g. ``np.asarray(
    jax.random.PRNGKey(s))``) as the port's int64 key tensor [..., 2]."""
    return torch.from_numpy(np.asarray(key, dtype=np.uint32).astype(np.int64))


def _stack(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    return torch.stack([w0, w1], dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: keys [..., n, 2] from keys [..., 2]."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return _stack(*threefry2x32(key[..., None, :], 0, i))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``, with ``data`` an int or an int64
    tensor broadcast against the key's leading shape."""
    return _stack(*threefry2x32(key, 0, _words(data, key.device) & MASK32))


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 values in int64) of one key
    [2]: word0 ^ word1 at each element's flat index."""
    shape = tuple(shape)
    j = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64, device=key.device)
    w0, w1 = threefry2x32(key, j >> 32, j & MASK32)
    return (w0 ^ w1).reshape(shape)


def scalar_bits(keys: torch.Tensor) -> torch.Tensor:
    """``random_bits(key, ())`` of each key of keys [..., 2]: the one draw a
    scalar sampler takes from a key (counter (0, 0))."""
    w0, w1 = threefry2x32(keys, 0, 0)
    return w0 ^ w1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32 random bits: the top 23 as the mantissa of
    a float in [1, 2), minus 1 (``_uniform``'s bit trick)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def scale_unit(f: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``_uniform``'s f * (maxval - minval) + minval, then max(minval, .),
    each operation rounded to float32 on its own."""
    lo, span = np.float32(minval), np.float32(maxval) - np.float32(minval)
    return torch.clamp_min(f * float(span) + float(lo), float(lo))


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return scale_unit(bits_to_unit(random_bits(key, shape)), minval, maxval)


def fma32(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (a, b, c float32 tensors or
    floats): the product is exact in float64, TwoSum gives the sum's
    rounding error, and rounding the float64 sum to odd before float32
    makes the two roundings one.  XLA's CPU code fuses a multiply feeding
    an add into such a fused multiply-add."""
    f64 = torch.float64
    dev = next((t.device for t in (a, b, c) if isinstance(t, torch.Tensor)), None)
    a, b, c = (torch.as_tensor(t, device=dev).to(torch.float32).to(f64) for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact = (err != 0) & torch.isfinite(s)
    away = inexact & ((err < 0) == (s > 0))  # s lies farther from zero than the sum
    bits = torch.where(away, bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(f64).to(torch.float32)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (torch's CPU sqrt is not):
    in float64, then rounded, which rounds once in effect."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def rsqrt32(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x) in float32, rounded from float64's.  XLA's CPU code turns
    the reference's (1/3) / sqrt(d) into (1/3) * rsqrt(d), its rsqrt an
    approximation of its own: this one differs from it by an ulp for about
    a tenth of d (a true division would for four in ten)."""
    return (1.0 / torch.sqrt(x.to(torch.float64))).to(torch.float32)


def exp32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp rounded from float64's (correctly rounded but for double
    rounding's rare ties), the same on every device: torch's CUDA exp and
    its CPU exp differ by ulps, and XLA's CPU exp (beta's last step) is its
    own, within an ulp of this one."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def _horner(coeffs: tuple, x: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma32(p, x, c)
    return p


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log on the CPU, bit for bit: Cephes' logf polynomial
    (as Eigen's plog has it) with fused multiply-adds; inputs below the
    smallest normal count as zero (-inf), negatives give NaN."""
    m, e = torch.frexp(torch.clamp_min(x, TINY))
    low = m < LOG_SQRTHF
    e = e.to(torch.float32) - low.to(torch.float32)
    m = (m - 1.0) + torch.where(low, m, 0.0)
    m2 = m * m
    m3 = m2 * m
    y = fma32(fma32(LOG_P[0], m, LOG_P[1]), m, LOG_P[2])
    y1 = fma32(fma32(LOG_P[3], m, LOG_P[4]), m, LOG_P[5])
    y2 = fma32(fma32(LOG_P[6], m, LOG_P[7]), m, LOG_P[8])
    y = fma32(fma32(y, m3, y1), m3, y2)
    y = fma32(y, m3, e * LOG_Q1)
    r = ((m - m2 * 0.5) + y) + e * LOG_Q2
    r = torch.where(x < TINY, float("-inf"), r)
    r = torch.where(x == float("inf"), float("inf"), r)
    return torch.where((x < 0) | torch.isnan(x), float("nan"), r)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p on the CPU, bit for bit: ``xla_log(1 + x)`` where
    |x| >= sqrt(2) - 1, else x - x^2 / 2 + x^3 P(x) / Q(x) with Cephes'
    rational approximation, its polynomials by fused Horner steps."""
    x2 = x * x
    small = x + fma32(-0.5, x2, (x * x2) * (_horner(LOG1P_P, x) / _horner(LOG1P_Q, x)))
    return torch.where(x.abs() < LOG1P_SMALL, small, xla_log(x + 1.0))


def gumbel_of(bits: torch.Tensor) -> torch.Tensor:
    """Gumbel noise (mode "low") from random bits: -log(-log(u)), u the
    uniform in [tiny, 1)."""
    return -xla_log(-xla_log(scale_unit(bits_to_unit(bits), TINY, 1.0)))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)``."""
    return gumbel_of(random_bits(key, shape))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the first index of the
    largest logits + gumbel, the gumbel over the logits' whole shape."""
    g = gumbel(key.to(logits.device), logits.shape)
    return torch.argmax(g + logits.to(torch.float32), dim=axis)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: w = -log1p(x * -x); below 5 the polynomial in
    w - 2.5, else in sqrt(w) - 3, by fused Horner steps; p * x, and x * inf
    at |x| = 1."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, sqrt32(w) - 3.0)
    p = torch.where(lt, ERFINV_LT5[0], ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
        p = fma32(p, t, torch.where(lt, a, b).to(torch.float32))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal_of(bits: torch.Tensor) -> torch.Tensor:
    """A standard normal from random bits: sqrt(2) erf_inv(u), u the
    uniform in [nextafter(-1, 0), 1)."""
    return SQRT2 * erf_inv(scale_unit(bits_to_unit(bits), NORMAL_LO, 1.0))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    return normal_of(random_bits(key, shape))


def _gamma_one(key: torch.Tensor, alpha: torch.Tensor) -> tuple:
    """``_gamma_one(key, alpha, log_space=True)`` for alpha >= 1, for a
    batch of keys [B, 2] and shapes alpha [B] float32, each element on its
    own: (log sample [B], attempts [B]).  Marsaglia and Tsang: d = alpha -
    1/3, c = (1/3) / sqrt(d); key, subkey = split(key); then, while the
    attempt is rejected (the first has U = 2, V = 1), key, x_key, U_key =
    split(key, 3), x ~ normal by split(x_key) until v = 1 + x c > 0, X =
    x^2, V = v^3, U ~ uniform(U_key); rejected iff U >= 1 - 0.0331 X^2 and
    log U >= X / 2 + d (1 - V + log V).  The result is log d + log V (the
    boost of alpha < 1 is not reached here).  Products that feed a sum are
    fused, as XLA's CPU code fuses them; c is (1/3) ``rsqrt32(d)``, as XLA
    computes it."""
    if not bool((alpha >= 1).all()):
        raise ValueError("the sampler's gamma shapes are >= 1 (counts plus one)")
    d = alpha - THIRD
    c = rsqrt32(d) * THIRD
    key = split(key)[..., 0, :].clone()
    V = torch.ones_like(alpha)
    attempts = torch.zeros(alpha.shape, dtype=torch.int64, device=alpha.device)
    todo = torch.ones(alpha.shape, dtype=torch.bool, device=alpha.device)
    while bool(todo.any()):
        idx = todo.nonzero().squeeze(1)
        k3 = split(key[idx], 3)
        key[idx] = k3[:, 0]
        xk = k3[:, 1].clone()
        x = torch.zeros(idx.shape, dtype=torch.float32, device=alpha.device)
        v = torch.full(idx.shape, -1.0, dtype=torch.float32, device=alpha.device)
        inner = v <= 0
        while bool(inner.any()):
            j = inner.nonzero().squeeze(1)
            k2 = split(xk[j])
            xk[j] = k2[:, 0]
            x[j] = normal_of(scalar_bits(k2[:, 1]))
            v[j] = fma32(x[j], c[idx[j]], 1.0)
            inner = v <= 0
        X = x * x
        Vn = v * v * v
        U = bits_to_unit(scalar_bits(k3[:, 2]))
        dn = d[idx]
        reject = (U >= fma32(-SQUEEZE, X * X, 1.0)) & (
            xla_log(U) >= fma32(X, 0.5, dn * ((1.0 - Vn) + xla_log(Vn))))
        V[idx] = Vn
        attempts[idx] += 1
        todo[idx] = reject
    return xla_log(d) + xla_log(V), attempts


def loggamma(key: torch.Tensor, a: torch.Tensor) -> tuple:
    """``jax.random.loggamma(key, a)`` for keys [B, 2] and shapes a [B]
    (each >= 1), element by element as the reference's vmap draws them:
    ``_gamma_impl`` splits each key once (split(key, 1)[0]) before
    ``_gamma_one``.  Returns (log samples float32 [B], attempts [B])."""
    return _gamma_one(split(key, 1)[..., 0, :], a.to(torch.float32))


def beta(key: torch.Tensor, a: torch.Tensor, b: torch.Tensor, attempts: bool = False):
    """``jax.random.beta(key, a, b)`` for keys [B, 2] and shapes a, b [B]
    (each >= 1): key_a, key_b = split(key); the two loggammas; then
    exp(la - m) / (exp(la - m) + exp(lb - m)), m = max(la, lb), the exp
    ``exp32``'s.  With
    ``attempts`` also the Marsaglia-Tsang attempts of each gamma [B, 2]."""
    kab = split(key)
    la, na = loggamma(kab[..., 0, :], a)
    lb, nb = loggamma(kab[..., 1, :], b)
    m = torch.maximum(la, lb)
    ga, gb = exp32(la - m), exp32(lb - m)
    q = ga / (ga + gb)
    return (q, torch.stack([na, nb], dim=-1)) if attempts else q
