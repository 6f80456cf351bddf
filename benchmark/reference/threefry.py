"""The sampled negatives' random stream, in plain torch: ``jax.random``'s
Threefry-2x32 keys and bits, and the order-s Markov sampler that BaMMmotif2's
FDR draws its negatives with (``SeqGenerator``; the JAX reference's
``seqgen._sample_markov_batch``).

Written from the published algorithms, not from the program: Threefry-2x32
(Salmon et al., SC 2011; 20 rounds, rotations (13, 15, 26, 6) / (17, 29,
16, 24), key word 3 = k0 ^ k1 ^ 0x1BD11BDA) and ``jax.random``'s
derivations of keys and bits (jax 0.9.0, ``jax_threefry_partitionable``):

  * ``PRNGKey(seed)`` = (seed >> 32, seed & 0xFFFFFFFF);
  * ``split(key, n)[i]`` = threefry(key, (0, i));
  * ``bits(key, shape)``: word0 ^ word1 of threefry(key, (j >> 32, j &
    0xFFFFFFFF)) at each element's flat index j;
  * ``uniform(tiny, 1)``: the bits' top 23 as the mantissa of a float in
    [1, 2), minus 1, times (1 - tiny), plus tiny, then max(tiny, .);
  * ``gumbel`` = -log(-log(u)); ``categorical`` = the first argmax of
    logits + gumbel.

The logarithm is XLA's float32 one on the CPU (Cephes' ``logf`` polynomial
with fused multiply-adds, each fused step rounded once), so the draws are
the JAX reference's bit for bit; a torch ``log`` differs from it by an ulp
now and then, which moves an argmax where two candidates tie within it.
All arithmetic is int64 on 32-bit words and float32 (float64 where a fused
step is emulated), so it runs on any device.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)
LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
         1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
         3.3333331174e-1)
LOG_Q1, LOG_Q2 = -2.12194440e-4, 0.693359375
LOG_SQRTHF = float(np.float32(0.707106781186547524))
PAD = -1  # a position at or past a row's length


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x0, x1) -> tuple:
    """The two output words of Threefry-2x32 of counters (x0, x1) under
    ``key`` [..., 2] (int64 tensors of 32-bit words, broadcast)."""
    k0, k1 = key[..., 0], key[..., 1]
    x0 = torch.as_tensor(x0, dtype=torch.int64, device=key.device)
    x1 = torch.as_tensor(x1, dtype=torch.int64, device=key.device)
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
    seed = int(seed)
    hi = (seed >> 32) & MASK32 if seed >= 0 else 0
    return torch.tensor([hi, seed & MASK32], dtype=torch.int64, device=device)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """Keys [n, 2] of one key [2]."""
    w0, w1 = threefry2x32(key[None, :], 0, torch.arange(n, dtype=torch.int64,
                                                         device=key.device))
    return torch.stack([w0, w1], dim=-1)


def bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    j = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=key.device)
    w0, w1 = threefry2x32(key, j >> 32, j & MASK32)
    return (w0 ^ w1).reshape(shape)


def fma32(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32: exact product in float64, the
    sum's error by TwoSum, the float64 sum rounded to odd before the
    float32 rounding, so the two roundings act as one."""
    f64 = torch.float64
    dev = next((t.device for t in (a, b, c) if isinstance(t, torch.Tensor)), None)
    a, b, c = (torch.as_tensor(t, device=dev).to(torch.float32).to(f64) for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    word = s.view(torch.int64)
    inexact = (err != 0) & torch.isfinite(s)
    away = inexact & ((err < 0) == (s > 0))
    word = torch.where(away, word - 1, word)
    word = torch.where(inexact, word | 1, word)
    return word.view(f64).to(torch.float32)


def log32(x: torch.Tensor) -> torch.Tensor:
    """Cephes' float32 logf with fused steps (XLA's CPU log); inputs under
    the smallest normal give -inf."""
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
    return torch.where(x < TINY, float("-inf"), r)


def gumbel(raw: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)) of u = uniform(tiny, 1) from 32 random bits."""
    f = ((raw >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(TINY)
    u = torch.clamp_min(f * float(np.float32(1.0) - lo) + float(lo), float(lo))
    return -log32(-log32(u))


def markov_codes(key: torch.Tensor, trans: list, lens: torch.Tensor, L: int) -> torch.Tensor:
    """int64 [N, L] codes of rows of lengths ``lens`` [N] sampled from an
    order-s Markov chain, s = len(trans) - 1 (trans[m]: float32 [A^(m+1)]
    conditionals, lexicographic, the oldest base most significant): position
    t of every row is a categorical draw of key ``split(key, L)[t]`` over
    the logits of the row's context of min(t, s) bases; positions at or
    past a row's length are PAD."""
    N, dev = lens.shape[0], lens.device
    s = len(trans) - 1
    A = trans[0].shape[0]
    logits = [log32(t.to(torch.float32).reshape(-1, A)) for t in trans]
    keys = split(key.to(dev), L)
    codes = torch.empty((N, L), dtype=torch.int64, device=dev)
    ctx = torch.zeros(N, dtype=torch.int64, device=dev)
    for t in range(L):
        k = min(t, s)
        c = torch.argmax(gumbel(bits(keys[t], (N, A))) + logits[k][ctx], dim=1)
        codes[:, t] = c
        ctx = ctx * A + c if k < s else (ctx % A ** (s - 1)) * A + c if s > 0 else ctx
    return codes.masked_fill_(torch.arange(L, device=dev)[None, :] >= lens[:, None], PAD)
