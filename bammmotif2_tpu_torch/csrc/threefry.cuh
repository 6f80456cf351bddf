// The reference's random streams on the card: jax.random's Threefry-2x32
// (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as easy as 1,
// 2, 3", SC 2011) and the float functions its samplers use, as XLA's CPU
// code computes them.
//
// A key is two 32-bit words.  jax.random (jax 0.9.0, threefry partitionable)
// derives: split(key, n)[i] = threefry(key, (0, i)), which fold_in(key, i)
// equals; the bits of element j of a draw's shape = word0 ^ word1 of
// threefry(key, (j >> 32, j & 0xFFFFFFFF)); a scalar draw takes j = 0.
// A uniform is the bits' top 23 as the mantissa of a float in [1, 2), minus
// one, scaled and shifted (here only by spans whose product is exact).
//
// xla_logf and xla_log1pf are XLA's CPU float32 log and log1p: Cephes'
// polynomials (as Eigen's plog has them) with the multiply-adds that XLA's
// compiler fuses.  erf_inv is the float32 polynomial XLA lowers
// chlo.erf_inv to.  Every product that feeds a sum the reference fuses is
// fmaf here, and every other one is __fmul_rn/__fadd_rn, so nvcc's own
// contraction changes nothing.  The plain versions are
// ops/threefry.py (xla_log, xla_log1p, erf_inv, normal_of, _gamma_one),
// which tests/test_torch_threefry.py holds to jax.random bit for bit on the
// CPU; chip_smoke.py holds this header's kernels to them on the card.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kParity = 0x1BD11BDAu;
constexpr float kTinyF = 1.17549435e-38f;        // float32's smallest normal
constexpr float kNormalLo = -0.99999994f;        // nextafter(-1, 0)
constexpr float kSqrt2 = 1.41421354f;            // float32(sqrt(2))

// Two shifts and an or, which nvcc makes one funnel shift (SHF.L.W), as it
// does __funnelshift_l (tools/sass_mix.py).  In cgs_z this form took 39
// registers against __funnelshift_l's 48 and, on an H100, 101 us at M=4
// and 245 at M=10 against 104 and 253, 29.7 at M=1 against 28.3
// (tools/kernel_variants.py --design cgs_draws).
__device__ __forceinline__ unsigned rotl32(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

// A key's Threefry-2x32 schedule: its three words and the y words of the
// five key injections (the injection's count added).  A draw of many
// elements from one key computes it once.
struct Schedule {
  unsigned ks[3];
  unsigned inj_y[5];
};

__device__ __forceinline__ Schedule schedule_of(uint2 k) {
  Schedule s;
  s.ks[0] = k.x;
  s.ks[1] = k.y;
  s.ks[2] = k.x ^ k.y ^ kParity;
#pragma unroll
  for (int i = 0; i < 5; ++i) s.inj_y[i] = s.ks[(i + 2) % 3] + (unsigned)(i + 1);
  return s;
}

// Threefry-2x32, 20 rounds, of the counter x under the schedule s.
__device__ __forceinline__ uint2 threefry2x32(const Schedule& s, uint2 x) {
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x.x += s.ks[0];
  x.y += s.ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x.x += x.y;
      x.y = rotl32(x.y, rot[i % 2][j]) ^ x.x;
    }
    x.x += s.ks[(i + 1) % 3];
    x.y += s.inj_y[i];
  }
  return x;
}

// Threefry-2x32, 20 rounds, of the counter x under the key k.
__device__ __forceinline__ uint2 threefry2x32(uint2 k, uint2 x) {
  return threefry2x32(schedule_of(k), x);
}

// split(key, n)[i], which is also fold_in(key, i).
__device__ __forceinline__ uint2 split_key(uint2 key, unsigned i) {
  return threefry2x32(key, make_uint2(0u, i));
}

// The random bits of element j of a draw from `key`.
__device__ __forceinline__ unsigned random_bits(uint2 key, unsigned long long j) {
  const uint2 w = threefry2x32(key, make_uint2((unsigned)(j >> 32), (unsigned)j));
  return w.x ^ w.y;
}

// The random bits of element j < 2^32 of a draw whose key's schedule is s.
__device__ __forceinline__ unsigned random_bits(const Schedule& s, unsigned j) {
  const uint2 w = threefry2x32(s, make_uint2(0u, j));
  return w.x ^ w.y;
}

// float32 in [0, 1) from 32 bits.
__device__ __forceinline__ float unit_float(unsigned bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// Cephes' logf of m * 2^ei, m in [0.5, 1) (frexpf's split), as XLA's CPU
// code computes it.
__device__ __forceinline__ float cephes_logf(float m, int ei) {
  const bool low = m < 0.707106769f;
  const float e = __fsub_rn((float)ei, low ? 1.0f : 0.0f);
  m = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float m2 = __fmul_rn(m, m);
  const float m3 = __fmul_rn(m2, m);
  float y = fmaf(fmaf(7.0376836292e-2f, m, -1.1514610310e-1f), m, 1.1676998740e-1f);
  const float y1 = fmaf(fmaf(-1.2420140846e-1f, m, 1.4249322787e-1f), m, -1.6668057665e-1f);
  const float y2 = fmaf(fmaf(2.0000714765e-1f, m, -2.4999993993e-1f), m, 3.3333331174e-1f);
  y = fmaf(fmaf(y, m3, y1), m3, y2);
  y = fmaf(y, m3, __fmul_rn(e, -2.12194440e-4f));
  return __fadd_rn(__fadd_rn(__fsub_rn(m, __fmul_rn(m2, 0.5f)), y), __fmul_rn(e, 0.693359375f));
}

// XLA's CPU float32 log: inputs below the smallest normal count as zero.
__device__ __forceinline__ float xla_logf(float x) {
  if (x != x || x < 0.0f) return __int_as_float(0x7fc00000);
  if (x < kTinyF) return -__int_as_float(0x7f800000);
  if (x == __int_as_float(0x7f800000)) return x;
  int ei;
  const float m = frexpf(x, &ei);
  return cephes_logf(m, ei);
}

// xla_logf for a normal, positive, finite x: frexpf's mantissa and
// exponent read from the bits, none of the other cases tested.
__device__ __forceinline__ float xla_logf_normal(float x) {
  const unsigned u = __float_as_uint(x);
  return cephes_logf(__uint_as_float((u & 0x007FFFFFu) | 0x3F000000u), (int)(u >> 23) - 126);
}

// XLA's CPU float32 log1p.
__device__ __forceinline__ float xla_log1pf(float x) {
  if (!(fabsf(x) < 0.414213568f)) return xla_logf(__fadd_rn(x, 1.0f));
  const float x2 = __fmul_rn(x, x);
  float p = 4.5270000862445199635215e-5f, q = 1.0f;
  p = fmaf(p, x, 4.9854102823193375972212e-1f);
  q = fmaf(q, x, 1.5062909083469192198e1f);
  p = fmaf(p, x, 6.5787325942061044846969e0f);
  q = fmaf(q, x, 8.3047565967967209469434e1f);
  p = fmaf(p, x, 2.9911919328553073277375e1f);
  q = fmaf(q, x, 2.2176239823732856465394e2f);
  p = fmaf(p, x, 6.0949667980987787057556e1f);
  q = fmaf(q, x, 3.0909872225312059774938e2f);
  p = fmaf(p, x, 5.7112963590585538103336e1f);
  q = fmaf(q, x, 2.1642788614495947685003e2f);
  p = fmaf(p, x, 2.0039553499201281259648e1f);
  q = fmaf(q, x, 6.0118660497603843919306e1f);
  return __fadd_rn(x, fmaf(-0.5f, x2, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q))));
}

// XLA's float32 erf_inv (Giles' single-precision polynomial).
__device__ __forceinline__ float xla_erf_inv(float x) {
  const float w = -xla_log1pf(__fmul_rn(x, -x));
  float p, t;
  if (w < 5.0f) {
    t = __fsub_rn(w, 2.5f);
    p = 2.81022636e-08f;
    p = fmaf(p, t, 3.43273939e-07f);
    p = fmaf(p, t, -3.5233877e-06f);
    p = fmaf(p, t, -4.39150654e-06f);
    p = fmaf(p, t, 0.00021858087f);
    p = fmaf(p, t, -0.00125372503f);
    p = fmaf(p, t, -0.00417768164f);
    p = fmaf(p, t, 0.246640727f);
    p = fmaf(p, t, 1.50140941f);
  } else {
    t = __fsub_rn(__fsqrt_rn(w), 3.0f);
    p = -0.000200214257f;
    p = fmaf(p, t, 0.000100950558f);
    p = fmaf(p, t, 0.00134934322f);
    p = fmaf(p, t, -0.00367342844f);
    p = fmaf(p, t, 0.00573950773f);
    p = fmaf(p, t, -0.0076224613f);
    p = fmaf(p, t, 0.00943887047f);
    p = fmaf(p, t, 1.00167406f);
    p = fmaf(p, t, 2.83297682f);
  }
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7f800000));
  return __fmul_rn(p, x);
}

// Gumbel noise (jax.random.gumbel, mode "low") from 32 bits.  Its logs'
// inputs, u in [2^-126, 1) and -log u in (0, 87.4], are normal, positive
// and finite, so xla_logf_normal gives xla_logf's results.
__device__ __forceinline__ float gumbel_of(unsigned bits) {
  const float u = fmaxf(kTinyF, __fadd_rn(unit_float(bits), kTinyF));
  return -xla_logf_normal(-xla_logf_normal(u));
}

// A standard normal (jax.random.normal) from 32 bits: the uniform's span
// 1 - nextafter(-1, 0) rounds to 2 in float32, so its product is exact.
__device__ __forceinline__ float normal_of(unsigned bits) {
  const float u = fmaxf(kNormalLo, __fadd_rn(__fmul_rn(unit_float(bits), 2.0f), kNormalLo));
  return __fmul_rn(kSqrt2, xla_erf_inv(u));
}

// One attempt of jax.random's _gamma_one(key, alpha, log_space=True) for
// alpha >= 1 (Marsaglia and Tsang, d = alpha - 1/3, c = (1/3) / sqrt(d)),
// its key splits as the reference makes them: from the attempt's key,
// *next = split(key, 3)[0] (the next attempt's key), x ~ normal drawn by
// split(x key) until v = 1 + x c > 0, U ~ uniform(U key); *V = v^3.
// Returns whether the attempt is rejected.
__device__ __forceinline__ bool gamma_attempt(uint2 key, float c, float d, float* V,
                                              uint2* next) {
  const uint2 x_key0 = split_key(key, 1), u_key = split_key(key, 2);
  *next = split_key(key, 0);
  uint2 x_key = x_key0;
  float x = 0.0f, v = -1.0f;
  while (v <= 0.0f) {
    const uint2 sub = split_key(x_key, 1);
    x_key = split_key(x_key, 0);
    x = normal_of(random_bits(sub, 0));
    v = fmaf(x, c, 1.0f);
  }
  const float X = __fmul_rn(x, x);
  *V = __fmul_rn(__fmul_rn(v, v), v);
  const float U = unit_float(random_bits(u_key, 0));
  return (U >= fmaf(-0.0331000011f, __fmul_rn(X, X), 1.0f)) &&
         (xla_logf(U) >= fmaf(X, 0.5f, __fmul_rn(d, __fadd_rn(__fsub_rn(1.0f, *V),
                                                              xla_logf(*V)))));
}

// _gamma_one's d and c for alpha: XLA computes (1/3) / sqrt(d) as (1/3) *
// rsqrt(d) (ops/threefry.py::rsqrt32).
__device__ __forceinline__ float2 gamma_dc(float alpha) {
  const float d = __fsub_rn(alpha, 0.333333343f);
  return make_float2(d, __fmul_rn((float)(1.0 / sqrt((double)d)), 0.333333343f));
}

}  // namespace
