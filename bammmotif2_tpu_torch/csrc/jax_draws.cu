// The sampled paths' draws from the reference's own jax.random streams:
// the Markov sampler of the negatives and CGS's z and q draws.
//
// Not Pallas kernels: the port's counterparts of the reference's jax.random
// code in bammmotif2_tpu/generator/seqgen.py::_sample_markov_batch
// (seqgen.py:29-66) and bammmotif2_tpu/refinement/gibbs.py::
// gibbs_step_multi (z: gibbs.py:374-379; q: :388-390).  Each draws what
// the reference draws from the same key (threefry.cuh), so a run with the
// same --seed samples the same negatives and the same chains.  The keys
// are read from device memory and CGS's carried keys advance in place, so a
// captured CGS sweep that a CUDA graph WHILE node repeats draws anew each
// sweep with no host involvement (refinement/graphs.py::Loop.run_while).
// The plain versions are ops/cuda_draws.py::markov_codes_ref, cgs_z_ref
// and cgs_beta_ref (torch, ops/threefry.py).
//
// Contract (row-major, contiguous):
//   markov_codes: key int64 [2] (words), trans f32 [sum_m A^(m+1)] (the
//     conditionals of orders 0 .. s_order, flat and concatenated), lens
//     int32 [N] -> codes int8 [N, L].  Row n, position t < lens[n]: the
//     first argmax over a of log trans[order][ctx, a] + gumbel(key_t, j)
//     with key_t = split(key, L)[t], j = n A + a, order = min(t, s_order),
//     ctx the codes before t (growing for t < s_order, then rolling over
//     s_order); PAD (-2) from lens[n] on.  A thread a row; the log tables
//     sit in shared memory.
//   cgs_z: flat f32 [M, N, C] (each row's logits), keys int64 [M, 2] (the
//     chains' carried keys, read), row0 -> z int64 [M, N]: sub =
//     split(keys[m])[1], the row key fold_in(sub, row0 + n), z the first
//     argmax over c of flat[m, n, c] + gumbel(row key, c).  A warp a row.
//   cgs_beta: a, b f32 [M] (>= 1), keys int64 [M, 2] (updated in place),
//     draw, lo, hi -> q f32 [M]: k1 = split(key)[0] (z's split), (k2,
//     sub_q) = split(k1), q = clip(beta(sub_q, a, b), lo, hi) where draw is
//     set, and key <- k2, as the reference splits twice a sweep whether or
//     not it samples; attempts int32 [M, 2] (optional) the Marsaglia-Tsang
//     attempts of each gamma.  A thread a chain.
//   beta(key, a, b): (ka, kb) = split(key); la = log_gamma_one(split(ka,
//     1)[0], a), lb likewise; m = max(la, lb); exp(la - m) / (exp(la - m)
//     + exp(lb - m)), the exp rounded from float64's (ops/threefry.py::
//     exp32): XLA's CPU exp is its own, within an ulp of it, the one float
//     function here not bit-equal to the reference's.
//
// What bounds them: operations.  markov_codes evaluates A + 1 Threefry
// hashes (20 rounds of add, rotate, xor) and 2 A Cephes logs a position;
// cgs_z one hash and two logs an element of flat, the same work the
// reference's categorical does.  They read their inputs once and write
// their outputs once.  cgs_beta is a few hundred operations a chain.

#include <cstdint>

#include "common.cuh"
#include "threefry.cuh"

namespace {

constexpr int kSmemTableFloats = 12288;  // 48 KB: the log tables in shared memory up to here
constexpr signed char kPad = -2;

__device__ __forceinline__ uint2 key_at(const long long* keys, int m) {
  return make_uint2((unsigned)keys[2 * m], (unsigned)keys[2 * m + 1]);
}

// First index of the largest value, NaN counting as the largest (argmax).
__device__ __forceinline__ bool better(float v, int i, float best, int bi) {
  if (v != v) return best == best || i < bi;
  if (best != best) return false;
  return v > best || (v == best && i < bi);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
markov_codes_kernel(const long long* __restrict__ key, const float* __restrict__ trans,
                    const int* __restrict__ lens, signed char* __restrict__ codes, int N,
                    int L, int s_order, int A, int table) {
  extern __shared__ float logs_smem[];
  if (kShared) {
    for (int i = threadIdx.x; i < table; i += blockDim.x) logs_smem[i] = xla_logf(trans[i]);
    __syncthreads();
  }
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint2 k = key_at(key, 0);
  const int len = min(L, max(lens[n], 0));
  signed char* row = codes + (size_t)n * L;
  int offset[8];  // start of order m's table; s_order < 8 (checked by the launcher)
  offset[0] = 0;
  // order m - 1 has A^(m-1) context rows of A entries
  for (int m = 1, rows = 1; m <= s_order; ++m, rows *= A) offset[m] = offset[m - 1] + rows * A;
  int roll = 1;  // A^(s_order - 1)
  for (int m = 1; m < s_order; ++m) roll *= A;
  int ctx = 0;
  for (int t = 0; t < len; ++t) {
    const uint2 kt = split_key(k, (unsigned)t);
    const int order = t < s_order ? t : s_order;
    const int base = offset[order] + ctx * A;
    float best = 0.0f;
    int c = -1;
    for (int a = 0; a < A; ++a) {
      const float lg = kShared ? logs_smem[base + a] : xla_logf(trans[base + a]);
      const float v = __fadd_rn(gumbel_of(random_bits(kt, (unsigned long long)n * A + a)), lg);
      if (c < 0 || better(v, a, best, c)) {
        best = v;
        c = a;
      }
    }
    row[t] = (signed char)c;
    if (order < s_order) {
      ctx = ctx * A + c;
    } else if (s_order > 0) {
      ctx = (ctx % roll) * A + c;
    }
  }
  for (int t = len; t < L; ++t) row[t] = kPad;
}

// Warp w of block (x, m) draws row n = x * kWarps + w of chain m.
__global__ void __launch_bounds__(kThreads)
cgs_z_kernel(const float* __restrict__ flat, const long long* __restrict__ keys,
             long long* __restrict__ z, long long row0, int N, int C) {
  const int m = blockIdx.y;
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= N) return;
  const uint2 sub = split_key(key_at(keys, m), 1);
  const uint2 row_key = split_key(sub, (unsigned)(row0 + n));
  const float* r = flat + ((size_t)m * N + n) * C;
  float best = 0.0f;
  int bi = -1;
  for (int c = lane; c < C; c += 32) {
    const float v = __fadd_rn(gumbel_of(random_bits(row_key, (unsigned long long)c)), r[c]);
    if (bi < 0 || better(v, c, best, bi)) {
      best = v;
      bi = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (oi >= 0 && (bi < 0 || better(ov, oi, best, bi))) {
      best = ov;
      bi = oi;
    }
  }
  if (lane == 0) z[(size_t)m * N + n] = bi;
}

__global__ void cgs_beta_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                long long* __restrict__ keys, float* __restrict__ q,
                                int* __restrict__ attempts, int draw, float lo, float hi, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const uint2 k1 = split_key(key_at(keys, m), 0);
  const uint2 k2 = split_key(k1, 0), sub_q = split_key(k1, 1);
  if (draw) {
    int na = 0, nb = 0;
    float r = __int_as_float(0x7fc00000);
    if (a[m] >= 1.0f && b[m] >= 1.0f) {
      const float la = log_gamma_one(split_key(split_key(sub_q, 0), 0), a[m], &na);
      const float lb = log_gamma_one(split_key(split_key(sub_q, 1), 0), b[m], &nb);
      const float mx = fmaxf(la, lb);
      const float ga = (float)exp((double)__fsub_rn(la, mx));
      const float gb = (float)exp((double)__fsub_rn(lb, mx));
      r = fminf(fmaxf(__fdiv_rn(ga, __fadd_rn(ga, gb)), lo), hi);
    }
    q[m] = r;
    if (attempts != nullptr) {
      attempts[2 * m] = na;
      attempts[2 * m + 1] = nb;
    }
  }
  keys[2 * m] = k2.x;
  keys[2 * m + 1] = k2.y;
}

}  // namespace

extern "C" {

// Launches markov_codes_kernel on `stream` of `device`: codes [N, L], one
// launch.  1 <= A, 0 <= s_order < 8, table = sum_m A^(m+1).  Returns a
// cudaError_t (0 = success).
int markov_codes_launch(const long long* key, const float* trans, const int* lens,
                        signed char* codes, int N, int L, int s_order, int A, int table,
                        int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  if (s_order < 0 || s_order >= 8 || A < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int blocks = (N + kThreads - 1) / kThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  if (table <= kSmemTableFloats) {
    markov_codes_kernel<true><<<blocks, kThreads, table * sizeof(float), st>>>(
        key, trans, lens, codes, N, L, s_order, A, table);
  } else {
    markov_codes_kernel<false><<<blocks, kThreads, 0, st>>>(key, trans, lens, codes, N, L,
                                                            s_order, A, table);
  }
  return (int)cudaGetLastError();
}

// Launches cgs_z_kernel on `stream` of `device`: z [M, N], one launch.
// 1 <= M <= 65535, C >= 1.  Returns a cudaError_t (0 = success).
int cgs_z_launch(const float* flat, const long long* keys, long long* z, long long row0, int N,
                 int C, int M, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  if (N == 0) return (int)cudaSuccess;
  const dim3 grid((N + kWarps - 1) / kWarps, M);
  cgs_z_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(flat, keys, z, row0, N,
                                                                         C);
  return (int)cudaGetLastError();
}

// Launches cgs_beta_kernel on `stream` of `device`: q [M] where draw is
// set (and attempts, where not null), the keys advanced; one launch.
// Returns a cudaError_t (0 = success).
int cgs_beta_launch(const float* a, const float* b, long long* keys, float* q, int* attempts,
                    int draw, float lo, float hi, int M, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const int threads = 64;
  cgs_beta_kernel<<<(M + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, keys, q, attempts, draw, lo, hi, M);
  return (int)cudaGetLastError();
}

const char* jax_draws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
