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
//     argmax over c of flat[m, n, c] + gumbel(row key, c), NaN the largest.
//     A warp a row, on the resident grid.
//   cgs_beta: a, b f32 [M] (>= 1), keys int64 [M, 2] (updated in place),
//     draw, lo, hi -> q f32 [M]: k1 = split(key)[0] (z's split), (k2,
//     sub_q) = split(k1), q = clip(beta(sub_q, a, b), lo, hi) where draw is
//     set, and key <- k2, as the reference splits twice a sweep whether or
//     not it samples; attempts int32 [M, 2] (optional) the Marsaglia-Tsang
//     attempts of each gamma.  kBetaLanes lanes a chain.
//   beta(key, a, b): (ka, kb) = split(key); la = log_gamma_one(split(ka,
//     1)[0], a), lb likewise; m = max(la, lb); exp(la - m) / (exp(la - m)
//     + exp(lb - m)), the exp rounded from float64's (ops/threefry.py::
//     exp32): XLA's CPU exp is its own, within an ulp of it, the one float
//     function here not bit-equal to the reference's.
//
// What bounds them (chip_smoke.py::bound; H100 SXM: 3.35 TB/s, 67 TFLOP/s
// f32, and 132 SMs of two 32-bit integer pipes, 64 results a clock each:
// shifts and bitwise operations on the ALU pipe alone, adds on either).  A
// Threefry-2x32 hash is THREEFRY_INT_OPS = 73 integer operations, of them
// THREEFRY_ALU_OPS = 41 rotates and xors (ops/cuda_draws.py): nvcc makes a
// rotate one SHF and a xor one LOP3, and the adds IADD3 or IMAD.IADD
// (tools/sass_mix.py), so a hash costs the ALU pipe at least 41 of its
// results.  At 1,980 MHz:
//   markov_codes: A hashes a letter of each position and row and L splits,
//     2 A Cephes logs (GUMBEL_F32_OPS = 62 a draw) and the row's codes: at
//     1M x 200 bp, sOrder 2, 2.0 ms of ALU-pipe work, 0.74 ms of f32, 0.06
//     ms of bytes.  A thread a row, its log tables in shared memory; each
//     thread makes split(key, t) again.  Its Gumbel is cgs_z's (gumbel_of,
//     the logs fitted to their range).
//   cgs_z: a hash and 62 f32 operations an element, a hash a row and a
//     chain, the logits read once: at M=1, 10k rows of 379 logits, 9.3 us
//     of ALU-pipe work, 3.5 of f32, 4.6 of bytes.  So the work an element
//     is cut to the hash's: the warps of the resident grid walk the rows
//     (no second wave of blocks); a lane makes one row key for 32 rows and
//     the warp shares them by shuffles; a row's key schedule (Schedule) is
//     made once, so an element pays the 20 rounds and 5 injections alone;
//     the two logs read exponent and mantissa from the bits
//     (xla_logf_normal: Gumbel's inputs are normal, positive and finite);
//     the compare tests for NaN only where v is not below the best; a lane
//     loads kZElems logits before it hashes them.  On an H100 (700 W,
//     tools/kernel_variants.py --design cgs_draws): 29.7 us at M=1, 101 at
//     M=4 and 245 at M=10, against 32.1, 118 and 275 with one element a
//     lane; 8 elements took 27.5 / 101 / 245, 6 blocks an SM 30.4 / 101 /
//     245; in an earlier sweep (the rotate then a funnel shift) the
//     general logs took 36.4 / 128 / 314 against 28.6 / 105 / 256.
//   cgs_beta: 44 bytes and about 23 hashes a chain: latency, not work.  On
//     one thread a chain's hashes run one after another, ~14 deep with both
//     gammas; gamma a and gamma b run on lanes of their own, side by side,
//     so a chain waits for ~8: the sweep's 2 splits, a gamma's 3, an
//     attempt's 3.  kBetaSpec lanes a gamma run attempts 0 .. kBetaSpec - 1
//     at once (lane j first makes attempt j's key, j more splits), the
//     lowest accepted winning by ballot; a round with none goes on from the
//     last lane's next key.  On an H100 (700 W, kernel_variants --design
//     cgs_draws), 2 lanes a gamma took 3.53 us at M=1 against 3.37 with 1
//     and 3.78 with 4, and 4.43 at M=16 against 4.98 with 1 and 4.31 with
//     4 (5.79 with 1 where a = b = 1, one attempt in twenty rejected):
//     kBetaSpec is 2.  Threads are launched kBetaLanes a chain, so a warp
//     holds 32 / kBetaLanes chains.

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

// Elements of a row a lane has in flight in cgs_z_kernel.
constexpr int kZElems = 4;

// The (m, n) rows of z, m * N + n < rows, a warp a row: warp w of the
// resident grid's `warps` takes rows w, w + warps, ...  Lane l of a warp
// makes the row key of its 32 rows' l-th (the chain's split and the row's
// fold_in, 2 hashes for 32 rows), the warp reads each row's key schedule
// from it, and a lane then pays the 20 rounds alone for each of its
// elements c = l, l + 32, ...
__global__ void __launch_bounds__(kThreads)
cgs_z_kernel(const float* __restrict__ flat, const long long* __restrict__ keys,
             long long* __restrict__ z, long long row0, int N, int C, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long first = blockIdx.x * (long long)kWarps + (threadIdx.x >> 5); first < rows;
       first += 32 * warps) {
    const long long mine = first + lane * warps;
    uint2 row_key = make_uint2(0u, 0u);
    if (mine < rows) {
      const long long m = mine / N;
      row_key = split_key(split_key(key_at(keys, (int)m), 1), (unsigned)(row0 + mine - m * N));
    }
    for (int j = 0; j < 32; ++j) {
      const long long row = first + j * warps;
      if (row >= rows) break;  // the same for every lane of the warp
      const Schedule ks = schedule_of(make_uint2(__shfl_sync(0xffffffffu, row_key.x, j),
                                                 __shfl_sync(0xffffffffu, row_key.y, j)));
      const float* r = flat + row * C;
      // v > best, or a NaN on either side: a NaN v comes only from a NaN
      // logit (the gumbel term is finite), and a NaN best stays; bi < 0
      // until a v above -inf (a row of -inf draws 0)
      float best = -__int_as_float(0x7f800000);
      int bi = -1;
      for (int c0 = lane; c0 < C; c0 += 32 * kZElems) {
        float x[kZElems];
#pragma unroll
        for (int e = 0; e < kZElems; ++e) {
          const int c = c0 + 32 * e;
          x[e] = c < C ? r[c] : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < kZElems; ++e) {
          const int c = c0 + 32 * e;
          if (c >= C) break;
          const float v = __fadd_rn(gumbel_of(random_bits(ks, (unsigned)c)), x[e]);
          if (!(v <= best) && best == best) {
            best = v;
            bi = c;
          }
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
      if (lane == 0) z[row] = bi < 0 ? 0 : bi;
    }
  }
}

// Lanes a gamma of cgs_beta_kernel: its attempts in flight at once.
constexpr int kBetaSpec = 2;
constexpr int kBetaLanes = 2 * kBetaSpec;  // a chain's: gamma a's, then gamma b's
constexpr int kBetaThreads = 128;
static_assert(32 % kBetaLanes == 0, "a chain's lanes lie in one warp");

// log Gamma(alpha) from `key` (_gamma_one's key) on the kBetaSpec lanes
// `group` of a warp, this one the j-th: in each round lane j runs attempt
// round * kBetaSpec + j, whose key is the round's split(., 0) j times, and
// the lowest accepted attempt wins (a ballot); a round without one goes on
// from the last lane's next key.  Every lane of the group returns the
// serial loop's result and *attempts its count.
__device__ __forceinline__ float log_gamma_lanes(uint2 key, float alpha, int j, unsigned group,
                                                 int* attempts) {
  const float2 dc = gamma_dc(alpha);
  const int first = __ffs(group) - 1;
  for (int round = 0;; ++round) {
    uint2 k = key, next;
    for (int i = 0; i < j; ++i) k = split_key(k, 0);
    float V;
    const unsigned won = __ballot_sync(group, !gamma_attempt(k, dc.y, dc.x, &V, &next));
    if (won) {
      const int lane = __ffs(won) - 1;
      *attempts = round * kBetaSpec + lane - first + 1;
      return __fadd_rn(xla_logf(dc.x), xla_logf(__shfl_sync(group, V, lane)));
    }
    key = make_uint2(__shfl_sync(group, next.x, first + kBetaSpec - 1),
                     __shfl_sync(group, next.y, first + kBetaSpec - 1));
  }
}

// Chain m on kBetaLanes lanes of one warp: every lane makes the sweep's
// splits; gamma a's lanes and gamma b's draw side by side
// (log_gamma_lanes); the chain's first lane joins them and writes q,
// the attempts and the advanced key.
__global__ void __launch_bounds__(kBetaThreads)
cgs_beta_kernel(const float* __restrict__ a, const float* __restrict__ b,
                long long* __restrict__ keys, float* __restrict__ q, int* __restrict__ attempts,
                int draw, float lo, float hi, int M) {
  const int t = blockIdx.x * kBetaThreads + threadIdx.x;
  const int m = t / kBetaLanes, g = t % kBetaLanes, lane = threadIdx.x & 31;
  const bool live = m < M;
  const uint2 k1 = split_key(key_at(keys, live ? m : 0), 0);
  const uint2 k2 = split_key(k1, 0), sub_q = split_key(k1, 1);
  float lg = 0.0f;
  int n = 0;
  bool ok = false;
  if (draw) {
    const int gamma = g / kBetaSpec;
    ok = live && a[m] >= 1.0f && b[m] >= 1.0f;  // the same on a chain's lanes
    if (ok) {
      const unsigned group = ((1u << kBetaSpec) - 1u) << (lane - g % kBetaSpec);
      // loggamma's split(key, 1)[0], then _gamma_one's split(key)[0]
      lg = log_gamma_lanes(split_key(split_key(split_key(sub_q, gamma), 0), 0),
                           gamma ? b[m] : a[m], g % kBetaSpec, group, &n);
    }
    const int head = lane - g;  // the chain's first lane
    const float la = __shfl_sync(0xffffffffu, lg, head);
    const float lb = __shfl_sync(0xffffffffu, lg, head + kBetaSpec);
    const int nb = __shfl_sync(0xffffffffu, n, head + kBetaSpec);
    if (live && g == 0) {
      float r = __int_as_float(0x7fc00000);
      if (ok) {
        const float mx = fmaxf(la, lb);
        const float ga = (float)exp((double)__fsub_rn(la, mx));
        const float gb = (float)exp((double)__fsub_rn(lb, mx));
        r = fminf(fmaxf(__fdiv_rn(ga, __fadd_rn(ga, gb)), lo), hi);
      }
      q[m] = r;
      if (attempts != nullptr) {
        attempts[2 * m] = n;
        attempts[2 * m + 1] = nb;
      }
    }
  }
  __syncwarp();  // every lane has read its chain's key
  if (live && g == 0) {
    keys[2 * m] = k2.x;
    keys[2 * m + 1] = k2.y;
  }
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

// Launches cgs_z_kernel on `stream` of `device`: z [M, N], one launch of
// the resident blocks (at most a warp a row).  M >= 1, C >= 1.  Returns a
// cudaError_t (0 = success).
int cgs_z_launch(const float* flat, const long long* keys, long long* z, long long row0, int N,
                 int C, int M, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  if (N == 0) return (int)cudaSuccess;
  const long long rows = (long long)M * N;
  int grid = 0;
  const cudaError_t err = resident_grid(cgs_z_kernel, 0, (rows + kWarps - 1) / kWarps, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  cgs_z_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(flat, keys, z, row0, N,
                                                                         C, rows);
  return (int)cudaGetLastError();
}

// Launches cgs_beta_kernel on `stream` of `device`: q [M] where draw is
// set (and attempts, where not null), the keys advanced; one launch of
// kBetaLanes threads a chain.  Returns a cudaError_t (0 = success).
int cgs_beta_launch(const float* a, const float* b, long long* keys, float* q, int* attempts,
                    int draw, float lo, float hi, int M, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const int blocks = (int)(((long long)M * kBetaLanes + kBetaThreads - 1) / kBetaThreads);
  cgs_beta_kernel<<<blocks, kBetaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, keys, q, attempts, draw, lo, hi, M);
  return (int)cudaGetLastError();
}

// cgs_beta_kernel's lanes a gamma: the attempts it runs at once.
int cgs_beta_spec_lanes() { return kBetaSpec; }

const char* jax_draws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
