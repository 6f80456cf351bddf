// The collapsed Gibbs sweep's random draws, counter-based: the uniforms of
// the z draws and the Beta draw of q, each a pure function of the chain's
// key, the sweep index (read from the device) and the draw's own indices.
//
// Not a Pallas kernel: the port's counterpart of the reference's jax.random
// draws in bammmotif2_tpu/refinement/gibbs.py::gibbs_step_multi, a key split
// each sweep and folded with the row index for z (gibbs.py:197-205), a
// second split for q's jax.random.beta (gibbs.py:252-257).  It does not give
// jax.random's bits.  Because the sweep index is read from device memory, a
// captured sweep replayed by a CUDA graph WHILE node draws anew each sweep
// with no host involvement (refinement/graphs.py::Loop.run_while).
// The plain versions are ops/cuda_draws.py::uniforms_ref and beta_ref.
//
// Streams (Philox4x32-10, philox.cuh; key = the chain's 64-bit
// chain_seed(seed, index) as (low, high) words):
//   z uniform of chain m, global row n, sweep i:
//     counter (n, i, 0, 0); u = (x0 >> 8) * 2^-24, exact in f32, in [0, 1)
//   gamma candidate j of sweep i, for X (tag 1) or Y (tag 2):
//     counter (j, i, tag, 0)
// The chain is in the key, so the fourth word stays 0: a stack position
// there would make a stacked chain differ from its solo run.  Keying z by
// the global row keeps a row's draw independent of the shard layout and of
// appended empty rows, as the reference's fold_in(sub, n) does.
//
// Contract (row-major, contiguous):
//   keys   int64 [M, 2]  each chain's key words, each in [0, 2^32)
//   sweep  int64 [1]     the sweep index i (its low 32 bits are used)
//   cgs_uniforms: row0 (host), n -> u f32 [M, n], rows row0 .. row0+n-1
//   cgs_beta: a, b f32 [M] (shapes, both >= 1), lo, hi -> q f32 [M] =
//     clip(X / (X + Y), lo, hi), X ~ Gamma(a), Y ~ Gamma(b); cand int32
//     [M, 2] (optional) the accepted candidate index of X and of Y.  A
//     shape below 1 (or NaN) gives q = NaN; the plain version raises.
//
// Gamma(s) for s >= 1 by Marsaglia and Tsang (ACM TOMS 26(3), 2000):
// d = s - 1/3, c = 1 / sqrt(9 d); candidate j's normal z is Box-Muller on
// its words x0, x1 (u1 = (x0 + 1) 2^-32 in (0, 1], u2 = x1 2^-32,
// z = sqrt(-2 log u1) cos(2 pi u2)), its acceptance uniform ua = x2 2^-32;
// v = (1 + c z)^3, accepted iff v > 0 and (ua < 1 - 0.0331 z^4 or
// log ua < z^2 / 2 + d (1 - v + log v)); the draw is d v.  The first
// accepted of candidates 0 .. kBetaCap-1 wins.  Here a = n_occ + 1 and b =
// n_real - n_occ + 1 are >= 1, so no boost for shapes below 1 is needed.
// A candidate is rejected with probability about 0.05 at s = 1, less above
// (0.027 at 1.5, 0.011 at 3: the plain version over 2 10^4 chains), so all
// 64 fail with probability about 0.05^64 ~ 1e-83; then the draw is d (the
// candidate at z = 0) and cand = 64.
// All in float64.  The card's log, cos and sqrt, and the compiler's fused
// multiply-adds, may differ from the CPU's by an ulp: a candidate at the
// acceptance boundary can flip, which chip_smoke.py counts.
//
// What bounds it: nothing on this card.  cgs_uniforms writes M n floats
// (640 KB at M = 16, n = 10^4: 0.2 µs at 3.35 TB/s) after ten Philox
// rounds a row; cgs_beta is M blocks of two warps.  Each is one launch
// whatever M, a graph node of a few µs in the sweep.

#include <cmath>

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kBetaCap = 64;  // gamma candidates a draw: two rounds of a warp
constexpr double kInv32 = 1.0 / 4294967296.0;  // 2^-32
constexpr float kInv24 = 1.0f / 16777216.0f;   // 2^-24
constexpr double kTwoPi = 2.0 * 3.141592653589793;

__device__ __forceinline__ uint2 chain_key(const long long* keys, int m) {
  return make_uint2((unsigned)keys[2 * m], (unsigned)keys[2 * m + 1]);
}

__global__ void __launch_bounds__(kThreads)
cgs_uniforms_kernel(const long long* __restrict__ keys, const long long* __restrict__ sweep,
                    float* __restrict__ u, long long row0, int n) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const int m = blockIdx.y;
  const uint4 x = philox4x32_10(make_uint4((unsigned)(row0 + r), (unsigned)*sweep, 0u, 0u),
                                chain_key(keys, m));
  u[(size_t)m * n + r] = (float)(x.x >> 8) * kInv24;
}

// Marsaglia-Tsang candidate from the words x: whether it is accepted, and
// its value d v in *out.
__device__ __forceinline__ bool gamma_candidate(double d, double c, uint4 x, double* out) {
  const double u1 = ((double)x.x + 1.0) * kInv32;
  const double u2 = (double)x.y * kInv32;
  const double ua = (double)x.z * kInv32;
  const double z = sqrt(-2.0 * log(u1)) * cos(kTwoPi * u2);
  const double t = 1.0 + c * z;
  const double v = t * t * t;
  *out = d * v;
  if (!(v > 0.0)) return false;
  const double z2 = z * z;
  if (ua < 1.0 - 0.0331 * (z2 * z2)) return true;
  return log(ua) < 0.5 * z2 + d * (1.0 - v + log(v));
}

// Block m draws chain m's q: warp 0 Gamma(a[m]), warp 1 Gamma(b[m]); lane
// l tries candidate j0 + l, and the lowest accepted index wins, as trying
// them in order would.
__global__ void __launch_bounds__(64)
cgs_beta_kernel(const long long* __restrict__ keys, const long long* __restrict__ sweep,
                const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ q,
                int* __restrict__ cand, float lo, float hi) {
  __shared__ double g[2];
  __shared__ int first[2];
  const int m = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const double shape = warp == 0 ? (double)a[m] : (double)b[m];
  const double d = shape - 1.0 / 3.0;
  const double c = 1.0 / sqrt(9.0 * d);
  const uint2 key = chain_key(keys, m);
  const unsigned i = (unsigned)*sweep;
  double value = d;  // at the cap
  int index = kBetaCap;
  for (int j0 = 0; j0 < kBetaCap; j0 += 32) {
    double y;
    const bool ok = gamma_candidate(
        d, c, philox4x32_10(make_uint4((unsigned)(j0 + lane), i, 1u + warp, 0u), key), &y);
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (ballot) {  // the same for the whole warp
      const int src = __ffs(ballot) - 1;
      value = __shfl_sync(0xffffffffu, y, src);
      index = j0 + src;
      break;
    }
  }
  if (lane == 0) {
    g[warp] = value;
    first[warp] = index;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool valid = a[m] >= 1.0f && b[m] >= 1.0f;
    const float r = fminf(fmaxf((float)(g[0] / (g[0] + g[1])), lo), hi);
    q[m] = valid ? r : NAN;
    if (cand != nullptr) {
      cand[2 * m] = first[0];
      cand[2 * m + 1] = first[1];
    }
  }
}

}  // namespace

extern "C" {

// Launches cgs_uniforms_kernel on `stream` of `device`: u [M, n], one
// launch.  1 <= M <= 65535, n >= 1.  Returns a cudaError_t (0 = success).
int cgs_uniforms_launch(const long long* keys, const long long* sweep, float* u, long long row0,
                        int n, int M, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const dim3 grid((n + kThreads - 1) / kThreads, M);
  cgs_uniforms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(keys, sweep, u,
                                                                               row0, n);
  return (int)cudaGetLastError();
}

// Launches cgs_beta_kernel on `stream` of `device`: q [M] and, where cand
// is not null, the candidate indices [M, 2]; one launch of M blocks.
// Returns a cudaError_t (0 = success).
int cgs_beta_launch(const long long* keys, const long long* sweep, const float* a,
                    const float* b, float* q, int* cand, float lo, float hi, int M, int device,
                    void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  cgs_beta_kernel<<<M, 64, 0, static_cast<cudaStream_t>(stream)>>>(keys, sweep, a, b, q, cand,
                                                                   lo, hi);
  return (int)cudaGetLastError();
}

const char* cgs_draws_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
