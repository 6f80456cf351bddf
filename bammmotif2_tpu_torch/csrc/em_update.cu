// One EM iteration's model update and loop-state step, for M seeds at once:
// all that follows em_counts_kernel's data pass inside the EM loop's body
// (refinement/multi.py::FusedStep), as one launch.
//
// It does the work of a chain of PyTorch launches (multi.py's update and
// advance, models/motif.py's counts_from_combined, update_v and
// log_odds_lut) and of em.cuh's rounding and ll kernels: some 70 device
// operations an iteration on tables of a few thousand floats, each a
// microsecond of work or less and a graph node boundary of idle device.
// Where it runs (multi.py::group_step): the kernel path on one CUDA device
// with no mesh; the CPU, --no-pallas and a mesh (whose all-reduce falls
// between the pass and the update) keep the PyTorch chain, which the tests
// hold this kernel to.
//
// Contract (row-major, contiguous; R = num_rows(A, K), R1 = R + 1;
// off[k] = A + ... + A^k, the first row of order k):
//   Cd      f64 [M, R1, W]  the pass's counts; read, then set to zero for the
//                           next pass
//   logz    f32 [M, N]      the pass's per-sequence log marginals
//   running bool []         the loop's condition at the iteration's start
//   eps     f32 []
//   alphas  f32 [M, K+1, W], f_bg f32 [A], bg_flat f32 [R]
// the loop state, updated in place for each active seed (common.cuh's
// seed_active: running and vds[m] >= eps, the reference's per-seed where):
//   v       f32 [M, R, W]   the conditionals of every order (combined_v)
//   s_flat  f32 [M, R1, W]  the log-odds LUT of v; the zero sentinel row R is
//                           never written
//   q, lls, vds f32 [M], its int32 [M], hist f32 [hist_slots, M]
// and, where given (tests), C f32 [M, R1, W]: the rounded counts of every
// seed.
//
// The math, per seed, in float32 op for op as models/motif.py writes it (the
// products and sums as __fmul_rn / __fadd_rn, so nvcc contracts none of them
// into an FMA that the PyTorch chain does not make):
//   C        = (float)Cd                                 (round_counts_kernel)
//   ll       = (float)row_sum(logz[m]) - (float)n_pad * log1pf(-q)
//              (ll_reduce_kernel's sum, then the pad rows' log(1 - q) each)
//   n[K]     = C[order K];  n[k][y] = C[order k][y] + sum_a n[k+1][a A^(k+1) + y]
//   v0[a, j] = (n0[a, j] + alpha0[j] f_bg[a]) / (sum_b n0[b, j] + alpha0[j])
//   vk[y, j] = (nk[y, j] + alphak[j] v(k-1)[y % A^k, j])
//              / (sum_b nk[(y / A) A + b, j] + alphak[j])
//   q'       = clamp((a0 + a1 + a2 + a3) * (1 / n_real), 1e-4, 1 - 1e-4)
//              with optimize_q, else q; a_i = sum of C[r, 0] over the rows
//              r = i mod 4 in turn, added left to right: the order PyTorch's
//              C.sum(dim=1) takes where it gives an output one thread (c4's
//              groups: M <= 4, R1 = 85), and PyTorch divides by a scalar as
//              a product with its reciprocal, so q is bit-equal there
//   vd       = (float)(sum over every order of |v' - v|)  (the sum in double)
//   vd_eff   = min(vd, |ll - lls|), NaN where either is
//   s_flat[r, j] = logf(v'[r, j]) - logf(bg_flat[r])
//   hist[min(its / hist_stride, hist_slots - 1), m] = ll (hist_slots > 0);
//   q, lls, vds = q', ll, vd_eff;  its += 1
// A frozen seed only has its Cd zeroed (and C written): its v, LUT and state
// stay.  In the loop B1's pass gives a frozen seed no blocks, so its Cd is
// zero already.  Sums over a and b run in the order written, PyTorch's over four
// rows; logf and log1pf are IEEE (no --use_fast_math).
//
// What bounds it: latency, not bytes or operations.  A block a seed works
// through its tables in phases (the counts' load, the ll and q sums, K
// marginalisation steps, K+1 update steps, the vd sum), each ended by a
// barrier; at c4's groups (A=4, K=2, W=12: 1,008 entries a table) a phase is
// four entries a thread.  The count table sits in shared memory where it
// fits (SMEM_TABLE bytes: [R1, W] floats; every table up to K=3 at W=30 and
// K=4 at W=8); larger ones (A=4, K=4 at W=12 and up, K=5) go through `work`
// in device memory, which the barriers make visible across the block too.

#include "common.cuh"

namespace {

// Bytes of dynamic shared memory a block may take without an opt-in, less
// the reduction's doubles (ops/cuda_update.py::SMEM_TABLE).
constexpr int kSmemTable = 48 * 1024 - kThreads * (int)sizeof(double);

__device__ __forceinline__ int ipow(int a, int e) {
  int x = 1;
  for (int i = 0; i < e; ++i) x *= a;
  return x;
}

// The first combined row of order k: A + A^2 + ... + A^k.
__device__ __forceinline__ int order_offset(int A, int k) {
  int off = 0;
  for (int i = 1; i <= k; ++i) off += ipow(A, i);
  return off;
}

// NaN where a or b is, else the smaller (torch.minimum).
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) || isnan(b) ? a + b : fminf(a, b);
}

// x clamped to [lo, hi], NaN kept (torch.clamp).
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

__global__ void __launch_bounds__(kThreads)
em_update_kernel(double* __restrict__ Cd, const float* __restrict__ logz, float* __restrict__ C,
                 float* __restrict__ v, float* __restrict__ s_flat, float* __restrict__ q,
                 float* __restrict__ lls, float* __restrict__ vds, int* __restrict__ its,
                 float* __restrict__ hist, const bool* __restrict__ running,
                 const float* __restrict__ eps, const float* __restrict__ alphas,
                 const float* __restrict__ f_bg, const float* __restrict__ bg_flat,
                 float* __restrict__ work, int A, int K, int W, int N, int n_pad, float n_real,
                 int optimize_q, int hist_slots, int hist_stride) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double part[kThreads];
  const int m = blockIdx.x, M = gridDim.x;
  const int R = order_offset(A, K + 1), RW = R * W, R1W = RW + W;
  double* Cdm = Cd + (size_t)m * R1W;
  // every thread reads the seed's state before thread 0 writes it (the
  // barriers of the sums lie between)
  const bool active = seed_active(running, vds, eps, m);
  const float q_m = q[m], lls_m = lls[m];
  const int its_m = its[m];
  float* n = work != nullptr ? work + (size_t)m * R1W : smem;  // [R1, W] counts
  __shared__ float q_part[4];

  // the counts: rounded, and zeroed for the next pass
  for (int k = threadIdx.x; k < R1W; k += kThreads) {
    const float c = (float)Cdm[k];
    Cdm[k] = 0.0;
    if (C != nullptr) C[(size_t)m * R1W + k] = c;
    if (active) n[k] = c;
  }
  if (!active) return;  // the same for the whole block

  const float ll_sum = (float)row_sum(logz + (size_t)m * N, N, part);  // publishes n
  const float ll = __fsub_rn(ll_sum, __fmul_rn((float)n_pad, log1pf(-q_m)));
  if (threadIdx.x < 4) {  // q's column, before the orders below overwrite it
    float a = 0.f;
    for (int r = threadIdx.x; r <= R; r += 4) a = __fadd_rn(a, n[r * W]);
    q_part[threadIdx.x] = a;
  }
  __syncthreads();

  // per-order counts, from order K - 1 down: order k's direct counts plus
  // order k+1's marginal over its oldest base
  for (int k = K - 1; k >= 0; --k) {
    const int Ak = ipow(A, k + 1), lo = order_offset(A, k), hi = order_offset(A, k + 1);
    for (int t = threadIdx.x; t < Ak * W; t += kThreads) {
      const int y = t / W, j = t - y * W;
      float s = n[(hi + y) * W + j];
      for (int a = 1; a < A; ++a) s = __fadd_rn(s, n[(hi + a * Ak + y) * W + j]);
      n[(lo + y) * W + j] = __fadd_rn(n[(lo + y) * W + j], s);
    }
    __syncthreads();
  }

  // the interpolated estimator, order by order (order k reads order k-1's
  // new conditionals), in place in v, with the LUT and the L1 change
  const float* alpha = alphas + (size_t)m * (K + 1) * W;
  float* vm = v + (size_t)m * RW;
  float* sm = s_flat + (size_t)m * R1W;
  double vd_acc = 0.0;
  for (int k = 0; k <= K; ++k) {
    const int Ak = ipow(A, k + 1), lo = order_offset(A, k);
    const int below = k > 0 ? order_offset(A, k - 1) : 0;  // order k-1's first row
    for (int t = threadIdx.x; t < Ak * W; t += kThreads) {
      const int y = t / W, j = t - y * W, x = y / A;
      const float ak = alpha[k * W + j];
      float ctx = n[(lo + x * A) * W + j];
      for (int b = 1; b < A; ++b) ctx = __fadd_rn(ctx, n[(lo + x * A + b) * W + j]);
      const float lower = k == 0 ? f_bg[y] : vm[(below + y % (Ak / A)) * W + j];
      const float nv = __fdiv_rn(__fadd_rn(n[(lo + y) * W + j], __fmul_rn(ak, lower)),
                                 __fadd_rn(ctx, ak));
      const int at = (lo + y) * W + j;
      vd_acc += (double)fabsf(__fsub_rn(nv, vm[at]));
      vm[at] = nv;
      sm[at] = __fsub_rn(logf(nv), logf(bg_flat[lo + y]));
    }
    __syncthreads();
  }
  const float vd = (float)block_sum(vd_acc, part);

  if (threadIdx.x == 0) {
    const float q_sum = __fadd_rn(__fadd_rn(__fadd_rn(q_part[0], q_part[1]), q_part[2]),
                                  q_part[3]);
    if (optimize_q)
      q[m] = clamp_nan(__fmul_rn(q_sum, __fdiv_rn(1.f, n_real)), 1e-4f, (float)(1.0 - 1e-4));
    lls[m] = ll;
    vds[m] = nan_min(vd, fabsf(__fsub_rn(ll, lls_m)));
    if (hist_slots > 0) hist[(size_t)min(its_m / hist_stride, hist_slots - 1) * M + m] = ll;
    its[m] = its_m + 1;
  }
}

}  // namespace

extern "C" {

// Launches em_update_kernel on `stream`, a block a seed.  `work` ([M, R1, W]
// f32, device memory) holds the count tables where R1 * W floats exceed
// kSmemTable bytes, and must be null where they fit; C may be null.
// Returns a cudaError_t (0 = success).
int em_update_launch(double* Cd, const float* logz, float* C, float* v, float* s_flat, float* q,
                     float* lls, float* vds, int* its, float* hist, const bool* running,
                     const float* eps, const float* alphas, const float* f_bg,
                     const float* bg_flat, float* work, int M, int A, int K, int W, int N,
                     int n_pad, float n_real, int optimize_q, int hist_slots, int hist_stride,
                     void* stream) {
  if (M < 1 || A < 2 || K < 0 || W < 1 || N < 0 || hist_stride < 1 || hist_slots < 0)
    return (int)cudaErrorInvalidValue;
  long long R = 0, Ak = 1;
  for (int k = 0; k <= K; ++k) R += (Ak *= A);
  if (R * (W + 1) > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  const size_t table = sizeof(float) * (size_t)((R + 1) * W);
  if ((work == nullptr) != (table <= (size_t)kSmemTable)) return (int)cudaErrorInvalidValue;
  em_update_kernel<<<M, kThreads, work == nullptr ? table : 0,
                     static_cast<cudaStream_t>(stream)>>>(
      Cd, logz, C, v, s_flat, q, lls, vds, its, hist, running, eps, alphas, f_bg, bg_flat, work,
      A, K, W, N, n_pad, n_real, optimize_q, hist_slots, hist_stride);
  return (int)cudaGetLastError();
}

const char* em_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
