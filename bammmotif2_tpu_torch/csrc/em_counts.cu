// Fused E+M data pass of one ZOOPS EM iteration, for M seeds at once.
//
// Replaces the Pallas TPU kernel bammmotif2_tpu/ops/pallas_em.py::_kernel
// (reached through em_counts_multi / em_counts).  Same contract, not the same
// layout: the TPU kernel turns every gather into a one-hot matmul (with bf16
// residual splits, a hi/lo digit split and lane concatenation) because the
// TPU has no fast gather.  Hopper has one, so this kernel gathers directly.
//
// Contract (all row-major, contiguous):
//   cidx   int32 [S, N, L]   combined-LUT rows in [0, R]; R = sentinel
//   lens   int32 [N]         window i of sequence n is valid iff i + W <= len
//   s_flat f32   [M, R+1, W] log-odds LUTs, sentinel row R is zero
//   q      f32   [M]         ZOOPS occurrence priors
// outputs:
//   C      f32   [M, R+1, W] fractional counts C[m, cidx[s,n,i+j], j] += r;
//                            the sentinel row keeps its mass (the EM step
//                            takes q from column 0 summed over all R+1 rows)
//   logz   f32   [M, N]      per-sequence ZOOPS log marginal log Z_n
//   ll     f32   [M]         sum_n log Z_n, reduced in a fixed order
// with, per sequence n and seed m (escore.zoops_posterior):
//   score(s,i) = sum_j s_flat[m, cidx[s,n,i+j], j]
//   log_prior  = log q - log(S * nwin_n)     (NEG_INF when nwin_n == 0)
//   log Z_n    = logsumexp({log(1-q)} U {score + log_prior})
//   r(s,i)     = exp(score + log_prior - log Z_n)
// A row shorter than W contributes log(1-q) to ll and nothing to C.
//
// What bounds it on this card: per window, W dependent LUT gathers (scored
// twice) and W fractional-count atomics.  Both are memory- and
// latency-bound, with no arithmetic to speak of; the atomics collide
// wherever many windows share a k-mer at the same offset.
//
// What the design does about it:
//   * one block per sequence at a time (grid-stride over N): the block
//     reduces log Z_n in registers + shuffles, so the posterior needs no
//     trip through device memory;
//   * pass 1 scores each window and keeps an online (max, sum exp) pair,
//     pass 2 re-scores it and scatters r.  Recomputing the W gathers costs
//     less than it saves: no score buffer, hence no limit on L;
//   * cidx and the LUT are read through the read-only path (__ldg), so the
//     W overlapping cidx reads of neighbouring windows and the small LUT
//     hit L1;
//   * counts are privatised per block in shared memory (the wrapper picks
//     how many seeds share one block's copy) and flushed with one global
//     atomicAdd per non-zero entry at the end, so the card's threads do not
//     all serialise on the same (R+1)*W addresses.  Where one seed's counts
//     do not fit in shared memory (A=4, K=5 is 262 KB), the kernel adds
//     every responsibility to global memory directly;
//   * global counts are float64 (Cd; fp64 global atomics are native on
//     sm_90) and a third kernel rounds them into C once.  An f32 flush of
//     ~800 block partials into totals near 8e3 left 3.7e-3 of error, which
//     slowly converging EM amplifies past 1e-4 in the written model;
//   * ll comes from a second, fixed-order kernel (double accumulation), so
//     it does not depend on block scheduling.
// The float atomics add in an order that varies from run to run, so C is
// reproducible only to rounding.  expf/logf/log1pf are IEEE f32 (the build
// does not use --use_fast_math).

#include "common.cuh"

namespace {

__device__ __forceinline__ float window_score(const int* __restrict__ row,
                                              const float* __restrict__ lut, int W) {
  float sc = 0.f;  // j order as in escore.window_scores
  for (int j = 0; j < W; ++j) sc += __ldg(lut + (size_t)__ldg(row + j) * W + j);
  return sc;
}

__global__ void __launch_bounds__(kThreads)
em_counts_kernel(const int* __restrict__ cidx, const int* __restrict__ lens,
                 const float* __restrict__ s_flat, const float* __restrict__ q,
                 float* __restrict__ C, double* __restrict__ Cd,
                 float* __restrict__ logz,
                 int S, int N, int L, int W, int R1, int M,
                 int seeds_per_block, int smem_counts) {
  extern __shared__ float smem[];
  float* red = smem;               // 2 * kWarps
  float* Cs = smem + 2 * kWarps;   // seeds_per_block * R1 * W when smem_counts
                                   // (else every r goes to Cd directly)
  const int RW = R1 * W;
  const int m0 = blockIdx.y * seeds_per_block;
  const int m1 = min(M, m0 + seeds_per_block);
  if (smem_counts) {
    for (int k = threadIdx.x; k < (m1 - m0) * RW; k += blockDim.x) Cs[k] = 0.f;
    __syncthreads();
  }

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const int len = min(max(__ldg(lens + n), 0), L);
    const int nwin = max(len - W + 1, 0);
    const int total = S * nwin;
    for (int m = m0; m < m1; ++m) {
      const float* lut = s_flat + (size_t)m * RW;
      const float qm = __ldg(q + m);
      const float log_r0 = log1pf(-qm);
      const float log_prior = total > 0 ? logf(qm) - logf((float)total) : kNegInf;

      // pass 1: log Z_n = logsumexp over the absent term and every window
      float mx = kNegInf, se = 0.f;
      for (int w = threadIdx.x; w < total; w += blockDim.x) {
        const int s = w / nwin, i = w - s * nwin;
        const int* row = cidx + ((size_t)s * N + n) * L + i;
        const float lw = window_score(row, lut, W) + log_prior;
        if (lw > mx) {
          se = se * expf(mx - lw) + 1.f;
          mx = lw;
        } else {
          se += expf(lw - mx);
        }
      }
      block_lse(mx, se, red);
      lse_merge(mx, se, log_r0, 1.f);
      const float lz = mx + logf(se);
      if (threadIdx.x == 0) logz[(size_t)m * N + n] = lz;

      // pass 2: responsibilities scattered into the count rows
      float* Cm = Cs + (size_t)(m - m0) * RW;
      double* Cdm = Cd + (size_t)m * RW;
      for (int w = threadIdx.x; w < total; w += blockDim.x) {
        const int s = w / nwin, i = w - s * nwin;
        const int* row = cidx + ((size_t)s * N + n) * L + i;
        const float r = expf(window_score(row, lut, W) + log_prior - lz);
        for (int j = 0; j < W; ++j) {
          const size_t k = (size_t)__ldg(row + j) * W + j;
          if (smem_counts) atomicAdd(Cm + k, r);
          else atomicAdd(Cdm + k, (double)r);
        }
      }
    }
  }

  if (smem_counts) flush_counts(Cs, Cd + (size_t)m0 * RW, (m1 - m0) * RW);
}

}  // namespace

extern "C" {

// Launches the kernels on `stream`.  Cd ([M, R1, W] f64) must be zeroed by
// the caller; C and logz are written in full.
// Returns a cudaError_t (0 = success) from the launch checks.
int em_counts_launch(const int* cidx, const int* lens, const float* s_flat,
                     const float* q, float* C, double* Cd, float* logz, float* ll,
                     int S, int N, int L, int W, int R1, int M,
                     int seeds_per_block, int smem_counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (2 * kWarps +
      (smem_counts ? (size_t)seeds_per_block * R1 * W : 0));
  const int chunks = (M + seeds_per_block - 1) / seeds_per_block;
  int gx = 1, sms = 0;
  cudaError_t err = resident_grid(em_counts_kernel, smem, N, chunks, &gx);
  if (err != cudaSuccess) return (int)err;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  em_counts_kernel<<<dim3(gx, chunks), kThreads, smem, st>>>(
      cidx, lens, s_flat, q, C, Cd, logz, S, N, L, W, R1, M, seeds_per_block, smem_counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  round_counts_kernel<<<sms * 4, kThreads, 0, st>>>(Cd, C, (size_t)M * R1 * W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ll_reduce_kernel<<<M, kThreads, 0, st>>>(logz, N, ll);
  return (int)cudaGetLastError();
}

const char* em_counts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
