// Device helpers, reductions and launch arithmetic shared by the kernels of
// csrc/ (em_counts.cu, window_scores.cu, counts_from_r.cu, flat.cu).  Each
// source keeps its own __global__ passes and C entry points; ops/_build.py
// rebuilds every library when this header changes.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // escore.NEG_INF

// (m, s) <- logsumexp merge of (m, s) and (m2, s2); s holds sum exp(x - m)
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// Block-wide (max, sum exp) reduction; every thread gets the same result.
// red holds 2 * kWarps floats of shared memory.
__device__ __forceinline__ void block_lse(float& m, float& s, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = m;
    red[kWarps + warp] = s;
  }
  __syncthreads();
  m = red[0];
  s = red[kWarps];
  for (int w = 1; w < kWarps; ++w) lse_merge(m, s, red[w], red[kWarps + w]);
  __syncthreads();  // red is reused by the next sequence
}

// Warp-wide (max, sum exp) reduction by shuffles; every lane gets the result.
__device__ __forceinline__ void warp_lse(float& m, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
}

// Adds a block's n shared-memory partial counts Cs into the f64 global
// table Cg, one atomic per non-zero entry.  Called by every thread.
__device__ __forceinline__ void flush_counts(const float* Cs, double* Cg, int n) {
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float v = Cs[k];
    if (v != 0.f) atomicAdd(Cg + k, (double)v);
  }
}

// C = (float)Cd.
__global__ void round_counts_kernel(const double* __restrict__ Cd, float* __restrict__ C,
                                    size_t n) {
  for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < n;
       k += (size_t)gridDim.x * blockDim.x)
    C[k] = (float)Cd[k];
}

// ll[m] = sum_n logz[m, n]: one block per seed, fixed order, double sums.
__global__ void __launch_bounds__(kThreads)
ll_reduce_kernel(const float* __restrict__ logz, int N, float* __restrict__ ll) {
  __shared__ double part[kThreads];
  const float* row = logz + (size_t)blockIdx.x * N;
  double acc = 0.0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) acc += (double)row[n];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[threadIdx.x] += part[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) ll[blockIdx.x] = (float)part[0];
}

// The card's streaming-multiprocessor count.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Grid x for a persistent launch of `kern` at `smem` bytes of dynamic shared
// memory whose grid y holds `chunks` seed chunks: the resident block count
// split over the chunks, capped by the work items available, at least 1.
// Also opts `kern` into `smem` bytes.
template <typename Kern>
cudaError_t resident_grid(Kern kern, size_t smem, long long work, int chunks, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  long long g = (resident + chunks - 1) / chunks;
  g = work < g ? work : g;
  *grid = (int)(g < 1 ? 1 : g);
  return cudaSuccess;
}

}  // namespace
