// Counts from external responsibilities, for M seeds at once.
//
// Replaces the Pallas TPU kernel bammmotif2_tpu/ops/pallas_em.py::_counts_kernel
// (reached through counts_from_r_multi / counts_from_r): the count pass of a
// collapsed Gibbs sweep, whose 0/1 occupancy comes from the sampler instead
// of an in-kernel posterior.  Same contract, not the same layout: the TPU
// kernel rolls r into a (B, M*W, SL) scratch and counts through one-hot
// matmuls with hi/lo digit splits because the TPU has no fast scatter.
// Hopper has shared-memory and global atomics, so this kernel adds directly.
//
// Contract (all row-major, contiguous):
//   r      f32   [M, S, N, L]  responsibilities; only window starts
//                              i < L - W + 1 are read
//   cidx   int32 [S, N, L]     combined-LUT rows in [0, R]; R = sentinel
// output:
//   C      f32   [M, R+1, W]   C[m, cidx[s,n,i+j], j] += r[m,s,n,i] over
//                              s, n, i < L-W+1, j < W; the sentinel row keeps
//                              its mass
// There is no `lens`: mass the caller puts on a window past a row's end
// lands in whatever row cidx holds there (the sentinel, for padding),
// exactly as escore.mstep_counts does.  cidx[i+j] is never read past L.
//
// What bounds it on this card: reading r densely (M*S*N*L*4 bytes, 16 MB a
// seed at 10k x 200 bp), and W atomics per non-zero responsibility.  For a
// Gibbs sweep r holds at most one non-zero per (m, n), so the atomics are
// few; for fractional r (the contract allows it) they are W per window, as
// in the E+M kernel.
//
// What the design does about it:
//   * one warp per (s, n) row at a time (grid-stride over rows), lanes over
//     window starts, so r and cidx are read coalesced and no index is
//     divided;
//   * zero responsibilities are skipped before any cidx read or atomic;
//   * counts are privatised per block in shared memory (the wrapper picks
//     how many seeds share one block's copy) and flushed with one f64 global
//     atomicAdd per non-zero entry, so windows that share a k-mer at one
//     offset (a planted motif) do not serialise on one global address.
//     Where one seed's counts do not fit (A=4, K=5 is 262 KB), every
//     responsibility goes to the f64 global counts directly;
//   * global counts are float64 (Cd) and a second kernel rounds them into C
//     once: integer counts are exact, and fractional counts do not repeat
//     the E+M kernel's f32-flush error (3.7e-3 at |C| ~ 8e3).
// Shared-memory partials are f32, exact for 0/1 r up to 2^24 per cell.  The
// atomics add in an order that varies from run to run, so fractional C is
// reproducible only to rounding; 0/1 C is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
counts_kernel(const float* __restrict__ r, const int* __restrict__ cidx,
              double* __restrict__ Cd, int rows, int L, int W, int R1, int M,
              int seeds_per_block, int smem_counts) {
  extern __shared__ float Cs[];  // seeds_per_block * R1 * W when smem_counts
  const int RW = R1 * W;
  const int m0 = blockIdx.y * seeds_per_block;
  const int m1 = min(M, m0 + seeds_per_block);
  if (smem_counts) {
    for (int k = threadIdx.x; k < (m1 - m0) * RW; k += blockDim.x) Cs[k] = 0.f;
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int nwin = L - W + 1;
  const size_t plane = (size_t)rows * L;  // one seed's r
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kWarps) {
    const int* crow = cidx + (size_t)row * L;
    for (int i = lane; i < nwin; i += 32) {
      for (int m = m0; m < m1; ++m) {
        const float v = __ldg(r + (size_t)m * plane + (size_t)row * L + i);
        if (v == 0.f) continue;
        if (smem_counts) {
          float* Cm = Cs + (size_t)(m - m0) * RW;
          for (int j = 0; j < W; ++j) atomicAdd(Cm + (size_t)__ldg(crow + i + j) * W + j, v);
        } else {
          double* Cdm = Cd + (size_t)m * RW;
          for (int j = 0; j < W; ++j)
            atomicAdd(Cdm + (size_t)__ldg(crow + i + j) * W + j, (double)v);
        }
      }
    }
  }

  if (smem_counts) {
    __syncthreads();
    double* Cg = Cd + (size_t)m0 * RW;
    for (int k = threadIdx.x; k < (m1 - m0) * RW; k += blockDim.x) {
      const float v = Cs[k];
      if (v != 0.f) atomicAdd(Cg + k, (double)v);
    }
  }
}

// C = (float)Cd.
__global__ void round_counts_kernel(const double* __restrict__ Cd, float* __restrict__ C,
                                    size_t n) {
  for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < n;
       k += (size_t)gridDim.x * blockDim.x)
    C[k] = (float)Cd[k];
}

}  // namespace

extern "C" {

// Launches the kernels on `stream`.  Cd ([M, R1, W] f64) must be zeroed by
// the caller; C is written in full.  rows = S * N.
// Returns a cudaError_t (0 = success) from the launch checks.
int counts_from_r_launch(const float* r, const int* cidx, float* C, double* Cd,
                         int rows, int L, int W, int R1, int M,
                         int seeds_per_block, int smem_counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_counts ? sizeof(float) * (size_t)seeds_per_block * R1 * W : 0;
  cudaError_t err = cudaFuncSetAttribute(
      counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, counts_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  const int chunks = (M + seeds_per_block - 1) / seeds_per_block;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  int gx = (resident + chunks - 1) / chunks;
  const int row_blocks = (rows + kWarps - 1) / kWarps;
  gx = row_blocks < gx ? row_blocks : gx;
  gx = gx < 1 ? 1 : gx;
  counts_kernel<<<dim3(gx, chunks), kThreads, smem, st>>>(
      r, cidx, Cd, rows, L, W, R1, M, seeds_per_block, smem_counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  round_counts_kernel<<<sms * 4, kThreads, 0, st>>>(Cd, C, (size_t)M * R1 * W);
  return (int)cudaGetLastError();
}

const char* counts_from_r_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
