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
// What bounds it on this card, and what the design does about it: see
// counts.cuh, whose streaming pass this kernel runs with grid y over the
// seeds: block (x, m) streams its share of seed m's plane r[m] into a private
// shared-memory table (one seed's [R1, W] f32, 4 KB at K=2, W=12), and the
// last block of seed m writes C[m].  Where one seed's table does not fit
// (A=4, K=5 is 262 KB) every responsibility adds to the f64 accumulator
// directly.

#include "counts.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
counts_kernel(const float* __restrict__ r, const int* __restrict__ cidx, float* __restrict__ C,
              double* __restrict__ acc, unsigned* __restrict__ tickets, long long plane, int L,
              int W, int R1, int smem_counts) {
  extern __shared__ float Cs[];  // R1 * W when smem_counts
  const int RW = R1 * W;
  const int m = blockIdx.y;
  if (smem_counts) {
    for (int k = threadIdx.x; k < RW; k += kThreads) Cs[k] = 0.f;
    __syncthreads();
  }
  counts_pass(r + m * plane, cidx, plane, L, W, RW, CombinedRows{}, smem_counts ? Cs : nullptr,
              acc + (size_t)m * RW, tickets + m, C + (size_t)m * RW);
}

}  // namespace

extern "C" {

// Launches counts_kernel on `stream` of `device`: one kernel, no host query
// after the first call at a shared-memory size.  acc ([M, R1, W] f64) and
// tickets ([M] u32) must be zero, and are left zero; C is written in full.
// plane = S * N * L > 0, 1 <= M <= 65535.
// Returns a cudaError_t (0 = success) from the launch checks.
int counts_from_r_launch(const float* r, const int* cidx, float* C, double* acc,
                         unsigned* tickets, long long plane, int L, int W, int R1, int M,
                         int smem_counts, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const size_t smem = smem_counts ? sizeof(float) * (size_t)R1 * W : 0;
  long long resident = 0;
  cudaError_t err = resident_blocks(counts_kernel, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  const int gx = counts_grid(resident, M, plane);
  counts_kernel<<<dim3(gx, M), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, cidx, C, acc, tickets, plane, L, W, R1, smem_counts);
  return (int)cudaGetLastError();
}

const char* counts_from_r_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
