// Window log-odds scores for M seeds at once, no posterior.
//
// Replaces the Pallas TPU kernel
// bammmotif2_tpu/ops/pallas_em.py::_scores_kernel (reached through
// window_scores_multi / window_scores).  Same contract, not the same layout:
// the TPU kernel forms every gather as a one-hot matmul against a
// term-stacked LUT and shifts lanes with pltpu.roll, because the TPU has no
// fast gather.  Hopper has one, so this kernel gathers directly.
//
// Contract (all row-major, contiguous):
//   cidx   int32 [S, N, L]   combined-LUT rows in [0, R]; R = sentinel
//   lens   int32 [N]         window i of sequence n is valid iff i + W <= len
//   s_flat f32   [M, R+1, W] log-odds LUTs, sentinel row R is zero
// outputs:
//   scores f32   [M, S, N, L-W+1]  sum_j s_flat[m, cidx[s,n,i+j], j] on
//                                  valid windows, NEG_INF (-1e30) elsewhere
//   mask   bool  [N, L-W+1]        i + W <= len
// The sum adds j = 0..W-1 in order from 0.f with __fadd_rn (never an FMA),
// as escore.window_scores does: the kernel equals the plain PyTorch version
// bit for bit.  The build does not use --use_fast_math.
//
// What bounds it on this card: bytes in principle.  At BASELINE config 5's
// geometry (100k x 200 bp, S=2, W=12, M=1) one pass reads cidx (160 MB) and
// writes the scores (151 MB): about 0.1 ms at 3.35 TB/s.  In practice the
// SM: W dependent LUT gathers a window and seed from shared memory, and the
// instructions around them.
//
// What the design does about it:
//   * a work item is a group of whole rows of one strand (rows_cap / Lp of
//     them, Lp the power of two >= L + kMargin: 16 rows at L=200), or, for
//     rows longer than that, a tile of windows of one row with its W-1 halo.
//     Either way its codes are one contiguous range of cidx, which one thread
//     hands to the Tensor Memory Accelerator (a bulk copy completing on an
//     mbarrier) while the block scores the item before it;
//   * the block then lays the rows out in shared memory at stride Lp, each
//     shifted so that every run (below) starts on a 16-byte boundary, with
//     zeros around them; a run reads its W + 3 codes as int4, conflict-free.
//     Every seed of the block reads them there;
//   * the LUTs sit in shared memory with rows padded to an odd stride
//     Wp = W | 1 ([R1, Wp], staged once per block: the grid is persistent):
//     lanes that read one column at different codes spread over the 32
//     banks, where [R1, W] at W=12 folded them onto 8;
//   * each thread scores a run of kRun consecutive windows of one row, cut
//     at a 16-byte boundary of the row's output: a full run is one float4
//     store, a row's first and last runs store window by window, and a run's
//     windows outside the row (which read the zeros) are dropped.  For the
//     common widths the width is a template argument: each position's LUT
//     row address is formed once and its columns are read at immediate
//     offsets, so a lookup is one load and one add.  Other widths slide a
//     register window of kRun codes;
//   * NEG_INF on invalid windows and the mask are written in the same loop
//     (the mask by the first seed chunk, strand 0);
//   * where one seed's LUT does not fit beside the buffers (A=4, K=5, W=12:
//     262 KB), every seed of the launch shares one block's codes and the LUT
//     is read through the read-only path (__ldg) in its own layout.
// Measured on the H100 (PERF.md, PR 5), the LUT gathers, not the bytes, set
// the pace: about 90 us a seed-pass at config 5.  The pass and its launcher
// live in scores.cuh, shared with flat_scores_kernel (flat.cu), which runs
// them on base-(A+1) codes.

#include "scores.cuh"

namespace {

// scores.cuh's pass on combined-row codes, for the seeds of chunk blockIdx.y.
template <bool kSmemLut, int kW>
__global__ void __launch_bounds__(kThreads)
window_scores_kernel(const int* __restrict__ cidx, const int* __restrict__ lens,
                     const float* __restrict__ s_flat, float* __restrict__ scores,
                     unsigned char* __restrict__ mask,
                     int S, int N, int L, int W, int R1, int M,
                     int seeds_per_block, int rows_cap, int lut_floats) {
  scores_pass<kSmemLut, kW>(cidx, lens, s_flat, scores, mask, S, N, L, W, R1, M,
                            seeds_per_block, rows_cap, lut_floats, CombinedRows{});
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (scores.cuh's scores_run); scores and mask
// are written in full.  Requires N > 0, M > 0, L >= W and rows_cap a power
// of two >= W + 16.
// Returns a cudaError_t (0 = success) from the launch checks.
int window_scores_launch(const int* cidx, const int* lens, const float* s_flat,
                         float* scores, unsigned char* mask,
                         int S, int N, int L, int W, int R1, int M,
                         int seeds_per_block, int smem_lut, int rows_cap, void* stream) {
  auto pick = [](auto lut_c, auto width_c) {
    return window_scores_kernel<decltype(lut_c)::value, decltype(width_c)::value>;
  };
  return (int)scores_run(pick, cidx, lens, s_flat, scores, mask, S, N, L, W, R1, M,
                         seeds_per_block, smem_lut, rows_cap, 0,
                         static_cast<cudaStream_t>(stream));
}

const char* window_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
