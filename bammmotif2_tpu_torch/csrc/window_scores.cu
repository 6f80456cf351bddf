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
// The sum adds j = 0..W-1 in order from 0.f, as escore.window_scores does,
// and only adds (no product, so no FMA is formed): the kernel equals the
// plain PyTorch version bit for bit.  The build does not use
// --use_fast_math.
//
// What bounds it on this card: bytes.  At BASELINE config 5's geometry
// (100k x 200 bp, S=2, W=12, M=1) one pass reads cidx (160 MB) and writes
// the scores (100k * 2 * 189 * 4 B = 151 MB): about 0.1 ms at 3.35 TB/s is
// the floor.  The W gathers per window hit shared memory (or L1), not
// device memory.
//
// What the design does about it:
//   * a work item is a run of whole rows of one strand (as many as fit
//     TILE_CODES codes; 20 rows at L=200), or, for rows longer than that, a
//     tile of windows of one row with its W-1 halo.  The item's codes are
//     staged in shared memory with coalesced loads and read once for every
//     seed of the block: this is what the TPU's seed stacking bought;
//   * consecutive threads take consecutive windows, and the windows of
//     consecutive rows of one strand are consecutive in the output, so the
//     stores of a whole item coalesce;
//   * the block's seeds' LUTs sit in shared memory where one seed's
//     (R+1)*W*4 B fits beside the codes (K=4, W=12: 65 KB); the wrapper
//     packs as many seeds per block as fit its target.  Above that (A=4,
//     K=5, W=12: 262 KB) every seed of the launch shares one block's codes
//     and the LUT is read through the read-only path (__ldg);
//   * the grid is persistent (the resident block count, split over the seed
//     chunks), so a block stages its LUTs once for many items;
//   * the kernel writes NEG_INF on invalid windows and the mask itself:
//     no second pass over the output.

#include "common.cuh"

namespace {

template <bool kSmemLut>
__global__ void __launch_bounds__(kThreads)
window_scores_kernel(const int* __restrict__ cidx, const int* __restrict__ lens,
                     const float* __restrict__ s_flat, float* __restrict__ scores,
                     unsigned char* __restrict__ mask,
                     int S, int N, int L, int W, int R1, int M,
                     int seeds_per_block, int tile_codes) {
  extern __shared__ float smem[];
  const int nwin = L - W + 1;
  const int RW = R1 * W;
  const int m0 = blockIdx.y * seeds_per_block;
  const int m1 = min(M, m0 + seeds_per_block);
  float* lut_s = smem;  // (m1 - m0) * RW when kSmemLut
  int* codes = reinterpret_cast<int*>(smem + (kSmemLut ? (size_t)seeds_per_block * RW : 0));
  if constexpr (kSmemLut) {
    const float* src = s_flat + (size_t)m0 * RW;
    for (int k = threadIdx.x; k < (m1 - m0) * RW; k += blockDim.x) lut_s[k] = __ldg(src + k);
  }

  // work items: (strand, group of rows, tile of windows)
  const bool whole_rows = L <= tile_codes;
  const int rows_per_item = whole_rows ? tile_codes / L : 1;
  const int win_per_item = whole_rows ? nwin : tile_codes - W + 1;
  const int win_items = (nwin + win_per_item - 1) / win_per_item;
  const int row_groups = (N + rows_per_item - 1) / rows_per_item;
  const long long items = (long long)S * row_groups * win_items;

  for (long long t = blockIdx.x; t < items; t += gridDim.x) {
    const int wi = (int)(t % win_items);
    const long long sr = t / win_items;
    const int rg = (int)(sr % row_groups);
    const int s = (int)(sr / row_groups);
    const int n0 = rg * rows_per_item;
    const int G = min(rows_per_item, N - n0);          // rows in this item
    const int i0 = wi * win_per_item;
    const int T = min(nwin, i0 + win_per_item) - i0;   // windows per row
    const int CL = T + W - 1;                          // codes per row (== L for whole rows)
    const int* src = cidx + ((size_t)s * N + n0) * L + i0;

    __syncthreads();  // the LUTs are staged; the previous item's readers are done
    for (int k = threadIdx.x; k < G * CL; k += blockDim.x) {
      const int g = k / CL;
      codes[k] = __ldg(src + (size_t)g * L + (k - g * CL));
    }
    __syncthreads();

    for (int m = m0; m < m1; ++m) {
      const float* lut = kSmemLut ? lut_s + (size_t)(m - m0) * RW : s_flat + (size_t)m * RW;
      float* out = scores + (((size_t)m * S + s) * N + n0) * nwin + i0;
      for (int w = threadIdx.x; w < G * T; w += blockDim.x) {
        const int g = w / T, i = w - g * T;
        const int len = min(max(__ldg(lens + n0 + g), 0), L);
        float sc = kNegInf;
        if (i0 + i + W <= len) {
          const int* c = codes + g * CL + i;
          sc = 0.f;  // j order as in escore.window_scores
          for (int j = 0; j < W; ++j) {
            const int idx = c[j] * W + j;
            if constexpr (kSmemLut) sc += lut[idx];
            else sc += __ldg(lut + idx);
          }
        }
        out[(size_t)g * nwin + i] = sc;
      }
    }
    if (s == 0 && blockIdx.y == 0) {
      for (int w = threadIdx.x; w < G * T; w += blockDim.x) {
        const int g = w / T, i = w - g * T;
        const int len = min(max(__ldg(lens + n0 + g), 0), L);
        mask[(size_t)(n0 + g) * nwin + i0 + i] = (i0 + i + W <= len) ? 1 : 0;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; scores and mask are written in full.
// Requires N > 0, M > 0, L >= W and W <= tile_codes.
// Returns a cudaError_t (0 = success) from the launch checks.
int window_scores_launch(const int* cidx, const int* lens, const float* s_flat,
                         float* scores, unsigned char* mask,
                         int S, int N, int L, int W, int R1, int M,
                         int seeds_per_block, int smem_lut, int tile_codes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kern)(const int*, const int*, const float*, float*, unsigned char*,
               int, int, int, int, int, int, int, int) =
      smem_lut ? window_scores_kernel<true> : window_scores_kernel<false>;
  const size_t smem = sizeof(float) * (
      (smem_lut ? (size_t)seeds_per_block * R1 * W : 0) + (size_t)tile_codes);
  const int nwin = L - W + 1;
  const bool whole_rows = L <= tile_codes;
  const int rows_per_item = whole_rows ? tile_codes / L : 1;
  const int win_per_item = whole_rows ? nwin : tile_codes - W + 1;
  const long long items = (long long)S * ((N + rows_per_item - 1) / rows_per_item) *
                          ((nwin + win_per_item - 1) / win_per_item);
  const int chunks = (M + seeds_per_block - 1) / seeds_per_block;
  int gx = 1;
  cudaError_t err = resident_grid(kern, smem, items, chunks, &gx);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(gx, chunks), kThreads, smem, st>>>(
      cidx, lens, s_flat, scores, mask, S, N, L, W, R1, M, seeds_per_block, tile_codes);
  return (int)cudaGetLastError();
}

const char* window_scores_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
