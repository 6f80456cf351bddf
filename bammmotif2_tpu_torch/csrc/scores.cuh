// Window log-odds scores: the device routine of window_scores_kernel
// (window_scores.cu, combined-row codes, M seeds) and flat_scores_kernel
// (flat.cu, base-(A+1) codes, one seed), and its launcher.  The two differ
// only in how a code names its LUT row (a functor of common.cuh:
// CombinedRows, or MappedRows through map5), applied once, where a row is
// laid out in shared memory: the bulk copy moves the raw codes, and the copy
// out of its buffer, which every item makes, maps them.  The zeros around a
// laid-out row stay zeros; the windows that read them are dropped.  The
// contract and the design are window_scores.cu's.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

// Bulk copies from device to shared memory by the Tensor Memory Accelerator
// (cp.async.bulk), completed on an mbarrier in shared memory.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Waits until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Starts a bulk copy of the n ints at src (4-byte aligned) into the 16-byte
// aligned shared buffer buf, in whole 16-byte chunks, completing on bar
// (initialised with one arrival); src[0] lands at buf + (src's offset in its
// chunk, 0-3 ints).  The chunks cover up to 3 ints on either side of
// [src, src + n): they lie in the same 16-byte granules of the same
// allocation, and buf holds n + 8 ints.  Called by one thread, after the
// block's last reads of buf.
__device__ __forceinline__ void stage_bulk(int* buf, const int* src, int n,
                                           unsigned long long* bar) {
  const int h = static_cast<int>((reinterpret_cast<size_t>(src) >> 2) & 3);
  const unsigned bytes = static_cast<unsigned>((n + h + 3) / 4) * 16u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(buf)), "l"(src - h), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

constexpr int kRun = 4;     // windows a thread scores at once: one float4 store (with 8,
                            // the two stores of a lane leave every sector half written)
constexpr int kStages = 2;  // bulk-copy buffers: the next item streams in while one is scored
constexpr int kMargin = 16; // codes a laid-out row holds beyond its L: 4 + a_g before the
                            // row, and a last run's reads of up to 4 * ceil((W+3)/4) codes

// The stride of laid-out rows of length L: the power of two >= L + kMargin.
__host__ __device__ __forceinline__ int row_stride(int L) {
  int lp = 1;
  while (lp < L + kMargin) lp <<= 1;
  return lp;
}

// One item: a contiguous range of cidx, G rows (stride L) of CL codes each,
// their windows i0 .. i0+T-1 of strand s, rows n0 .. n0+G-1.
struct Item {
  int s, n0, G, i0, T, CL;
  size_t src;  // offset of its first code in cidx
};

struct Tiling {
  bool whole_rows;
  int rows_per_item, win_per_item, win_items, row_groups, items_per_strand;
};

__host__ __device__ __forceinline__ Tiling tiling(int N, int L, int W, int rows_cap) {
  Tiling tl;
  const int nwin = L - W + 1;
  tl.whole_rows = row_stride(L) <= rows_cap;
  tl.rows_per_item = tl.whole_rows ? rows_cap / row_stride(L) : 1;
  tl.win_per_item = tl.whole_rows ? nwin : rows_cap - kMargin - W + 1;
  tl.win_items = (nwin + tl.win_per_item - 1) / tl.win_per_item;
  tl.row_groups = (N + tl.rows_per_item - 1) / tl.rows_per_item;
  tl.items_per_strand = tl.row_groups * tl.win_items;
  return tl;
}

__device__ __forceinline__ Item item_at(int t, const Tiling& tl, int N, int L, int W) {
  const int nwin = L - W + 1;
  Item it;
  const int wi = t % tl.win_items;
  const int sr = t / tl.win_items;
  const int rg = sr % tl.row_groups;
  it.s = sr / tl.row_groups;
  it.n0 = rg * tl.rows_per_item;
  it.G = min(tl.rows_per_item, N - it.n0);
  it.i0 = wi * tl.win_per_item;
  it.T = min(nwin, it.i0 + tl.win_per_item) - it.i0;
  it.CL = it.T + W - 1;
  it.src = ((size_t)it.s * N + it.n0) * L + it.i0;
  return it;
}

// The kRun scores of the windows whose codes start at c (a laid-out row,
// 16-byte aligned for kW > 0).
//   kW > 0: the width is kW, the LUT [R1, Wp] in shared memory: the codes
//     come in as int4, each position's LUT row address is formed once and
//     its columns are read at immediate offsets;
//   kW == 0, kSmemLut: any width W, the same LUT;
//   kW == 0, !kSmemLut: any width, the LUT [R1, W] in device memory.
template <int kW, bool kSmemLut>
__device__ __forceinline__ void score_run(const int* c, const float* lut, int W, int Wp,
                                          float (&acc)[kRun]) {
#pragma unroll
  for (int r = 0; r < kRun; ++r) acc[r] = 0.f;
  if constexpr (kW > 0) {
    constexpr int kPos = kW + kRun - 1, kQuads = (kPos + 3) / 4;
    int code[4 * kQuads];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int4 v = reinterpret_cast<const int4*>(c)[q];
      code[4 * q] = v.x, code[4 * q + 1] = v.y, code[4 * q + 2] = v.z, code[4 * q + 3] = v.w;
    }
    const float* row[kPos];  // each position's LUT row
#pragma unroll
    for (int o = 0; o < kPos; ++o) row[o] = lut + code[o] * Wp;
#pragma unroll
    for (int j = 0; j < kW; ++j)
#pragma unroll
      for (int r = 0; r < kRun; ++r) acc[r] = __fadd_rn(acc[r], row[r + j][j]);
  } else {
    const int stride = kSmemLut ? Wp : W;
    int cur[kRun];  // a register window of kRun codes, slid along the row
#pragma unroll
    for (int r = 0; r < kRun; ++r) cur[r] = c[r];
    for (int j = 0; j < W; ++j) {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        const int k = cur[r] * stride + j;
        acc[r] = __fadd_rn(acc[r], kSmemLut ? lut[k] : __ldg(lut + k));
      }
#pragma unroll
      for (int r = 0; r < kRun - 1; ++r) cur[r] = cur[r + 1];
      cur[kRun - 1] = c[j + kRun];
    }
  }
}

// The floats of the LUTs a block stages for seeds_per_block seeds when
// smem_lut: rows padded to the odd stride W | 1, the whole a multiple of 4.
inline int scores_lut_floats(int seeds_per_block, int smem_lut, int R1, int W) {
  return smem_lut ? (seeds_per_block * R1 * (W | 1) + 3) / 4 * 4 : 0;
}

// The floats of dynamic shared memory a block of the pass lays out: the
// LUTs (lut_floats), the laid-out rows (rows_cap ints), then kStages
// bulk-copy buffers of rows_cap + 8 ints (a copy covers at most rows_cap +
// 6).  A kernel may keep more of its own past them (flat_scores_kernel:
// map5).
__host__ __device__ __forceinline__ size_t scores_smem_floats(int lut_floats, int rows_cap) {
  return (size_t)lut_floats + rows_cap + kStages * ((size_t)rows_cap + 8);
}

// The pass over items blockIdx.x + k * gridDim.x and the seeds of chunk
// blockIdx.y.  Every thread of the block calls it; row_of maps a code of
// cidx to its LUT row, where the rows are laid out.
template <bool kSmemLut, int kW, typename RowOf>
__device__ __forceinline__ void scores_pass(const int* __restrict__ cidx,
                                            const int* __restrict__ lens,
                                            const float* __restrict__ s_flat,
                                            float* __restrict__ scores,
                                            unsigned char* __restrict__ mask,
                                            int S, int N, int L, int W, int R1, int M,
                                            int seeds_per_block, int rows_cap, int lut_floats,
                                            RowOf row_of) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bars[kStages];
  const int nwin = L - W + 1;
  const int Wp = W | 1;  // the shared LUT's row stride
  // chunk blockIdx.y of gridDim.y balanced chunks (sizes differ by at most
  // one, the largest at most seeds_per_block: the launcher's ceil(M / spb))
  const int m0 = (int)((long long)blockIdx.y * M / gridDim.y);
  const int m1 = (int)((long long)(blockIdx.y + 1) * M / gridDim.y);
  const Tiling tl = tiling(N, L, W, rows_cap);
  const int Lp = tl.whole_rows ? row_stride(L) : rows_cap;  // laid-out row stride
  int lp_shift = 0;
  while ((1 << lp_shift) < Lp) ++lp_shift;
  // shared memory: scores_smem_floats' layout
  float* lut_s = smem;  // [m1 - m0, R1, Wp] when kSmemLut; lut_floats is a multiple of 4
  int* const rows = reinterpret_cast<int*>(smem + lut_floats);
  int* const bufs = rows + rows_cap;
  if (threadIdx.x == 0)
    for (int k = 0; k < kStages; ++k) mbar_init(bars + k, 1);
  if constexpr (kSmemLut) {
    const float* src = s_flat + (size_t)m0 * R1 * W;
    for (int k = threadIdx.x; k < (m1 - m0) * R1 * W; k += blockDim.x) {
      const int row = k / W;  // (seed, code)
      lut_s[row * Wp + (k - row * W)] = __ldg(src + k);
    }
  }
  __syncthreads();  // the barriers and the LUTs are in place

  const int items = S * tl.items_per_strand;  // < 2^31 (the launch checks)
  const bool write_mask = blockIdx.y == 0;
  // this block's items are t_k = blockIdx.x + k * gridDim.x, k < nk; item k
  // streams into buffer k % kStages, completing phase k / kStages of its barrier
  const int nk = items > (int)blockIdx.x ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto issue = [&](int k) {
    const Item nx = item_at(blockIdx.x + k * gridDim.x, tl, N, L, W);
    stage_bulk(bufs + (k % kStages) * (rows_cap + 8), cidx + nx.src, (nx.G - 1) * L + nx.CL,
               bars + k % kStages);
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < kStages - 1 && k < nk; ++k) issue(k);

  for (int k = 0; k < nk; ++k) {
    if (threadIdx.x == 0 && k + kStages - 1 < nk) issue(k + kStages - 1);
    const Item it = item_at(blockIdx.x + k * gridDim.x, tl, N, L, W);
    const int* codes = bufs + (k % kStages) * (rows_cap + 8) +
                       ((reinterpret_cast<size_t>(cidx + it.src) >> 2) & 3);
    // seed m0's row outputs: row g's sits a_g floats past a 16-byte boundary
    const float* out0 = scores + (((size_t)m0 * S + it.s) * N + it.n0) * nwin + it.i0;
    mbar_wait(bars + k % kStages, (k / kStages) & 1);

    // lay the rows out at stride Lp, position p of row g at 4 + a_g + p, so
    // that every run (below) starts on a 16-byte boundary; zeros around them.
    // A warp a row: lanes copy consecutive codes.
    const int a0 = (int)((reinterpret_cast<size_t>(out0) >> 2) & 3);
    for (int g = threadIdx.x >> 5; g < it.G; g += kWarps) {
      int* dst = rows + (g << lp_shift) + 4 + ((a0 + g * nwin) & 3);
      const int* src = codes + g * L;
      for (int p = (threadIdx.x & 31) - 8; p < it.CL + 12; p += 32)
        if (dst + p >= rows + (g << lp_shift) && dst + p < rows + ((g + 1) << lp_shift))
          dst[p] = p >= 0 && p < it.CL ? row_of(src[p]) : 0;
    }
    __syncthreads();

    // a run is kRun consecutive windows of one row: run u of row g covers
    // windows kRun*u - a_g onwards, so its output starts on a 16-byte boundary
    // (for every seed when S*N*nwin is a multiple of 4, else for m0's)
    const int runs_per_row = (it.T + kRun + 2) / kRun;
    const int n_runs = it.G * runs_per_row;
    for (int m = m0; m < m1; ++m) {
      const float* lut = kSmemLut ? lut_s + (size_t)(m - m0) * R1 * Wp : s_flat + (size_t)m * R1 * W;
      float* out = scores + (((size_t)m * S + it.s) * N + it.n0) * nwin + it.i0;
      const bool mask_here = write_mask && it.s == 0 && m == m0;
      for (int q = threadIdx.x; q < n_runs; q += blockDim.x) {
        const int g = q / runs_per_row, u = q - g * runs_per_row;
        const int i = kRun * u - ((a0 + g * nwin) & 3);
        float* orow = out + (size_t)g * nwin;
        const int len = min(max(__ldg(lens + it.n0 + g), 0), L);
        float acc[kRun];
        score_run<kW, kSmemLut>(rows + (g << lp_shift) + 4 + kRun * u, lut, W, Wp, acc);
        if (i >= 0 && i + kRun <= it.T && (reinterpret_cast<size_t>(orow + i) & 15) == 0) {
          float4 v;
          v.x = it.i0 + i + 0 + W <= len ? acc[0] : kNegInf;
          v.y = it.i0 + i + 1 + W <= len ? acc[1] : kNegInf;
          v.z = it.i0 + i + 2 + W <= len ? acc[2] : kNegInf;
          v.w = it.i0 + i + 3 + W <= len ? acc[3] : kNegInf;
          *reinterpret_cast<float4*>(orow + i) = v;
        } else {
#pragma unroll
          for (int r = 0; r < kRun; ++r)
            if (i + r >= 0 && i + r < it.T) orow[i + r] = it.i0 + i + r + W <= len ? acc[r] : kNegInf;
        }
        if (mask_here) {
          unsigned char* mrow = mask + (size_t)(it.n0 + g) * nwin + it.i0;
#pragma unroll
          for (int r = 0; r < kRun; ++r)
            if (i + r >= 0 && i + r < it.T) mrow[i + r] = it.i0 + i + r + W <= len;
        }
      }
    }
    __syncthreads();  // every reader of the rows (and of this buffer) is done
  }
}

// The widths with a kernel of their own (a shared-memory LUT only): with
// kWs, pick(bool_constant<smem_lut>, Int<W>) for W among them, else
// pick(bool_constant<smem_lut>, Int<0>), the generic loop.
template <int... kWs>
struct Widths {
  template <typename Pick>
  static auto kernel(int W, bool smem_lut, Pick pick) {
    using Zero = std::integral_constant<int, 0>;
    auto k = smem_lut ? pick(std::true_type{}, Zero{}) : pick(std::false_type{}, Zero{});
    if (smem_lut) ((W == kWs ? (k = pick(std::true_type{}, std::integral_constant<int, kWs>{}), 0) : 0), ...);
    return k;
  }
};
using KernelWidths = Widths<6, 8, 10, 12, 14, 16, 18, 20, 24, 30>;

// Launches the kernel that KernelWidths picks for (W, smem_lut), a
// __global__ over scores_pass taking (cidx, lens, s_flat, scores, mask, S, N,
// L, W, R1, M, seeds_per_block, rows_cap, lut_floats, extra...), on
// `stream`; scores and mask are written in full.  extra_floats of shared
// memory follow the pass's own for the kernel's use.  Requires N > 0, M > 0,
// L >= W and rows_cap a power of two >= W + kMargin: the codes an item lays
// out (whole rows at a power-of-two stride, or a tile).
// Returns a cudaError_t (0 = success) from the launch checks.
template <typename Pick, typename... Extra>
cudaError_t scores_run(Pick pick, const int* cidx, const int* lens, const float* s_flat,
                       float* scores, unsigned char* mask, int S, int N, int L, int W, int R1,
                       int M, int seeds_per_block, int smem_lut, int rows_cap,
                       size_t extra_floats, cudaStream_t st, Extra... extra) {
  auto kern = KernelWidths::kernel(W, smem_lut != 0, pick);
  const int lut_floats = scores_lut_floats(seeds_per_block, smem_lut, R1, W);
  const size_t smem = sizeof(float) * (scores_smem_floats(lut_floats, rows_cap) + extra_floats);
  if ((rows_cap & (rows_cap - 1)) || rows_cap < W + kMargin) return cudaErrorInvalidValue;
  const long long items = (long long)S * tiling(N, L, W, rows_cap).items_per_strand;
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  const int chunks = (M + seeds_per_block - 1) / seeds_per_block;
  int gx = 1;
  cudaError_t err = resident_grid(kern, smem, items, chunks, &gx);
  if (err != cudaSuccess) return err;
  kern<<<dim3(gx, chunks), kThreads, smem, st>>>(
      cidx, lens, s_flat, scores, mask, S, N, L, W, R1, M, seeds_per_block, rows_cap,
      lut_floats, extra...);
  return cudaGetLastError();
}

}  // namespace
