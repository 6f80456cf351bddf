// The three passes on base-(A+1) k-mer codes ("flat layout"), one seed.
//
// Replaces the Pallas TPU kernels of tools/pallas_flat.py:
//   flat_em_kernel     <- _em_kernel     (:267, reached through em_counts)
//   flat_scores_kernel <- _scores_kernel (:378, reached through window_scores)
//   flat_counts_kernel <- _counts_kernel (:447, reached through counts_from_r)
// They keep the contracts of em_counts.cu, window_scores.cu and
// counts_from_r.cu with M = 1, on other indices: qidx[s,n,t] in [0, Q),
// Q = (A+1)^(K+1), is the base-(A+1) code of the K+1 bases ending at t (digit
// d is the base at t-d, the symbol A is "no base"), and the LUT is
// s5 = s_flat[map5] [Q, W], gathered by the wrapper (ops/cuda_flat.py).
// Order truncation lives in the static map map5, so the kernels need none,
// and s5[qidx] == s_flat[cidx] exactly.  The E+M kernel writes base-(A+1)
// counts Cq [Q, W] in float64, which the wrapper folds into the combined rows
// in float64 (index_add_ over map5) and rounds once; the counts-from-r kernel
// adds each count straight into its combined row map5[qidx] and rounds in the
// same launch (counts.cuh).
//
// The TPU kernels flatten G rows into one lane vector, form every gather as
// a chunked one-hot matmul against bf16 term splits of the LUT, and shift
// windows with log-skew rolls, because the TPU has no fast gather.  None of
// that carries over: Hopper gathers from shared memory or L1, so each
// kernel here is its combined-layout counterpart with other indices.
//
// Contracts (all row-major, contiguous):
//   flat_em:     qidx int32 [S,N,L], lens int32 [N], s5 f32 [Q,W], q f32 [1]
//                -> Cq f64 [Q,W] (+= r at [qidx[s,n,i+j], j]), logz f32 [N],
//                   ll f32 [1] = sum_n logz[n] in a fixed order.  A row
//                   shorter than W has no windows and contributes log(1-q).
//   flat_scores: qidx, lens, s5 -> scores f32 [S,N,L-W+1] (NEG_INF on invalid
//                windows), mask uint8 [N,L-W+1] (i + W <= len)
//   flat_counts: r f32 [S,N,L] (window starts i < L-W+1 are read; no lens),
//                qidx, map5 int32 [Q] -> C f32 [R+1,W] (+= r at
//                [map5[qidx[s,n,i+j]], j])
// Window sums add j = 0..W-1 in order from 0.f with __fadd_rn (never an
// FMA), as escore.window_scores does: scores are bit-equal to the plain
// version's and to window_scores.cu's on the same sequences.  The build does
// not use --use_fast_math.
//
// What bounds them on this card: as for their combined counterparts, bytes
// (reading qidx, writing scores; reading r for the counts from r) and, for
// the E+M pass, W shared-memory atomics per window.  What differs is the
// height of the tables: Q rows against the combined layout's R+1 (A=4: 125
// vs 85 at K=2, 3,125 vs 1,365 at K=4, 15,625 vs 5,461 at K=5).  At W=12 a
// [Q, W] f32 table is 6 KB at K=2, 30 KB at K=3, 150 KB at K=4 and 750 KB at
// K=5.
//
// What the design does about it: the wrapper privatises the E+M counts, and
// then the LUT, in shared memory while they fit in the 227 KB a block may opt
// into (at K=4 only the counts fit, and the LUT is read through L1/L2 with
// __ldg).  Above that, counts go to the float64 global table with f64
// atomics, as em_counts.cu does at K=5.  A table of 150 KB leaves room for
// one block per SM: the cost of the taller table is occupancy, which the
// timings in PERF.md put a number on.  The counts from r keep the combined
// layout's [R1, W] table, so the taller one never arises there; only map5
// ([Q] int32, 500 B at K=2) is new, staged beside the counts while both fit
// the wrapper's budget and read through L1 beyond.

#include "counts.cuh"

namespace {

template <bool kSmemLut>
__device__ __forceinline__ float lut_at(const float* lut, int k) {
  if constexpr (kSmemLut) return lut[k];
  else return __ldg(lut + k);
}

// sum_j lut[code[j] * W + j] for codes read from device memory
template <bool kSmemLut>
__device__ __forceinline__ float window_score(const int* __restrict__ row, const float* lut,
                                              int W) {
  float sc = 0.f;
  for (int j = 0; j < W; ++j) sc = __fadd_rn(sc, lut_at<kSmemLut>(lut, __ldg(row + j) * W + j));
  return sc;
}

// ---------------------------------------------------------------- E + M --

template <bool kSmemLut>
__global__ void __launch_bounds__(kThreads)
flat_em_kernel(const int* __restrict__ qidx, const int* __restrict__ lens,
               const float* __restrict__ s5, const float* __restrict__ q,
               double* __restrict__ Cq, float* __restrict__ logz,
               int S, int N, int L, int W, int Q, int smem_counts) {
  extern __shared__ float smem[];
  const int QW = Q * W;
  float* red = smem;                                        // 2 * kWarps
  float* Cs = smem + 2 * kWarps;                            // QW when smem_counts
  float* lut_s = Cs + (smem_counts ? QW : 0);               // QW when kSmemLut
  if (smem_counts)
    for (int k = threadIdx.x; k < QW; k += blockDim.x) Cs[k] = 0.f;
  if constexpr (kSmemLut)
    for (int k = threadIdx.x; k < QW; k += blockDim.x) lut_s[k] = __ldg(s5 + k);
  __syncthreads();
  const float* lut = kSmemLut ? lut_s : s5;
  const float qm = __ldg(q);
  const float log_r0 = log1pf(-qm);

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const int len = min(max(__ldg(lens + n), 0), L);
    const int nwin = max(len - W + 1, 0);
    const int total = S * nwin;
    const float log_prior = total > 0 ? logf(qm) - logf((float)total) : kNegInf;

    // pass 1: log Z_n = logsumexp over the absent term and every window
    float mx = kNegInf, se = 0.f;
    for (int w = threadIdx.x; w < total; w += blockDim.x) {
      const int s = w / nwin, i = w - s * nwin;
      const int* row = qidx + ((size_t)s * N + n) * L + i;
      const float lw = window_score<kSmemLut>(row, lut, W) + log_prior;
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
    if (threadIdx.x == 0) logz[n] = lz;

    // pass 2: responsibilities scattered into the base-(A+1) count rows
    for (int w = threadIdx.x; w < total; w += blockDim.x) {
      const int s = w / nwin, i = w - s * nwin;
      const int* row = qidx + ((size_t)s * N + n) * L + i;
      const float r = expf(window_score<kSmemLut>(row, lut, W) + log_prior - lz);
      for (int j = 0; j < W; ++j) {
        const int k = __ldg(row + j) * W + j;
        if (smem_counts) atomicAdd(Cs + k, r);
        else atomicAdd(Cq + k, (double)r);
      }
    }
  }
  if (smem_counts) flush_counts(Cs, Cq, QW);
}

// --------------------------------------------------------------- scores --

// Work items as in window_scores.cu: a run of whole rows of one strand (as
// many as fit tile_codes codes), or, for longer rows, a tile of windows of
// one row with its W-1 halo; the item's codes are staged in shared memory
// with coalesced loads and consecutive threads write consecutive windows.
template <bool kSmemLut>
__global__ void __launch_bounds__(kThreads)
flat_scores_kernel(const int* __restrict__ qidx, const int* __restrict__ lens,
                   const float* __restrict__ s5, float* __restrict__ scores,
                   unsigned char* __restrict__ mask,
                   int S, int N, int L, int W, int Q, int tile_codes) {
  extern __shared__ float smem[];
  const int nwin = L - W + 1;
  const int QW = Q * W;
  float* lut_s = smem;  // QW when kSmemLut
  int* codes = reinterpret_cast<int*>(smem + (kSmemLut ? QW : 0));
  if constexpr (kSmemLut)
    for (int k = threadIdx.x; k < QW; k += blockDim.x) lut_s[k] = __ldg(s5 + k);
  const float* lut = kSmemLut ? lut_s : s5;

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
    const int CL = T + W - 1;                          // codes per row
    const int* src = qidx + ((size_t)s * N + n0) * L + i0;

    __syncthreads();  // the LUT is staged; the previous item's readers are done
    for (int k = threadIdx.x; k < G * CL; k += blockDim.x) {
      const int g = k / CL;
      codes[k] = __ldg(src + (size_t)g * L + (k - g * CL));
    }
    __syncthreads();

    float* out = scores + ((size_t)s * N + n0) * nwin + i0;
    for (int w = threadIdx.x; w < G * T; w += blockDim.x) {
      const int g = w / T, i = w - g * T;
      const int len = min(max(__ldg(lens + n0 + g), 0), L);
      const bool valid = i0 + i + W <= len;
      float sc = kNegInf;
      if (valid) {
        const int* c = codes + g * CL + i;
        sc = 0.f;
        for (int j = 0; j < W; ++j) sc = __fadd_rn(sc, lut_at<kSmemLut>(lut, c[j] * W + j));
      }
      out[(size_t)g * nwin + i] = sc;
      if (s == 0) mask[(size_t)(n0 + g) * nwin + i0 + i] = valid ? 1 : 0;
    }
  }
}

// --------------------------------------------------------------- counts --

// counts.cuh's streaming pass on qidx, its rows through map5: staged in
// shared memory beside the counts when the plan says so (kSmemMap), else
// read through L1.  The counts land in combined rows [R1, W].
template <bool kSmemMap>
__global__ void __launch_bounds__(kThreads)
flat_counts_kernel(const float* __restrict__ r, const int* __restrict__ qidx,
                   const int* __restrict__ map5, float* __restrict__ C,
                   double* __restrict__ acc, unsigned* __restrict__ ticket, long long plane,
                   int L, int W, int R1, int Q, int smem_counts) {
  extern __shared__ float smem[];
  const int RW = R1 * W;
  float* Cs = smem;                                                   // RW when smem_counts
  int* map_s = reinterpret_cast<int*>(smem + (smem_counts ? RW : 0));  // Q when kSmemMap
  if (smem_counts)
    for (int k = threadIdx.x; k < RW; k += kThreads) Cs[k] = 0.f;
  if constexpr (kSmemMap)
    for (int k = threadIdx.x; k < Q; k += kThreads) map_s[k] = __ldg(map5 + k);
  __syncthreads();
  counts_pass(r, qidx, plane, L, W, RW, MappedRows<kSmemMap>{kSmemMap ? map_s : map5},
              smem_counts ? Cs : nullptr, acc, ticket, C);
}

}  // namespace

extern "C" {

// E+M pass on `stream`.  Cq ([Q, W] f64) must be zeroed by the caller; logz
// and ll are written in full.  Requires N > 0.
// Returns a cudaError_t (0 = success) from the launch checks.
int flat_em_launch(const int* qidx, const int* lens, const float* s5, const float* q,
                   double* Cq, float* logz, float* ll, int S, int N, int L, int W, int Q,
                   int smem_lut, int smem_counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t table = (size_t)Q * W;
  const size_t smem = sizeof(float) * (2 * kWarps + (smem_counts ? table : 0) +
                                       (smem_lut ? table : 0));
  void (*kern)(const int*, const int*, const float*, const float*, double*, float*,
               int, int, int, int, int, int) =
      smem_lut ? flat_em_kernel<true> : flat_em_kernel<false>;
  int grid = 1;
  cudaError_t err = resident_grid(kern, smem, N, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, st>>>(qidx, lens, s5, q, Cq, logz, S, N, L, W, Q, smem_counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ll_reduce_kernel<<<1, kThreads, 0, st>>>(logz, N, ll);
  return (int)cudaGetLastError();
}

// Window scores on `stream`; scores and mask are written in full.
// Requires N > 0, L >= W and W <= tile_codes.
int flat_scores_launch(const int* qidx, const int* lens, const float* s5, float* scores,
                       unsigned char* mask, int S, int N, int L, int W, int Q, int smem_lut,
                       int tile_codes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((smem_lut ? (size_t)Q * W : 0) + (size_t)tile_codes);
  void (*kern)(const int*, const int*, const float*, float*, unsigned char*,
               int, int, int, int, int, int) =
      smem_lut ? flat_scores_kernel<true> : flat_scores_kernel<false>;
  const int nwin = L - W + 1;
  const bool whole_rows = L <= tile_codes;
  const int rows_per_item = whole_rows ? tile_codes / L : 1;
  const int win_per_item = whole_rows ? nwin : tile_codes - W + 1;
  const long long items = (long long)S * ((N + rows_per_item - 1) / rows_per_item) *
                          ((nwin + win_per_item - 1) / win_per_item);
  int grid = 1;
  cudaError_t err = resident_grid(kern, smem, items, 1, &grid);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, st>>>(qidx, lens, s5, scores, mask, S, N, L, W, Q, tile_codes);
  return (int)cudaGetLastError();
}

// Counts from r on `stream` of `device`: one kernel, no host query after
// the first call at a plan.  acc ([R1, W] f64) and *ticket must be zero, and
// are left zero; C [R1, W] is written in full.  plane = S * N * L > 0.
int flat_counts_launch(const float* r, const int* qidx, const int* map5, float* C, double* acc,
                       unsigned* ticket, long long plane, int L, int W, int R1, int Q,
                       int smem_counts, int smem_map, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const size_t smem =
      sizeof(float) * ((smem_counts ? (size_t)R1 * W : 0) + (smem_map ? (size_t)Q : 0));
  void (*kern)(const float*, const int*, const int*, float*, double*, unsigned*, long long,
               int, int, int, int, int) =
      smem_map ? flat_counts_kernel<true> : flat_counts_kernel<false>;
  long long resident = 0;
  cudaError_t err = resident_blocks(kern, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  kern<<<counts_grid(resident, 1, plane), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, qidx, map5, C, acc, ticket, plane, L, W, R1, Q, smem_counts);
  return (int)cudaGetLastError();
}

const char* flat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
