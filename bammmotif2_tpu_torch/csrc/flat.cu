// The three passes on base-(A+1) k-mer codes ("flat layout"), one seed.
//
// Replaces the Pallas TPU kernels of tools/pallas_flat.py:
//   flat_em_kernel     <- _em_kernel     (:267, reached through em_counts)
//   flat_scores_kernel <- _scores_kernel (:378, reached through window_scores)
//   flat_counts_kernel <- _counts_kernel (:447, reached through counts_from_r)
// They keep the contracts of em_counts.cu, window_scores.cu and
// counts_from_r.cu with M = 1, on other indices: qidx[s,n,t] in [0, Q),
// Q = (A+1)^(K+1), is the base-(A+1) code of the K+1 bases ending at t (digit
// d is the base at t-d, the symbol A is "no base"), and the static map map5
// [Q] int32 names each code's combined row: map5[qidx] == cidx, order
// truncation included.  So the tables stay the combined layout's, R+1 rows
// tall, and the LUT is s_flat [R+1, W] itself.
//
// Contracts (all row-major, contiguous):
//   flat_em:     qidx int32 [S,N,L], lens int32 [N], s_flat f32 [R+1,W],
//                q f32 [1], map5 -> C f32 [R+1,W] (+= r at
//                [map5[qidx[s,n,i+j]], j], summed in float64 and rounded
//                once), logz f32 [N], ll f32 [1] = sum_n logz[n] in a fixed
//                order.  A row shorter than W has no windows and contributes
//                log(1-q).
//   flat_scores: qidx, lens, s_flat, map5 -> scores f32 [S,N,L-W+1]
//                (NEG_INF on invalid windows), mask uint8 [N,L-W+1]
//                (i + W <= len)
//   flat_counts: r f32 [S,N,L] (window starts i < L-W+1 are read; no lens),
//                qidx, map5 -> C f32 [R+1,W] (+= r at
//                [map5[qidx[s,n,i+j]], j])
// Window sums add j = 0..W-1 in order from 0.f with __fadd_rn (never an
// FMA), as escore.window_scores does: scores are bit-equal to the plain
// version's and to window_scores.cu's on the same sequences.  The build does
// not use --use_fast_math.
//
// The TPU kernels flatten G rows into one lane vector, form every gather as
// a chunked one-hot matmul against bf16 term splits of the LUT, and shift
// windows with log-skew rolls, because the TPU has no fast gather.  None of
// that carries over.
//
// What bounds them on this card is what bounds their combined
// counterparts: shared-memory gathers and count atomics for the E+M pass,
// LUT gathers and bytes for the scores, the read of r for the counts from r.
// So each kernel runs its counterpart's pass (em.cuh, scores.cuh,
// counts.cuh) with one change: a code is mapped to its row through map5
// where it is staged (E+M: as a team stages a sequence's codes; scores: as a
// row is laid out from its bulk-copy buffer; counts: as a queued window's
// codes are read), one lookup a staged code, against the W LUT reads and W
// count adds a window.  Tables of Q rows, the s5 = s_flat[map5] gather and
// the fold of base-(A+1) counts are gone.  Where map5 lives ([Q] int32:
// 500 B at A=4, K=2; 12.5 KB at K=4; 62.5 KB at K=5): the E+M pass reads it
// through L1 (__ldg), as a copy in shared memory timed no faster; the scores
// pass stages it in shared memory where that costs an SM no resident block
// (flat_scores_launch), else reads it through L1; the counts pass stages it
// beside its counts where both fit (ops/cuda_flat.py::counts_plan).

#include "counts.cuh"
#include "em.cuh"
#include "scores.cuh"

namespace {

// ---------------------------------------------------------------- E + M --

// em.cuh's pass on qidx, its codes mapped through map5 (read through L1) as
// they are staged.
template <int kTeam, bool kSmemLut, int kCounts>
__global__ void __launch_bounds__(kThreads)
flat_em_kernel(const int* __restrict__ qidx, const int* __restrict__ lens,
               const float* __restrict__ s_flat, const float* __restrict__ q,
               double* __restrict__ Cd, float* __restrict__ logz,
               int S, int N, int L, int W, int R1, int M,
               int seeds_per_block, int table_floats, int codes_cap,
               const int* __restrict__ map5) {
  em_pass<kTeam, kSmemLut, kCounts>(qidx, lens, s_flat, q, Cd, logz, S, N, L, W, R1, M,
                                    seeds_per_block, table_floats, codes_cap,
                                    SeedActivity{}, MappedRows<false>{map5});
}

// --------------------------------------------------------------- scores --

// scores.cuh's pass on qidx, its codes mapped through map5 as a row is laid
// out: map5 staged in shared memory past the pass's layout (kSmemMap), else
// read through L1.
template <bool kSmemLut, int kW, bool kSmemMap>
__global__ void __launch_bounds__(kThreads)
flat_scores_kernel(const int* __restrict__ qidx, const int* __restrict__ lens,
                   const float* __restrict__ s_flat, float* __restrict__ scores,
                   unsigned char* __restrict__ mask,
                   int S, int N, int L, int W, int R1, int M,
                   int seeds_per_block, int rows_cap, int lut_floats,
                   const int* __restrict__ map5, int Q) {
  extern __shared__ __align__(16) float smem[];
  int* map_s = reinterpret_cast<int*>(smem + scores_smem_floats(lut_floats, rows_cap));
  if constexpr (kSmemMap)  // before the pass's first barrier
    for (int k = threadIdx.x; k < Q; k += kThreads) map_s[k] = __ldg(map5 + k);
  scores_pass<kSmemLut, kW>(qidx, lens, s_flat, scores, mask, S, N, L, W, R1, M,
                            seeds_per_block, rows_cap, lut_floats,
                            MappedRows<kSmemMap>{kSmemMap ? map_s : map5});
}

template <bool kSmemMap>
struct FlatScores {
  template <typename Lut, typename Width>
  auto operator()(Lut, Width) const {
    return flat_scores_kernel<Lut::value, Width::value, kSmemMap>;
  }
};

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
  extern __shared__ __align__(16) float smem[];
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

// E+M pass on `stream` of `device` (em.cuh's em_run, M = 1): Cd ([R1, W]
// f64) must be zeroed by the caller; C, logz and ll are written in full.
// The plan is cuda_em.launch_plan's for one seed (smem_lut, counts, team,
// codes_cap).  Requires N > 0.
// Returns a cudaError_t (0 = success) from the launch checks.
int flat_em_launch(const int* qidx, const int* lens, const float* s_flat, const float* q,
                   const int* map5, float* C, double* Cd, float* logz, float* ll,
                   int S, int N, int L, int W, int R1, int smem_lut, int counts, int team,
                   int codes_cap, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  auto pick = [](auto team_c, auto lut_c, auto counts_c) {
    return flat_em_kernel<decltype(team_c)::value, decltype(lut_c)::value,
                          decltype(counts_c)::value>;
  };
  return (int)em_run(pick, qidx, lens, s_flat, q, C, Cd, logz, ll, S, N, L, W, R1, 1, 1,
                     smem_lut, counts, team, codes_cap, static_cast<cudaStream_t>(stream), map5);
}

// Window scores on `stream` of `device` (scores.cuh's scores_run, M = 1);
// scores and mask are written in full.  The plan is ops/cuda_flat.py::
// scores_plan's: cuda_scores.launch_plan's for one seed (smem_lut) and
// whether map5's bytes fit beside it (map_fits).  Where they fit, the map is
// staged in shared memory if an SM then holds as many blocks as with the map
// read through L1 (at W=12 staging timed 2-7% faster at K=2-4), and read
// through L1 otherwise.  Requires N > 0, L >= W and rows_cap a power of two
// >= W + 16.
// Returns a cudaError_t (0 = success) from the launch checks.
int flat_scores_launch(const int* qidx, const int* lens, const float* s_flat, const int* map5,
                       float* scores, unsigned char* mask, int S, int N, int L, int W, int R1,
                       int Q, int smem_lut, int map_fits, int rows_cap, int device,
                       void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t base = sizeof(float) * scores_smem_floats(scores_lut_floats(1, smem_lut, R1, W),
                                                         rows_cap);
  long long through_l1 = 0, staged = 0;
  cudaError_t err = cudaSuccess;
  if (map_fits) {
    err = resident_blocks(KernelWidths::kernel(W, smem_lut != 0, FlatScores<false>{}), base,
                          &through_l1);
    if (err == cudaSuccess)
      err = resident_blocks(KernelWidths::kernel(W, smem_lut != 0, FlatScores<true>{}),
                            base + sizeof(int) * Q, &staged);
    if (err != cudaSuccess) return (int)err;
  }
  if (map_fits && staged == through_l1)
    return (int)scores_run(FlatScores<true>{}, qidx, lens, s_flat, scores, mask, S, N, L, W, R1,
                           1, 1, smem_lut, rows_cap, (size_t)Q, st, map5, Q);
  return (int)scores_run(FlatScores<false>{}, qidx, lens, s_flat, scores, mask, S, N, L, W, R1,
                         1, 1, smem_lut, rows_cap, 0, st, map5, Q);
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
