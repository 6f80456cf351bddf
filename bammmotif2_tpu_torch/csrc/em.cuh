// The fused E+M data pass of one ZOOPS EM iteration: the device routine of
// em_counts_kernel (em_counts.cu, combined-row codes, M seeds) and
// flat_em_kernel (flat.cu, base-(A+1) codes, one seed), and its launcher.
// The two differ only in how a staged code names its table row (a functor of
// common.cuh: CombinedRows, or MappedRows through map5), which is applied
// once, where the codes are staged in shared memory; from there on the pass
// is the same.  The contract and the design are em_counts.cu's.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

// Stages M LUTs [M, R1, W] from device memory into shared memory as
// [M, W, R1] (lanes that read one column j at different rows then spread
// over the banks).  Called by every thread.
__device__ __forceinline__ void stage_lut_transposed(float* dst, const float* __restrict__ src,
                                                     int M, int R1, int W) {
  const int RW = R1 * W;
  for (int k = threadIdx.x; k < M * RW; k += blockDim.x) {
    const int m = k / RW, rem = k - m * RW, c = rem / W, j = rem - c * W;
    dst[m * RW + j * R1 + c] = __ldg(src + k);
  }
}

// Where a block keeps its partial counts: float64 global atomics only, a
// float table in shared memory, or a 64-bit fixed-point table in shared
// memory (two uint32 words an entry, in units of 2^-48: a count add loses
// under 2^-49, and an entry holds up to 2^16, more than the rows one block
// may sum, which the launch checks).
constexpr int kCountsGlobal = 0, kCountsFloat = 1, kCountsFixed = 2;
constexpr int kFixedBits = 48;
constexpr float kFixedOne = 281474976710656.f;  // 2^48

// Adds a block's partial counts Cs, laid out [M, W, R1] (for fixed point,
// the low words, with the high words table_floats further on), into the f64
// global table Cg [M, R1, W], one atomic per non-zero entry, in Cg's order.
// Called by every thread.
template <int kCounts>
__device__ __forceinline__ void flush_counts_transposed(const float* Cs, int table_floats,
                                                        double* Cg, int M, int R1, int W) {
  __syncthreads();
  const int RW = R1 * W;
  for (int k = threadIdx.x; k < M * RW; k += blockDim.x) {
    const int m = k / RW, rem = k - m * RW, c = rem / W, j = rem - c * W;
    const int t = m * RW + j * R1 + c;
    double v;
    if constexpr (kCounts == kCountsFixed) {
      const unsigned* w = reinterpret_cast<const unsigned*>(Cs);
      v = ((double)w[t + table_floats] * 4294967296.0 + (double)w[t]) / (double)kFixedOne;
    } else {
      v = (double)Cs[t];
    }
    if (v != 0.0) atomicAdd(Cg + k, v);
  }
}

template <bool kSmemLut>
__device__ __forceinline__ float lut_at(const float* lut, int c, int j, int R1, int W) {
  if constexpr (kSmemLut) return lut[j * R1 + c];  // [W, R1] in shared memory
  else return __ldg(lut + (size_t)c * W + j);      // [R1, W] in device memory
}

template <bool kSmemLut>
__device__ __forceinline__ float window_score(const int* c, const float* lut, int R1, int W) {
  float sc = 0.f;  // j order as in escore.window_scores
  for (int j = 0; j < W; ++j) sc += lut_at<kSmemLut>(lut, c[j], j, R1, W);
  return sc;
}

template <int kTeam>
__device__ __forceinline__ void team_sync() {
  if constexpr (kTeam == 32) __syncwarp();
  else __syncthreads();
}

template <int kTeam>
__device__ __forceinline__ void team_lse(float& m, float& s, float* red) {
  if constexpr (kTeam == 32) warp_lse(m, s);
  else block_lse(m, s, red);
}

// Team-wide copy of n codes of device memory into shared memory, each as
// its table row.
template <int kTeam, typename RowOf>
__device__ __forceinline__ void stage_codes(int* dst, const int* __restrict__ src, int n, int rank,
                                            RowOf row_of) {
  for (int k = rank; k < n; k += kTeam) dst[k] = row_of(__ldg(src + k));
}

// Scores windows 0..nw-1 of codes c (one strand, or one tile of it): folds
// each log-weight lw = score + log_prior into the online (mx, se) pair, and
// with store keeps it in lwb[i].
template <int kTeam, bool kSmemLut>
__device__ __forceinline__ void score_windows(const int* c, int nw, const float* lut, int R1,
                                              int W, float log_prior, float* lwb, bool store,
                                              int rank, float& mx, float& se) {
  for (int i = rank; i < nw; i += kTeam) {
    const float lw = window_score<kSmemLut>(c + i, lut, R1, W) + log_prior;
    if (store) lwb[i] = lw;
    if (lw > mx) {
      se = se * expf(mx - lw) + 1.f;
      mx = lw;
    } else {
      se += expf(lw - mx);
    }
  }
}

// A group of at least this many lanes of a warp that hold one code sums its
// responsibilities by a shuffle reduction and adds once; smaller groups add
// directly, so one atomic instruction meets at most kBigGroup - 1 times on
// one address.
constexpr int kBigGroup = 8;

// Adds v at count (code, j): to the seed's shared table Cs ([W, R1]; for
// fixed point, high words table_floats further on) or to its f64 global
// table Cd ([R1, W]).  A fixed-point add is exact in integers: the low word's
// atomic returns the old word, and a wrap carries one into the high word.
template <int kCounts>
__device__ __forceinline__ void add_count(float* Cs, int table_floats, double* Cd, int code,
                                          int j, int R1, int W, float v) {
  if constexpr (kCounts == kCountsFloat) {
    atomicAdd(Cs + j * R1 + code, v);
  } else if constexpr (kCounts == kCountsFixed) {
    const unsigned long long x = __float2ull_rn(v * kFixedOne);  // exact scaling, then round
    unsigned* lo = reinterpret_cast<unsigned*>(Cs) + j * R1 + code;
    const unsigned xl = (unsigned)x, old = atomicAdd(lo, xl);
    const unsigned hi = (unsigned)(x >> 32) + (old + xl < old ? 1u : 0u);
    if (hi) atomicAdd(lo + table_floats, hi);
  } else {
    atomicAdd(Cd + (size_t)code * W + j, (double)v);
  }
}

// Adds r[i] (i in 0..nw-1, shared memory) at (c[i + j], j) for every j,
// for the nc = nw + W - 1 codes c (shared memory), position-major: lane p
// of a warp holds code c_p and owes r[p - j] to count (c_p, j) for each j.
// Lanes whose code fewer than kBigGroup lanes of the warp share add their
// own r directly; each larger group (a homopolymer run puts all 32 lanes in
// one) is reduced by shuffles and added once per j by its lowest lane.
template <int kTeam, int kCounts>
__device__ __forceinline__ void scatter_counts(const int* c, int nc, const float* r, int nw,
                                               float* Cs, int table_floats, double* Cd, int R1,
                                               int W) {
  const int lane = threadIdx.x & 31;
  const int first = kTeam == 32 ? 0 : (threadIdx.x >> 5) * 32;
  for (int p0 = first; p0 < nc; p0 += kTeam) {
    const int p = p0 + lane;
    const bool live = p < nc;
    const int code = live ? c[p] : -1 - lane;  // lanes past the end match nobody
    const unsigned peers = __match_any_sync(0xffffffffu, code);
    const bool big = live && __popc(peers) >= kBigGroup;
    if (live && !big) {
      for (int j = 0; j < W; ++j) {
        const int i = p - j;  // the window that reads this position at j
        if (i >= 0 && i < nw) {
          const float v = r[i];
          if (v != 0.f) add_count<kCounts>(Cs, table_floats, Cd, code, j, R1, W, v);
        }
      }
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, big); todo;) {  // the same for every lane
      const int leader = __ffs(todo) - 1;
      const unsigned group = __shfl_sync(0xffffffffu, peers, leader);
      const int gcode = __shfl_sync(0xffffffffu, code, leader);
      const bool mine = (group >> lane) & 1u;
      for (int j = 0; j < W; ++j) {
        const int i = p - j;
        float v = mine && i >= 0 && i < nw ? r[i] : 0.f;
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == leader && v != 0.f)
          add_count<kCounts>(Cs, table_floats, Cd, gcode, j, R1, W, v);
      }
      todo &= ~group;
    }
  }
}

// The EM loop's state that tells the pass which seeds still step
// (refinement/multi.py::FusedStep): the group's running flag, the seeds'
// effective v_diff [M] and epsilon, on the device.  A null running (every
// other caller) serves every seed.
struct SeedActivity {
  const bool* running;
  const float* vds;
  const float* eps;
};

// Deals a launch's gridDim.x * gridDim.y blocks (one seed a block) to the
// seeds active at this iteration (common.cuh's seed_active): taken in order,
// in consecutive shares whose sizes differ by at most one, the r-th share to
// the r-th active seed.  Sets the block's seed m and its place bx among the
// nbx blocks of that seed's share, and returns false where no seed is
// active.  With every seed active it is seed blockIdx.y and block blockIdx.x
// of gridDim.x, the launch's own grid; a seed's share only grows as others
// freeze.  Called by every thread, with the same result.
__device__ __forceinline__ bool deal_block(const SeedActivity& act, int M, int& m, int& bx,
                                           int& nbx) {
  int active = 0;
  for (int k = 0; k < M; ++k) active += seed_active(act.running, act.vds, act.eps, k);
  if (active == 0) return false;
  const long long blocks = (long long)gridDim.x * gridDim.y;
  const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  int r = (int)(((b + 1) * active - 1) / blocks);  // the share that holds block b
  const long long lo = r * blocks / active;
  bx = (int)(b - lo);
  nbx = (int)((r + 1) * blocks / active - lo);
  for (m = 0; m < M; ++m)
    if (seed_active(act.running, act.vds, act.eps, m) && r-- == 0) break;
  return true;
}

// The pass over sequences bx * teams + team (grid-strided over the nbx
// blocks that serve the same seeds) and the seeds [m0, m1): chunk
// blockIdx.y's seeds and blockIdx.x of gridDim.x, or, where act has a
// running flag, the active seed that deal_block gives the block (one seed a
// block).  Every thread of the block calls it; row_of maps a code of
// `codes` to its table row.
template <int kTeam, bool kSmemLut, int kCounts, typename RowOf>
__device__ __forceinline__ void em_pass(const int* __restrict__ codes, const int* __restrict__ lens,
                                        const float* __restrict__ s_flat, const float* __restrict__ q,
                                        double* __restrict__ Cd, float* __restrict__ logz,
                                        int S, int N, int L, int W, int R1, int M,
                                        int seeds_per_block, int table_floats, int codes_cap,
                                        SeedActivity act, RowOf row_of) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kTeams = kThreads / kTeam;
  const int RW = R1 * W;
  int m0, m1, bx = blockIdx.x, nbx = gridDim.x;
  if (act.running == nullptr) {
    // chunk blockIdx.y of gridDim.y balanced chunks (sizes differ by at
    // most one, the largest at most seeds_per_block: the launcher's
    // ceil(M / spb))
    m0 = (int)((long long)blockIdx.y * M / gridDim.y);
    m1 = (int)((long long)(blockIdx.y + 1) * M / gridDim.y);
  } else {
    if (!deal_block(act, M, m0, bx, nbx)) return;  // the same for the whole block
    m1 = m0 + 1;
  }
  float* red = smem;                                       // 2 * kWarps (block teams)
  float* lut_s = red + 2 * kWarps;                         // [spb, W, R1] with kSmemLut
  float* Cs = lut_s + (kSmemLut ? table_floats : 0);       // [spb, W, R1], kCounts' words
  const int counts_words = kCounts == kCountsFixed ? 2 * table_floats
                           : kCounts == kCountsFloat ? table_floats : 0;
  float* team_buf = Cs + counts_words;                     // per team: codes, then log-weights
  const int team = kTeam == 32 ? threadIdx.x >> 5 : 0;
  const int rank = kTeam == 32 ? threadIdx.x & 31 : threadIdx.x;
  int* cb = reinterpret_cast<int*>(team_buf + (size_t)team * 2 * codes_cap);
  float* lwb = team_buf + (size_t)team * 2 * codes_cap + codes_cap;

  if constexpr (kSmemLut) stage_lut_transposed(lut_s, s_flat + (size_t)m0 * RW, m1 - m0, R1, W);
  for (int k = threadIdx.x; k < counts_words; k += blockDim.x) Cs[k] = 0.f;
  __syncthreads();

  for (int n = bx * kTeams + team; n < N; n += nbx * kTeams) {
    const int len = min(max(__ldg(lens + n), 0), L);
    const int nwin = max(len - W + 1, 0);
    const int total = S * nwin;
    const bool resident = S * len <= codes_cap;
    const int tile = codes_cap - W + 1;  // windows of one tile when not resident
    if (resident) {
      for (int s = 0; s < S; ++s)
        stage_codes<kTeam>(cb + s * len, codes + ((size_t)s * N + n) * L, len, rank, row_of);
      team_sync<kTeam>();
    }
    for (int m = m0; m < m1; ++m) {
      const float* lut = kSmemLut ? lut_s + (size_t)(m - m0) * RW : s_flat + (size_t)m * RW;
      float* Cm = Cs + (size_t)(m - m0) * RW;
      double* Cdm = Cd + (size_t)m * RW;
      const float qm = __ldg(q + m);
      const float log_r0 = log1pf(-qm);
      const float log_prior = total > 0 ? logf(qm) - logf((float)total) : kNegInf;

      // log Z_n: logsumexp over the absent term and every window
      float mx = kNegInf, se = 0.f;
      if (resident) {
        for (int s = 0; s < S; ++s)
          score_windows<kTeam, kSmemLut>(cb + s * len, nwin, lut, R1, W, log_prior,
                                         lwb + s * nwin, true, rank, mx, se);
      } else {
        for (int s = 0; s < S; ++s)
          for (int i0 = 0; i0 < nwin; i0 += tile) {
            const int nw = min(tile, nwin - i0);
            stage_codes<kTeam>(cb, codes + ((size_t)s * N + n) * L + i0, nw + W - 1, rank,
                               row_of);
            team_sync<kTeam>();
            score_windows<kTeam, kSmemLut>(cb, nw, lut, R1, W, log_prior, lwb, false, rank,
                                           mx, se);
            team_sync<kTeam>();
          }
      }
      team_lse<kTeam>(mx, se, red);
      lse_merge(mx, se, log_r0, 1.f);
      const float lz = mx + logf(se);
      if (rank == 0) logz[(size_t)m * N + n] = lz;
      if (total == 0) continue;

      // responsibilities scattered into the count rows
      if (resident) {
        for (int i = rank; i < total; i += kTeam) lwb[i] = expf(lwb[i] - lz);
        team_sync<kTeam>();
        for (int s = 0; s < S; ++s)
          scatter_counts<kTeam, kCounts>(cb + s * len, len, lwb + s * nwin, nwin, Cm,
                                         table_floats, Cdm, R1, W);
        team_sync<kTeam>();  // lwb is rewritten by the next seed
      } else {
        for (int s = 0; s < S; ++s)
          for (int i0 = 0; i0 < nwin; i0 += tile) {
            const int nw = min(tile, nwin - i0);
            stage_codes<kTeam>(cb, codes + ((size_t)s * N + n) * L + i0, nw + W - 1, rank,
                               row_of);
            team_sync<kTeam>();
            for (int i = rank; i < nw; i += kTeam)
              lwb[i] = expf(window_score<kSmemLut>(cb + i, lut, R1, W) + log_prior - lz);
            team_sync<kTeam>();
            scatter_counts<kTeam, kCounts>(cb, nw + W - 1, lwb, nw, Cm, table_floats, Cdm,
                                           R1, W);
            team_sync<kTeam>();
          }
      }
    }
    team_sync<kTeam>();  // cb is restaged for the next sequence
  }

  if constexpr (kCounts != kCountsGlobal)
    flush_counts_transposed<kCounts>(Cs, table_floats, Cd + (size_t)m0 * RW, m1 - m0, R1, W);
}

template <int V>
using Int = std::integral_constant<int, V>;

// Launches the kernel pick(Int<team>, bool_constant<smem_lut>, Int<counts>) returns,
// a __global__ over em_pass taking (codes, lens, s_flat, q, Cd, logz, S, N,
// L, W, R1, M, seeds_per_block, table_floats, codes_cap, extra...), on a
// persistent grid.
template <int kTeam, bool kSmemLut, int kCounts, typename Pick, typename... Extra>
cudaError_t em_launch_plan(Pick pick, const int* codes, const int* lens, const float* s_flat,
                           const float* q, double* Cd, float* logz, int S, int N, int L, int W,
                           int R1, int M, int seeds_per_block, int table_floats, int codes_cap,
                           size_t smem, cudaStream_t st, Extra... extra) {
  auto kern = pick(Int<kTeam>{}, std::bool_constant<kSmemLut>{}, Int<kCounts>{});
  const int chunks = (M + seeds_per_block - 1) / seeds_per_block;
  constexpr int kTeams = kThreads / kTeam;
  int gx = 1;
  cudaError_t err = resident_grid(kern, smem, (N + kTeams - 1) / kTeams, chunks, &gx);
  if (err != cudaSuccess) return err;
  if constexpr (kCounts == kCountsFixed) {
    // an entry sums at most one count a row the block scores: past 2^16
    // rows a block, the float table (half the words, same launch) takes over
    // (a seed dealt the grid gets at least gx blocks, so no more rows)
    const long long rows = ((long long)N + (long long)gx * kTeams - 1) / ((long long)gx * kTeams) * kTeams;
    if (rows >= (1ll << (64 - kFixedBits)))
      return em_launch_plan<kTeam, kSmemLut, kCountsFloat>(
          pick, codes, lens, s_flat, q, Cd, logz, S, N, L, W, R1, M, seeds_per_block,
          table_floats, codes_cap, smem, st, extra...);
  }
  kern<<<dim3(gx, chunks), kThreads, smem, st>>>(codes, lens, s_flat, q, Cd, logz, S, N, L, W,
                                                 R1, M, seeds_per_block, table_floats,
                                                 codes_cap, extra...);
  return cudaGetLastError();
}

// The whole E+M call on `stream`: checks the plan, launches the pass, then
// rounds the f64 counts Cd into C and reduces logz into ll in a fixed order.
// Cd ([M, R1, W] f64) must be zeroed by the caller; C and logz are written in
// full.  With C null it stops after the pass, leaving the counts in Cd and
// writing neither C nor ll (em_update.cu's kernel finishes them in the EM
// loop).  The plan (ops/cuda_em.py::launch_plan): seeds_per_block seeds share
// a block; smem_lut says whether the LUTs live in shared memory (which needs
// the counts there too), counts where the partial counts live (0 float64
// global atomics, 1 a float shared table, 2 a fixed-point shared table); team
// is 32 (a warp per sequence) or 256 (a block); codes_cap is the codes (and
// log-weights) each team buffers, a multiple of 4 that, for warp teams,
// holds S * L.  extra... follow the kernel's arguments.
// Returns a cudaError_t (0 = success) from the launch checks.
template <typename Pick, typename... Extra>
cudaError_t em_run(Pick pick, const int* codes, const int* lens, const float* s_flat,
                   const float* q, float* C, double* Cd, float* logz, float* ll,
                   int S, int N, int L, int W, int R1, int M, int seeds_per_block, int smem_lut,
                   int counts, int team, int codes_cap, cudaStream_t st,
                   Extra... extra) {
  if ((team != 32 && team != kThreads) || counts < 0 || counts > 2 ||
      (smem_lut && counts == kCountsGlobal) || codes_cap % 4 ||
      codes_cap < W || (team == 32 && S * L > codes_cap))
    return cudaErrorInvalidValue;
  const int table_floats = (seeds_per_block * R1 * W + 3) / 4 * 4;
  // the reduction slots, the LUTs, the counts (counts' words) and the
  // teams' buffers (codes, then log-weights)
  const size_t smem = sizeof(float) * (2 * kWarps + (smem_lut ? table_floats : 0) +
                                       (size_t)counts * table_floats +
                                       (size_t)(kThreads / team) * 2 * codes_cap);
#define EM_LAUNCH(TEAM, LUT, COUNTS)                                                              \
  em_launch_plan<TEAM, LUT, COUNTS>(pick, codes, lens, s_flat, q, Cd, logz, S, N, L, W, R1, M, \
                                    seeds_per_block, table_floats, codes_cap, smem, st, extra...)
  cudaError_t err;
  if (team == 32)
    err = counts == kCountsFixed ? (smem_lut ? EM_LAUNCH(32, true, kCountsFixed) : EM_LAUNCH(32, false, kCountsFixed))
          : counts == kCountsFloat ? (smem_lut ? EM_LAUNCH(32, true, kCountsFloat) : EM_LAUNCH(32, false, kCountsFloat))
          : EM_LAUNCH(32, false, kCountsGlobal);
  else
    err = counts == kCountsFixed ? (smem_lut ? EM_LAUNCH(kThreads, true, kCountsFixed) : EM_LAUNCH(kThreads, false, kCountsFixed))
          : counts == kCountsFloat ? (smem_lut ? EM_LAUNCH(kThreads, true, kCountsFloat) : EM_LAUNCH(kThreads, false, kCountsFloat))
          : EM_LAUNCH(kThreads, false, kCountsGlobal);
#undef EM_LAUNCH
  if (err != cudaSuccess || C == nullptr) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  round_counts_kernel<<<sms * 4, kThreads, 0, st>>>(Cd, C, (size_t)M * R1 * W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ll_reduce_kernel<<<M, kThreads, 0, st>>>(logz, N, ll);
  return cudaGetLastError();
}

}  // namespace
