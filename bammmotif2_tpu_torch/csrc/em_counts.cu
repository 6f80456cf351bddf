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
// What bounds it on this card: not bytes (16 MB of cidx at bench's geometry
// is 4.8 us at 3.35 TB/s) but shared memory: W LUT reads a window to score
// it and W count atomics a window to scatter r.  PR 1's version scored every
// window twice and added r with one atomic per (window, j) into a [R1, W]
// table; removing those atomics halved its time, transposing the table alone
// took 27% off (PERF.md, PR 5, Step 0): at W=12 the [R1, W] addresses of
// one column fold onto 8 of the 32 banks, and the 32 windows of a warp share
// few k-mers, so same-address atomics serialise.
//
// What the design does about it:
//   * a team owns one sequence at a time: a warp where S * L is at most the
//     wrapper's threshold (rows of 200 bp), so log Z reduces by shuffles and
//     no block barrier is crossed per sequence; a whole block for longer
//     rows;
//   * the team stages the sequence's codes, both strands, in shared memory
//     once, and every seed of the block reads them there;
//   * each window is scored once: the team keeps the S * nwin log-weights
//     in shared memory between the log-sum-exp and the scatter, and turns
//     them into r in place.  A row whose codes do not fit the block's buffer
//     goes in tiles of one strand, and is then scored twice (once for log Z,
//     once for r), as PR 1's version did;
//   * the LUT and the privatised counts sit in shared memory transposed to
//     [W, R1]: lanes at one column j and different codes spread over the
//     banks.  The LUT is transposed on staging, the counts on the flush;
//   * where it fits (up to K=4 at W=12) the count table holds 64-bit fixed
//     point in units of 2^-48, two uint32 words an entry: integer atomics
//     are native where float ones loop on compare-and-swap, and a block's
//     partial sums come out exact whatever the order of its adds (float
//     partials left the counts 4x further from float64 than the plain
//     version, enough to move config 4's FDR scores past their bar).  A
//     table that fits only as float (K=4 at W=30) keeps one float word an
//     entry;
//   * the scatter is position-major: lane p holds the code c_p of position p
//     and owes r[p - j] to count (c_p, j) for each j, read from the r kept
//     in shared memory.  Lanes of a warp that hold the same code are found
//     with __match_any_sync: lanes in small groups add their own r (few
//     same-address meetings: at K=2 a warp's 32 positions draw on 64
//     k-mers), and each group of kBigGroup lanes or more (a homopolymer run
//     puts all 32 in one) is summed by a shuffle reduction and added once
//     per j.  Every lane stays busy: a leader summing its group's r
//     serially left the others idle;
//   * where one seed's counts do not fit in shared memory (A=4, K=5: 262
//     KB) the scatter adds to the float64 global counts directly, and where
//     the LUT does not fit beside the counts it is read through the
//     read-only path in its own [R1, W] layout;
//   * in the EM loop a group's seeds freeze tens to hundreds of iterations
//     apart, and the loop runs until the last one stops: there the launch
//     reads the loop's running flag, v_diffs and epsilon on the device and
//     deals all its blocks to the seeds still active (em.cuh's deal_block),
//     so a frozen seed costs no pass and the others take its blocks;
//   * global counts are float64 (Cd; fp64 global atomics are native on
//     sm_90) and a second kernel rounds them into C once; ll comes from a
//     third, fixed-order kernel (double accumulation), so it does not depend
//     on block scheduling.
// The float atomics add in an order that varies from run to run, so C is
// reproducible only to rounding.  expf/logf/log1pf are IEEE f32 (the build
// does not use --use_fast_math).  The pass and its launcher live in em.cuh,
// shared with flat_em_kernel (flat.cu), which runs them on base-(A+1) codes.

#include "em.cuh"

namespace {

// em.cuh's pass on combined-row codes, for the seeds of chunk blockIdx.y,
// or, with act's running flag, for the active seed its block is dealt.
template <int kTeam, bool kSmemLut, int kCounts>
__global__ void __launch_bounds__(kThreads)
em_counts_kernel(const int* __restrict__ cidx, const int* __restrict__ lens,
                 const float* __restrict__ s_flat, const float* __restrict__ q,
                 double* __restrict__ Cd, float* __restrict__ logz,
                 int S, int N, int L, int W, int R1, int M,
                 int seeds_per_block, int table_floats, int codes_cap, SeedActivity act) {
  em_pass<kTeam, kSmemLut, kCounts>(cidx, lens, s_flat, q, Cd, logz, S, N, L, W, R1, M,
                                    seeds_per_block, table_floats, codes_cap, act,
                                    CombinedRows{});
}

}  // namespace

extern "C" {

// Launches the kernels on `stream` (em.cuh's em_run): Cd ([M, R1, W] f64)
// must be zeroed by the caller; C, logz and ll are written in full, or, with
// C and ll null, the pass alone runs (Cd and logz are its results).  The plan
// is ops/cuda_em.py::launch_plan's (seeds_per_block, smem_lut, counts: 0
// float64 global atomics, 1 a float shared table, 2 a fixed-point shared
// table; team 32 or 256; codes_cap).  running, vds and eps (the EM loop's
// state: bool [], f32 [M], f32 []; all null or none) make the pass serve only
// the active seeds, one a block: a frozen seed's Cd and logz rows are left as
// they are.
// Returns a cudaError_t (0 = success) from the launch checks.
int em_counts_launch(const int* cidx, const int* lens, const float* s_flat,
                     const float* q, float* C, double* Cd, float* logz, float* ll,
                     const bool* running, const float* vds, const float* eps,
                     int S, int N, int L, int W, int R1, int M,
                     int seeds_per_block, int smem_lut, int counts, int team,
                     int codes_cap, void* stream) {
  const bool dealt = running != nullptr;
  if ((vds != nullptr) != dealt || (eps != nullptr) != dealt || (dealt && seeds_per_block != 1))
    return (int)cudaErrorInvalidValue;
  auto pick = [](auto team_c, auto lut_c, auto counts_c) {
    return em_counts_kernel<decltype(team_c)::value, decltype(lut_c)::value,
                            decltype(counts_c)::value>;
  };
  return (int)em_run(pick, cidx, lens, s_flat, q, C, Cd, logz, ll, S, N, L, W, R1, M,
                     seeds_per_block, smem_lut, counts, team, codes_cap,
                     static_cast<cudaStream_t>(stream), SeedActivity{running, vds, eps});
}

const char* em_counts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
