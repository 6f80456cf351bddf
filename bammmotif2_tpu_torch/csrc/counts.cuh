// Counts from external responsibilities, one seed's share a block: the device
// routine of counts_kernel (counts_from_r.cu) and flat_counts_kernel
// (flat.cu).  They differ only in how a code names its count row: the
// combined-row code itself, or base-(A+1) codes through the table map5.
//
// Contract for one seed (row-major, contiguous):
//   r      f32   [S*N*L]  responsibilities; only window starts i < L-W+1 are
//                         read (i = e mod L for the flat index e)
//   codes  int32 [S*N*L]  laid out like r; row of window e at offset j is
//                         row_of(codes[e + j])
// output  C f32 [R1, W] with C[row, j] += r[e] over the window starts, summed
//         in float64 and rounded once.
//
// What bounds it on this card: the read of r, since the Gibbs sampler's r
// holds at most one non-zero a row (bench's 10k x 200 bp, S=2: 16 MB for
// 10k non-zeros).  So a block streams its own contiguous share of the flat
// plane in 16-byte loads, kCountsUnroll of them in flight a thread, with a
// scalar head and tail where the plane is not 16-byte aligned, and a warp
// votes on each load before it looks at a value.  A non-zero value at a
// window start is not counted where it is found: the W code reads behind it
// would stall the stream (W dependent loads a value; counted in place, the
// kernel took 2-5x its read alone).  Its offset goes to its warp's queue in
// shared memory instead (a ballot; the warp keeps the count in a register,
// so no atomic and no block barrier), and the warp drains its queue, one
// (value, offset j) pair a lane with four pairs' loads in flight, when the
// next chunk could overflow it and at the end.  Fractional r (every window
// non-zero) drains every chunk; its W atomics a window set its pace.
//
// The sum across blocks runs in the same launch.  Blocks flush their non-zero
// shared-memory entries into the float64 accumulator `acc` (or, where the
// table does not fit in shared memory, add to it directly), fence, and take
// a ticket; the last block of the seed writes C = (float)acc, zeroes acc and
// resets the ticket.  So acc and the ticket are zero before and after every
// launch, a call is one kernel, and a CUDA graph may replay it.  Shared-memory
// partials are f32: exact for 0/1 r up to 2^24 a cell.  The atomics add in an
// order that varies from run to run, so fractional C is reproducible only to
// rounding; 0/1 C is exact.

#pragma once

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kCountsUnroll = 4;                            // float4 loads a thread a chunk
constexpr int kCountsChunk = kThreads * kCountsUnroll * 4;  // floats a block reads a chunk
constexpr int kWarpDrainAt = 128;                           // queued values that force a drain
// a warp's queue: kWarpDrainAt, a chunk's values of a warp, the head and tail
constexpr int kWarpQueue = kWarpDrainAt + 32 * kCountsUnroll * 4 + 8;

struct CombinedRows {  // the code is the combined row
  __device__ __forceinline__ int operator()(int c) const { return c; }
};

template <bool kSmem>
struct MappedRows {  // the row is map[code], from shared memory or through L1
  const int* map;
  __device__ __forceinline__ int operator()(int c) const {
    if constexpr (kSmem) return map[c];
    else return __ldg(map + c);
  }
};

// One block's share of a seed's counts, then, in the seed's last block, C.
// Cs: the block's zeroed shared [R1*W] f32 table, or nullptr to add to acc
// directly.  acc [R1*W] f64 and *ticket are zero on entry and are left zero.
// Every thread of the block calls it; the seed's blocks are gridDim.x.
template <typename RowOf>
__device__ __forceinline__ void counts_pass(const float* __restrict__ r,
                                            const int* __restrict__ codes, long long plane,
                                            int L, int W, int RW, RowOf row_of, float* Cs,
                                            double* __restrict__ acc,
                                            unsigned* __restrict__ ticket,
                                            float* __restrict__ C) {
  __shared__ unsigned queues[kWarps * kWarpQueue];  // offsets from qbase of values to count
  __shared__ bool last;
  const int nwin = L - W + 1;
  const bool narrow = plane <= 0xffffffffLL;
  const int lane = threadIdx.x & 31;
  unsigned* queue = queues + (threadIdx.x >> 5) * kWarpQueue;  // this warp's
  int queued = 0;                                             // warp-uniform

  // r is 4-byte aligned; the head runs to the first 16-byte boundary
  const int mis = (int)((reinterpret_cast<uintptr_t>(r) & 15) >> 2);
  const long long head = min(plane, (long long)((4 - mis) & 3));
  const long long nvec = (plane - head) >> 2;
  const long long tail = plane - head - 4 * nvec;
  const float4* rv = reinterpret_cast<const float4*>(r + head);
  const long long span = (nvec + gridDim.x - 1) / gridDim.x;  // float4s a block
  const long long v0 = min(nvec, (long long)blockIdx.x * span);
  const long long v1 = min(nvec, v0 + span);
  const long long qbase = blockIdx.x == 0 ? 0 : head + 4 * v0;

  // Every lane of the warp calls it together; queues the value x at queue
  // offset o (flat index qbase + o) where x != 0 and it is a window start.
  auto push = [&](int o, float x) {
    bool keep = x != 0.f;
    if (keep) {
      const long long e = qbase + o;
      keep = (narrow ? (long long)((unsigned)e % (unsigned)L) : e % L) < nwin;
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) queue[queued + __popc(m & ((1u << lane) - 1))] = (unsigned)o;
    queued += __popc(m);
  };
  // Every lane of the warp calls it together: counts the warp's queued
  // values, one (value, j) pair a lane, four pairs' loads in flight.
  auto drain = [&]() {
    __syncwarp();
    const int pairs = queued * W;
    for (int p0 = lane; p0 < pairs; p0 += 4 * 32) {
      float x[4];
      int row[4], j[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = p0 + u * 32;
        x[u] = 0.f;
        if (p < pairs) {
          const int t = p / W;
          j[u] = p - t * W;
          const long long e = qbase + queue[t];
          x[u] = __ldg(r + e);
          row[u] = row_of(__ldg(codes + e + j[u]));
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (x[u] == 0.f) continue;
        if (Cs != nullptr) atomicAdd(Cs + row[u] * W + j[u], x[u]);
        else atomicAdd(acc + (size_t)row[u] * W + j[u], (double)x[u]);
      }
    }
    __syncwarp();
    queued = 0;
  };

  if (threadIdx.x < 32) {  // lanes 0-3 of block 0 the head, lanes 4-7 of the last block the tail
    const bool in_head = blockIdx.x == 0 && lane < head;
    const bool in_tail = blockIdx.x == gridDim.x - 1 && lane >= 4 && lane - 4 < tail;
    const long long e = in_head ? lane : head + 4 * nvec + (lane - 4);
    push((int)(e - qbase), in_head || in_tail ? r[e] : 0.f);
  }
  // this block's share in 32-bit offsets (counts_grid keeps it under 2^30 floats)
  const float4* rb = rv + v0;
  const int nb = (int)(v1 - v0);
  const int ob = (int)(head + 4 * v0 - qbase);  // queue offset of its first value
  for (int c = 0; c < nb; c += kThreads * kCountsUnroll) {
    float4 v[kCountsUnroll];
#pragma unroll
    for (int u = 0; u < kCountsUnroll; ++u) {
      const int k = c + u * kThreads + threadIdx.x;
      v[u] = k < nb ? __ldcs(rb + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kCountsUnroll; ++u) {
      const bool nz = v[u].x != 0.f || v[u].y != 0.f || v[u].z != 0.f || v[u].w != 0.f;
      if (!__any_sync(0xffffffffu, nz)) continue;
      const int o = ob + 4 * (c + u * kThreads + threadIdx.x);
      push(o, v[u].x);
      push(o + 1, v[u].y);
      push(o + 2, v[u].z);
      push(o + 3, v[u].w);
    }
    if (queued > kWarpDrainAt) drain();
  }
  if (queued > 0) drain();

  if (Cs != nullptr) flush_counts(Cs, acc, RW);
  __threadfence();  // this thread's adds to acc are visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k0 = threadIdx.x; k0 < RW; k0 += kThreads * 4) {
    double x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * kThreads;
      x[u] = k < RW ? __ldcg(acc + k) : 0.0;  // from L2, where the atomics landed
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * kThreads;
      if (k < RW) {
        C[k] = (float)x[u];
        acc[k] = 0.0;
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// Grid x a seed for `resident` blocks over `seeds` seeds of `plane` floats:
// the resident blocks split over the seeds, rounded down (a block past the
// resident ones would stream its whole share after the others), capped by
// the chunks a seed holds, at least 1, and enough that a block's share
// (2^30 floats at most) keeps the queue's 32-bit offsets.
inline int counts_grid(long long resident, int seeds, long long plane) {
  long long g = resident / seeds;
  const long long work = (plane + kCountsChunk - 1) / kCountsChunk;
  g = work < g ? work : g;
  const long long least = (plane >> 30) + 1;
  return (int)(g < least ? least : g);
}

}  // namespace
