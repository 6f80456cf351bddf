// Philox4x32-10, the counter-based generator of Random123 (Salmon, Moraes,
// Dror and Shaw, "Parallel random numbers: as easy as 1, 2, 3", SC 2011),
// which cuRAND's curand_Philox4x32_10 also computes: ten rounds of two
// 32x32->64 products and xors over a 128-bit counter, the 64-bit key bumped
// by the Weyl constants between rounds.  A draw is a pure function of
// (counter, key), so a kernel derives each draw from its indices, the way
// the reference's jax.random derives keys with fold_in and split.
//
// The plain version is ops/cuda_draws.py::philox4x32_10 (the same rounds in
// int64 arithmetic); tests/test_torch_draws.py holds it to Random123's
// known-answer vectors, and chip_smoke.py holds this one to cuRAND's.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kPhiloxM0 = 0xD2511F53u;
constexpr unsigned kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u;
constexpr unsigned kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox_round(uint4 c, uint2 k) {
  const unsigned hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
  const unsigned hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
  return make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
}

// The four output words of counter c under key k.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    c = philox_round(c, k);
  }
  return c;
}

}  // namespace
