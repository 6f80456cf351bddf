// A known-answer check of philox.cuh against the CUDA toolkit's own
// Philox4x32-10, cuRAND's curand_Philox4x32_10 (curand_kernel.h): both on
// the same (counter, key) pairs.  Not a kernel of the port's paths: built
// and run by chip_smoke.py (ops/cuda_draws.py::philox_pairs).
//
// Contract: ctrs int64 [n, 4], keys int64 [n, 2], words in [0, 2^32);
// mine, theirs int64 [n, 4] <- the four output words of each pair.

#include <curand_kernel.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

__global__ void philox_check_kernel(const long long* __restrict__ ctrs,
                                    const long long* __restrict__ keys,
                                    long long* __restrict__ mine, long long* __restrict__ theirs,
                                    int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint4 c = make_uint4((unsigned)ctrs[4 * p], (unsigned)ctrs[4 * p + 1],
                             (unsigned)ctrs[4 * p + 2], (unsigned)ctrs[4 * p + 3]);
  const uint2 k = make_uint2((unsigned)keys[2 * p], (unsigned)keys[2 * p + 1]);
  const uint4 x = philox4x32_10(c, k);
  const uint4 y = curand_Philox4x32_10(c, k);
  const unsigned a[4] = {x.x, x.y, x.z, x.w}, b[4] = {y.x, y.y, y.z, y.w};
  for (int w = 0; w < 4; ++w) {
    mine[4 * p + w] = a[w];
    theirs[4 * p + w] = b[w];
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = success) from the launch checks.
int philox_check_launch(const long long* ctrs, const long long* keys, long long* mine,
                        long long* theirs, int n, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  philox_check_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      ctrs, keys, mine, theirs, n);
  return (int)cudaGetLastError();
}

const char* philox_check_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
