// Helpers shared by the kernels of entreepy_tpu_torch (plain C interface, bound with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace et {

// Threads per block of the one-thread-per-lane kernels. Small blocks spread a body's lanes
// over as many SMs as possible: the lanes' serial chains, not the thread count, bound them.
constexpr int kLaneThreads = 64;

// Copy an n-byte table from device memory into shared memory (16 B per thread-step; the
// wrapper hands a 16-byte aligned source), then wait for the whole block.
__device__ __forceinline__ void stage_table(uint8_t* dst, const uint8_t* __restrict__ src, int n) {
  const int n16 = n >> 4;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) d4[i] = s4[i];
  for (int i = (n16 << 4) + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

inline int blocks_for(long long items, int threads) {
  return (int)((items + threads - 1) / threads);
}

}  // namespace et
