// Helpers shared by the kernels of entreepy_tpu_torch (plain C interface, bound with ctypes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace et {

// Asynchronous global-to-shared copies (cp.async, sm_80+): a thread issues every copy of its
// share without waiting, so a whole tile's loads are in flight at once and its latency is paid
// once. `src_bytes` 0 fills the destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy an n-byte table from device memory into shared memory with every 16-byte copy in flight
// at once (cp.async); the source and the destination must be 16-byte aligned (the wrappers
// check the source). Ends with the block's barrier.
__device__ __forceinline__ void stage_table_async(uint8_t* dst, const uint8_t* __restrict__ src,
                                                  int n) {
  const int n16 = n >> 4;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) cp_async16(dst + 16 * i, src + 16 * i);
  for (int i = (n16 << 4) + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  cp_async_wait_all();
  __syncthreads();
}

inline int blocks_for(long long items, int threads) {
  return (int)((items + threads - 1) / threads);
}

// The current device's SM count.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace et
