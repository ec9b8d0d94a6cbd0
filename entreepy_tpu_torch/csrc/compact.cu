// Stable row compaction for Hopper (sm_90a).
//
// Replaces compact_rows_pallas (_compact_kernel) of entreepy_tpu/ops/pallas_compact.py. For each
// (subgroup of `sub` rows, lane) of a k-major [k, lanes] grid: move the rows whose live flag is
// set to the front in order, zero the rest, keep the first `cap` rows, and count the live rows
// (the full count, also when it exceeds cap).
//
// On the TPU this was a doubling-shift network in VMEM, because scatters serialize there. Here
// one thread walks its subgroup's rows in order and writes each live row to its next slot: a
// serial, stable compaction. With (subgroup, lane) numbered lane-fastest, a warp's reads and
// writes at every row are adjacent addresses, so each row is one coalesced access per warp.
//
// What bounds it on the card: device-memory traffic, 5 B read per slot of the grid and
// 4 B x cap written per (subgroup, lane). Nothing is staged.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void compact_kernel(const int32_t* __restrict__ wk, const uint8_t* __restrict__ ek,
                               int32_t* __restrict__ plane, int32_t* __restrict__ counts,
                               int lanes, int groups, int sub, int cap) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)groups * lanes) return;
  const int g = (int)(idx / lanes);
  const int lane = (int)(idx - (long long)g * lanes);
  const size_t first = (size_t)g * sub * lanes + lane;
  int32_t* dst = plane + (size_t)g * cap * lanes + lane;
  int n = 0;
  for (int r = 0; r < sub; ++r) {
    const size_t o = first + (size_t)r * lanes;
    if (ek[o]) {
      if (n < cap) dst[(size_t)n * lanes] = wk[o];
      ++n;
    }
  }
  for (int r = n; r < cap; ++r) dst[(size_t)r * lanes] = 0;
  counts[(size_t)g * lanes + lane] = n;
}

}  // namespace

extern "C" int et_compact_rows(const void* wk, const void* ek, void* plane, void* counts,
                               int lanes, int groups, int sub, int cap, void* stream) {
  compact_kernel<<<et::blocks_for((long long)groups * lanes, kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>((const int32_t*)wk, (const uint8_t*)ek,
                                           (int32_t*)plane, (int32_t*)counts, lanes, groups, sub,
                                           cap);
  return (int)cudaGetLastError();
}
