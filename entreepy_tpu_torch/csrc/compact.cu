// Stable row compaction for Hopper (sm_90a).
//
// Replaces compact_rows_pallas (_compact_kernel) of entreepy_tpu/ops/pallas_compact.py. For each
// (subgroup of `sub` rows, lane) of a k-major [k, lanes] grid: move the rows whose live flag is
// set to the front in order, zero the rest, keep the first `cap` rows, and count the live rows
// (the full count, also when it exceeds cap).
//
// On the TPU this was a doubling-shift network in VMEM, because scatters serialize there. Here
// the compaction is a serial stable walk per (subgroup, lane), and what bounds it on the card is
// device-memory traffic: 5 B read per slot of the grid, 4 B x cap written per (subgroup, lane).
// A walk that reads device memory row by row waits ~600 cycles per row and scatters its stores
// (each thread writes row n of its own count), so the design keeps both ends in shared memory:
//   * a block owns one subgroup g and a tile of kTileLanes = 32 lanes, so each staged row is one
//     warp's 128-byte run; at the encode plane's shapes that is 636 blocks of 4 warps, and many
//     small blocks keep more loads in flight per SM than fewer wide ones (tiles of 64-256 lanes
//     and 256-512 threads were slower at every main-path shape);
//   * it stages the tile's [rows, kTileLanes] values (cp.async, every copy in flight at once)
//     and flags in chunks of kChunkRows rows; each row of a chunk is one contiguous run of
//     device memory;
//   * kSegs segments of a chunk's rows are walked at once: each thread counts its segment's live
//     rows for its lane, the counts give each segment its first output slot, then each thread
//     writes its live values into a [cap, kTileLanes] output tile in shared memory;
//   * the block then stores the output tile row by row, each row one coalesced run, and the
//     counts.
// An output tile wider than kMaxTileCap rows or more than 65,535 subgroups (only at chunk or
// block sizes far from the defaults) take compact_serial_kernel: one thread per (subgroup, lane)
// walking device memory.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTileLanes = 32;
constexpr int kCompactThreads = 128;
constexpr int kSegs = kCompactThreads / kTileLanes;
constexpr int kChunkRows = 64;
constexpr int kMaxTileCap = 1536;  // output tile 192 KB: within a block's 227 KB
constexpr int kSerialThreads = 256;

inline int tile_smem(int cap) {
  return kChunkRows * kTileLanes * 5 + (cap + kSegs + 1) * kTileLanes * 4;
}

__global__ void __launch_bounds__(kCompactThreads)
    compact_tile_kernel(const int32_t* __restrict__ wk, const uint8_t* __restrict__ ek,
                        int32_t* __restrict__ plane, int32_t* __restrict__ counts, int lanes,
                        int sub, int cap) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* vals = smem;                               // [kChunkRows][kTileLanes]
  int32_t* otile = vals + kChunkRows * kTileLanes;    // [cap][kTileLanes]
  int32_t* seg_n = otile + cap * kTileLanes;          // [kSegs][kTileLanes]
  int32_t* run = seg_n + kSegs * kTileLanes;          // [kTileLanes] live rows so far
  uint8_t* flags = reinterpret_cast<uint8_t*>(run + kTileLanes);  // [kChunkRows][kTileLanes]

  const int g = blockIdx.y;
  const int lane0 = blockIdx.x * kTileLanes;
  const int c = threadIdx.x % kTileLanes;  // this thread's lane in the tile
  const int seg = threadIdx.x / kTileLanes;
  const bool in_range = lane0 + c < lanes;
  for (int i = threadIdx.x; i < cap * kTileLanes; i += kCompactThreads) otile[i] = 0;
  if (seg == 0) run[c] = 0;

  const size_t first = (size_t)g * sub * lanes + lane0 + c;  // row 0 of the subgroup
  for (int r0 = 0; r0 < sub; r0 += kChunkRows) {
    const int rows = min(kChunkRows, sub - r0);
    // stage: thread (seg, c) copies rows seg, seg + kSegs, ... of its lane
#pragma unroll 4
    for (int r = seg; r < rows; r += kSegs) {
      const size_t o = first + (size_t)(r0 + r) * lanes;
      et::cp_async4(vals + r * kTileLanes + c, in_range ? wk + o : wk, in_range ? 4 : 0);
      flags[r * kTileLanes + c] = in_range ? ek[o] : 0;
    }
    et::cp_async_wait_all();
    __syncthreads();
    // each segment's live rows, then each segment's first output slot
    const int per = (rows + kSegs - 1) / kSegs;
    const int lo = min(rows, seg * per), hi = min(rows, lo + per);
    int n = 0;
    for (int r = lo; r < hi; ++r) n += flags[r * kTileLanes + c];
    seg_n[seg * kTileLanes + c] = n;
    __syncthreads();
    n = run[c];
    for (int v = 0; v < seg; ++v) n += seg_n[v * kTileLanes + c];
    for (int r = lo; r < hi; ++r) {
      if (flags[r * kTileLanes + c]) {
        if (n < cap) otile[n * kTileLanes + c] = vals[r * kTileLanes + c];
        ++n;
      }
    }
    __syncthreads();  // every walk read run[c] and the chunk before they change
    if (seg == kSegs - 1) run[c] = n;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap * kTileLanes; i += kCompactThreads) {
    const int j = i / kTileLanes, cc = i % kTileLanes;
    if (lane0 + cc < lanes) plane[((size_t)g * cap + j) * lanes + lane0 + cc] = otile[i];
  }
  if (seg == 0 && in_range) counts[(size_t)g * lanes + lane0 + c] = run[c];
}

__global__ void compact_serial_kernel(const int32_t* __restrict__ wk,
                                      const uint8_t* __restrict__ ek, int32_t* __restrict__ plane,
                                      int32_t* __restrict__ counts, int lanes, int groups, int sub,
                                      int cap) {
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
  if (cap > kMaxTileCap || groups > 65535) {
    compact_serial_kernel<<<et::blocks_for((long long)groups * lanes, kSerialThreads),
                            kSerialThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)wk, (const uint8_t*)ek, (int32_t*)plane, (int32_t*)counts, lanes, groups,
        sub, cap);
    return (int)cudaGetLastError();
  }
  const int smem = tile_smem(cap);
  cudaError_t err = cudaFuncSetAttribute(compact_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(et::blocks_for(lanes, kTileLanes), groups);
  compact_tile_kernel<<<grid, kCompactThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)wk, (const uint8_t*)ek, (int32_t*)plane, (int32_t*)counts, lanes, sub, cap);
  return (int)cudaGetLastError();
}
