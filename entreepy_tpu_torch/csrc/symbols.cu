// Stream-order symbol extraction for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package fetches a decode's symbol plane and selects its live
// slots on the host (a numpy boolean selection over every slot), and so did this port before the
// selection moved here. Each lane (a chunk of the body) holds a column of items in a k-major
// [rows, lanes] grid; an item carries a few symbols, and each lane's symbols, in row order, go to
// the lane's place in the output, lane after lane: the stream order. Two forms share that walk:
//   * packed (m <= 3, the one-pass route): an item is the fused pass's masked word, int32
//     `count | 16*invalid` << 8m, then the m symbol bytes, the first symbol highest;
//   * plane (m > 3, and the two-pass routes): an item is one slot of the compaction kernel's
//     subgroup plane uint8[Gs*cap, lanes], live while the slot lies below its subgroup's total
//     (mini_tot int32[Gs, lanes]); the walk reads it as a packed word of m = 1.
// Two launches: et_symbol_counts (packed form; the plane form's totals are its subgroup totals)
// walks the words for each lane's symbol total and w_inv, the symbols before the lane's first
// invalid word (kNoInvalid when none); the caller scans the totals into int64 ends and sizes the
// output by the last; et_symbol_write walks the items again and writes each lane's symbols from
// ends[lane - 1] on.
//
// What bounds it is device-memory traffic: the packed form reads 4 B per body byte and writes
// ~1.7 B of symbols, so a 65,536-lane tile (33.5 MB of body) reads 134 MB and writes ~57 MB. One
// thread walking each lane would read coalesced words but scatter its stores ~880 B from its
// neighbours', a sector per byte. So the walk goes across rows instead of across lanes:
//   * a block owns kTileLanes = 32 lanes and stages kChunkRows rows of their items at a time in
//     shared memory, each row one coalesced run (128 B of words, 32 B of plane bytes), every
//     thread's loads in flight at once;
//   * each warp then walks one lane of the tile at a time, 32 staged rows per round, one row a
//     thread (rows are padded to 33 words, so a lane's 32 rows sit in 32 banks); an inclusive
//     warp scan of the rows' counts places each thread's symbols, so a round's stores land in one
//     contiguous run of at most 96 bytes, a few sectors;
//   * the count launch sums the same rounds, and a ballot finds the lane's first invalid row.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanesPerWarp = kTileLanes / kWarps;
constexpr int kChunkRows = 64;         // two rounds of a warp's walk
constexpr int kPitch = kTileLanes + 1;  // words per staged row
constexpr int32_t kNoInvalid = 1 << 30;  // decode8.NO_INVALID

// Item r of `lane` as a packed word; a plane slot is a word of m = 1: live << 8 | its byte.
template <bool PLANE>
__device__ __forceinline__ uint32_t item(const void* __restrict__ items,
                                         const int32_t* __restrict__ mini_tot, int r, int lane,
                                         int lanes, int cap) {
  const size_t o = (size_t)r * lanes + lane;
  if constexpr (PLANE) {
    const int g = r / cap;
    const uint32_t live = r - g * cap < mini_tot[(size_t)g * lanes + lane];
    return live << 8 | static_cast<const uint8_t*>(items)[o];
  } else {
    return (uint32_t) static_cast<const int32_t*>(items)[o];
  }
}

template <bool PLANE, bool WRITE>
__global__ void __launch_bounds__(kThreads)
    symbols_kernel(const void* __restrict__ items, const int32_t* __restrict__ mini_tot, int rows,
                   int lanes, int m, int cap, const int64_t* __restrict__ ends,
                   uint8_t* __restrict__ out, int32_t* __restrict__ lane_tot,
                   int32_t* __restrict__ w_inv) {
  __shared__ uint32_t staged[kChunkRows * kPitch];
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const int lane0 = blockIdx.x * kTileLanes;
  const int shift = 8 * m;
  // the warp's lanes of the tile, lane0 + warp + i * kWarps: each one's next output byte (WRITE),
  // its symbols so far and its w_inv (the counts)
  long long pos[kLanesPerWarp];
  int tot[kLanesPerWarp], inv_at[kLanesPerWarp];
#pragma unroll
  for (int i = 0; i < kLanesPerWarp; ++i) {
    const int lane = lane0 + warp + i * kWarps;
    pos[i] = WRITE && lane > 0 && lane < lanes ? ends[lane - 1] : 0;
    tot[i] = 0;
    inv_at[i] = kNoInvalid;
  }
  for (int r0 = 0; r0 < rows; r0 += kChunkRows) {
    const int n = min(kChunkRows, rows - r0);
    // thread (warp, t) stages rows warp, warp + kWarps, ... of lane t; rows past the grid's end
    // and lanes past its edge stage 0, an item of no symbols
#pragma unroll
    for (int r = warp; r < kChunkRows; r += kWarps) {
      const int lane = lane0 + t;
      staged[r * kPitch + t] =
          r < n && lane < lanes ? item<PLANE>(items, mini_tot, r0 + r, lane, lanes, cap) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kLanesPerWarp; ++i) {
      const int c = warp + i * kWarps;
      if (lane0 + c >= lanes) continue;  // the same for the whole warp
      for (int rr = 0; rr < n; rr += 32) {
        const uint32_t w = staged[(rr + t) * kPitch + c];
        const uint32_t raw = w >> shift;
        const int cnt = raw & 15;
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (t >= d) incl += y;
        }
        const int excl = incl - cnt;
        if constexpr (WRITE) {
          uint8_t* dst = out + pos[i] + excl;
          for (int j = 0; j < cnt && j < m; ++j) dst[j] = (uint8_t)(w >> (8 * (m - 1 - j)));
        } else {
          const unsigned bad = __ballot_sync(kFull, raw >= 16);
          const int first = __shfl_sync(kFull, excl, bad ? __ffs(bad) - 1 : 0);
          if (bad && inv_at[i] == kNoInvalid) inv_at[i] = tot[i] + first;
        }
        const int sum = __shfl_sync(kFull, incl, 31);
        pos[i] += sum;
        tot[i] += sum;
      }
    }
    __syncthreads();  // every walk read the chunk before the next one is staged
  }
  if constexpr (!WRITE) {
#pragma unroll
    for (int i = 0; i < kLanesPerWarp; ++i) {
      const int lane = lane0 + warp + i * kWarps;
      if (t == 0 && lane < lanes) {
        lane_tot[lane] = tot[i];
        w_inv[lane] = inv_at[i];
      }
    }
  }
}

}  // namespace

// Packed words int32[rows, lanes] -> lane_tot, w_inv int32[lanes].
extern "C" int et_symbol_counts(const void* words, int rows, int lanes, int m, void* lane_tot,
                                void* w_inv, void* stream) {
  symbols_kernel<false, false><<<et::blocks_for(lanes, kTileLanes), kThreads, 0,
                                 (cudaStream_t)stream>>>(
      words, nullptr, rows, lanes, m, 1, nullptr, nullptr, (int32_t*)lane_tot, (int32_t*)w_inv);
  return (int)cudaGetLastError();
}

// Packed words int32[rows, lanes] (mini_tot null), or a plane uint8[rows = Gs*cap, lanes] with its
// subgroup totals mini_tot int32[Gs, lanes] -> out uint8[ends[lanes - 1]] in stream order; ends
// int64[lanes] is the inclusive scan of the lanes' symbol counts.
extern "C" int et_symbol_write(const void* items, const void* mini_tot, int rows, int lanes,
                               int m, int cap, const void* ends, void* out, void* stream) {
  const int blocks = et::blocks_for(lanes, kTileLanes);
  if (mini_tot != nullptr)
    symbols_kernel<true, true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        items, (const int32_t*)mini_tot, rows, lanes, 1, cap, (const int64_t*)ends,
        (uint8_t*)out, nullptr, nullptr);
  else
    symbols_kernel<false, true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        items, nullptr, rows, lanes, m, 1, (const int64_t*)ends, (uint8_t*)out, nullptr,
        nullptr);
  return (int)cudaGetLastError();
}
