// The encode's bit-granular stitch for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package fetches the encode's compacted plane and stitches the
// blocks' bitstreams on the host, and so did this port before the stitch moved here. The block
// pack (pack.cu) codes each block of the input on its own, and the compaction (compact.cu) moves
// each (block, subgroup)'s emitted words to the front of its column of a k-major plane
// int32[G*cap, lanes]: row g*cap + j of lane l is block l's j-th word of subgroup g, live while
// j < counts[g, l]. Each block ends in a partial word, acc[l], of nbits[l] bits. The .et body is
// one bitstream, so block l's words go to bit offs[l] of the tile's stream (the exclusive scan of
// the blocks' bit lengths plus the tile's base shift, 0-31, computed by the caller), and the
// stream is written as big-endian bytes: bit 0 is the MSB of byte 0.
//
// What bounds it is device-memory traffic: the plane is read once (~34 MB a 32 MiB tile of text,
// ~58 % of it live) and the stream written once (~19.7 MB). Each word lands at an arbitrary bit
// offset, so it touches two output words, and two blocks may share one output word. Their bits
// never overlap, so OR and add agree, and the kernel ORs: every nonzero half-word goes out as one
// atomicOr (a reduction the L2 performs, no return) into a zeroed output, which gives the same
// bytes in any order. A thread per block walking its column would read a sector per word; the
// walk goes across rows instead, as symbols.cu's does:
//   * a block of the grid owns kTileLanes = 32 lanes and stages kChunkRows rows of their plane
//     at a time in shared memory, each row one coalesced 128-byte run;
//   * each warp walks one lane of the tile at a time, 32 staged rows per round, one row a thread
//     (rows padded to 33 words, so a lane's 32 rows sit in 32 banks); a ballot of the live rows
//     and a popcount give each live word its place in the lane's stream, so a round's atomics
//     fall on consecutive output words;
//   * after the rows, each lane's partial word (its bits past nbits masked off) goes out the same
//     way, and thread 0 ORs in `carry`, the previous tile's last partial word, where the tile
//     starts inside a word.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanesPerWarp = kTileLanes / kWarps;
constexpr int kChunkRows = 64;          // two rounds of a warp's walk
constexpr int kPitch = kTileLanes + 1;  // words per staged row

__device__ __forceinline__ uint32_t big_endian(uint32_t w) { return __byte_perm(w, 0, 0x0123); }

// OR the 32 bits of `w` into the stream at bit `pos`: its high part into word pos / 32, the rest
// into the next word. A zero part is skipped, so nothing is written past the stream's last bit.
__device__ __forceinline__ void or_at(uint32_t* __restrict__ out, long long pos, uint32_t w) {
  const long long q = pos >> 5;
  const int s = (int)(pos & 31);
  const uint32_t hi = w >> s;
  const uint32_t lo = s ? w << (32 - s) : 0u;
  if (hi) atomicOr(out + q, big_endian(hi));
  if (lo) atomicOr(out + q + 1, big_endian(lo));
}

__global__ void __launch_bounds__(kThreads)
    stitch_kernel(const uint32_t* __restrict__ plane, const int32_t* __restrict__ counts,
                  const uint32_t* __restrict__ acc, const int32_t* __restrict__ nbits,
                  const int64_t* __restrict__ offs, int rows, int lanes, int cap,
                  const uint32_t* __restrict__ carry, uint32_t* __restrict__ out) {
  __shared__ uint32_t staged[kChunkRows * kPitch];
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const int lane0 = blockIdx.x * kTileLanes;
  if (carry != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && *carry) atomicOr(out, *carry);
  // the bit offset of the next word of each of the warp's lanes, lane0 + warp + i * kWarps
  long long pos[kLanesPerWarp];
#pragma unroll
  for (int i = 0; i < kLanesPerWarp; ++i) {
    const int lane = lane0 + warp + i * kWarps;
    pos[i] = lane < lanes ? offs[lane] : 0;
  }
  for (int r0 = 0; r0 < rows; r0 += kChunkRows) {
    const int n = min(kChunkRows, rows - r0);
    // thread (warp, t) stages rows warp, warp + kWarps, ... of lane t; rows past the plane's end
    // and lanes past its edge stage 0 and are never live
#pragma unroll
    for (int r = warp; r < kChunkRows; r += kWarps) {
      const int lane = lane0 + t;
      staged[r * kPitch + t] = r < n && lane < lanes ? plane[(size_t)(r0 + r) * lanes + lane] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kLanesPerWarp; ++i) {
      const int c = warp + i * kWarps;
      const int lane = lane0 + c;
      if (lane >= lanes) continue;  // the same for the whole warp
      for (int rr = 0; rr < n; rr += 32) {
        const int r = r0 + rr + t;
        const int g = r / cap;
        const bool live = rr + t < n && r - g * cap < __ldg(counts + (size_t)g * lanes + lane);
        const unsigned mask = __ballot_sync(kFull, live);
        if (live) {
          const int before = __popc(mask & ((1u << t) - 1u));
          or_at(out, pos[i] + 32LL * before, staged[(rr + t) * kPitch + c]);
        }
        pos[i] += 32LL * __popc(mask);
      }
    }
    __syncthreads();  // every walk read the chunk before the next one is staged
  }
#pragma unroll
  for (int i = 0; i < kLanesPerWarp; ++i) {
    const int lane = lane0 + warp + i * kWarps;
    if (t == 0 && lane < lanes) {
      const int nb = nbits[lane];
      or_at(out, pos[i], nb ? acc[lane] & ~(kFull >> nb) : 0u);
    }
  }
}

}  // namespace

// plane uint32[rows = G*cap, lanes] with counts int32[G, lanes], the blocks' partial words acc
// uint32[lanes] of nbits int32[lanes] bits, each block's bit offset offs int64[lanes], and carry
// (null, or one word ORed into out[0]) -> the stream's words ORed into out, zeroed by the caller,
// as big-endian bytes.
extern "C" int et_stitch_tile(const void* plane, const void* counts, const void* acc,
                              const void* nbits, const void* offs, int rows, int lanes, int cap,
                              const void* carry, void* out, void* stream) {
  stitch_kernel<<<et::blocks_for(lanes, kTileLanes), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)plane, (const int32_t*)counts, (const uint32_t*)acc, (const int32_t*)nbits,
      (const int64_t*)offs, rows, lanes, cap, (const uint32_t*)carry, (uint32_t*)out);
  return (int)cudaGetLastError();
}
