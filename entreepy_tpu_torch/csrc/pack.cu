// Block bit-packer for Hopper (sm_90a).
//
// Replaces pack_blocks_pallas (_pack_kernel) of entreepy_tpu/ops/pallas_pack.py. Per block
// (lane) of `steps` bytes, the first valid[lane] of them live: look up each byte's (code,
// length), lay the codes end to end into the block's bit stream, and report at every step j
// whether it completed a 32-bit word (`emitted`) and, where it did, that word (`words`); the
// final partial word (`acc`, MSB-aligned, zero past its bits) and its bit count (`nbits`) are
// returned per block. Words at steps that emit nothing are unspecified: every consumer gates on
// `emitted`.
//
// On the TPU the lookup was a one-hot MXU contraction against a 5-column limb table and the
// accumulator two int32 halves, walked serially over the block. The serial chain is only a
// prefix sum: with off_j the bits of the live codes before step j, a code is at most 32 bits
// and fewer than 32 bits are pending before it, so step j emits exactly when
// (off_j & 31) + len_j >= 32, and the word it emits is stream word off_j >> 5.
//
// What bounds it on the card: device-memory traffic, 1 B read and 5 B written per input byte
// (words uint32[steps, lanes] and emitted bool[steps, lanes], k-major: what the compaction
// reads), and at a few thousand blocks the instructions of the walk itself. The design keeps
// the stores whole and the per-thread chains short:
//   * a CTA owns 32 consecutive blocks; warp w of a round walks steps [64 w, 64 w + 64) of
//     each of them, one block per thread, so at step j a warp's stores are one 128-byte row of
//     words and one 32-byte row of flags;
//   * a thread loads its 64 bytes ahead with 16-byte loads (steps % 16 == 0 and an aligned
//     row; byte loads otherwise), looks lengths up in a shared-memory (code, length) table,
//     and sums them; the CTA turns the sums into each segment's start offset;
//   * the thread then walks its segment with the word in progress in one register, starting
//     empty at bit (offset & 31): a step ORs in the code's bits that fit, and where the word is
//     complete stores it and starts the next with the bits that spilled (a clamped funnel
//     shift, so a 32-bit code at a word boundary needs no 64-bit shift). Every word it
//     completes is exact except the first, which lacks the bits that earlier segments put into
//     it. Each segment leaves the bits of the word it ends in (its tail) in shared memory;
//     after a barrier the first word is completed from the tails (and the carry of earlier
//     rounds) that fall into it and stored again;
//   * a warp whose 32 segments (one per block) are all live walks without per-step guards;
//     the choice is made for the whole warp, because a block that is only partly live (the
//     input's last) would otherwise make its warps run both walks, and at a few thousand
//     blocks that one CTA is the kernel's critical path;
//   * blocks longer than 16 segments take several rounds, the last segment carrying the
//     partial word and the offset into the next round. Any `steps` is taken.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kSeg = 64;          // steps a thread walks per round
constexpr int kBlockLanes = 32;   // blocks (lanes) per CTA, one per thread of a segment
constexpr int kMaxSegs = 16;      // segments per round

// Bytes [j0, j0 + kSeg) of a block's row, four to a word (byte r in bits 8 (r & 3) of word
// r >> 2); bytes at or past `lim` read as 0 and are not loaded. VEC: 16-byte loads, for a
// 16-byte aligned row and lim a multiple of 16.
template <bool VEC>
__device__ __forceinline__ void load_seg(uint32_t (&x)[kSeg / 4], const uint8_t* row, int j0,
                                         int lim) {
  if (VEC) {
#pragma unroll
    for (int c = 0; c < kSeg / 16; ++c) {
      const uint4 v = j0 + 16 * c < lim ? *reinterpret_cast<const uint4*>(row + j0 + 16 * c)
                                        : make_uint4(0, 0, 0, 0);
      x[4 * c] = v.x, x[4 * c + 1] = v.y, x[4 * c + 2] = v.z, x[4 * c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSeg / 4; ++i) {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (j0 + 4 * i + b < lim) w |= (uint32_t)row[j0 + 4 * i + b] << (8 * b);
      x[i] = w;
    }
  }
}

__device__ __forceinline__ int byte_at(const uint32_t (&x)[kSeg / 4], int r) {
  return (x[r >> 2] >> (8 * (r & 3))) & 255;
}

// Walk one segment from bit offset nb into the word in progress `cur` (MSB-aligned): at each
// step add the code's bits that fit, and where the word is complete store it and start the next
// with the bits that spilled over. Records the first complete word and its step. FULL: every step
// is live (and so below `steps`).
template <bool FULL>
__device__ __forceinline__ void walk(const uint2* s_tbl, const uint32_t (&x)[kSeg / 4], int j0,
                                     int steps, int live, int nb, bool in,
                                     uint32_t* __restrict__ words, uint8_t* __restrict__ emitted,
                                     int lanes, int lane, uint32_t& cur, int& j_first,
                                     uint32_t& w_first) {
#pragma unroll
  for (int r = 0; r < kSeg; ++r) {
    const int j = j0 + r;
    if (FULL || j < steps) {
      const uint2 e = s_tbl[byte_at(x, r)];
      const bool on = FULL || j < live;
      const uint32_t code = on ? e.x : 0u;
      const int s = nb + (on ? (int)e.y : 0);  // <= 63
      cur |= code >> nb;
      const bool emit = s >= 32;
      if (emit && j_first < 0) j_first = j, w_first = cur;
      if (in) {
        const size_t o = (size_t)j * lanes + lane;
        words[o] = cur;
        emitted[o] = emit;
      }
      if (emit) cur = __funnelshift_lc(0u, code, 32 - nb);  // code << (32 - nb), 0 at nb = 0
      nb = s & 31;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kBlockLanes * kMaxSegs)
    pack_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ valid,
                const uint32_t* __restrict__ codes, const uint8_t* __restrict__ lengths,
                uint32_t* __restrict__ words, uint8_t* __restrict__ emitted,
                uint32_t* __restrict__ acc_out, int32_t* __restrict__ nbits_out, int lanes,
                int steps) {
  __shared__ uint2 s_tbl[256];                         // (code MSB-aligned in 32 bits, length)
  __shared__ int s_bits[kMaxSegs][kBlockLanes];       // live bits of each segment of the round
  __shared__ uint32_t s_tail[kMaxSegs][kBlockLanes];  // a segment's bits of the word it ends in
  __shared__ int s_off[kBlockLanes];                   // bit offset at the round's start
  __shared__ uint32_t s_carry[kBlockLanes];            // bits of word s_off >> 5 before s_off
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t len = lengths[i];  // <= 32
    s_tbl[i] = make_uint2(len ? codes[i] << (32 - len) : 0u, len);
  }
  const int nw = blockDim.x / kBlockLanes;  // segments per round
  const int t = threadIdx.x % kBlockLanes, w = threadIdx.x / kBlockLanes;
  if (w == 0) s_off[t] = 0, s_carry[t] = 0;
  const int lane = blockIdx.x * kBlockLanes + t;
  const bool in = lane < lanes;
  const int live = in ? min(valid[lane], steps) : 0;
  const uint8_t* row = blocks + (size_t)lane * steps;
  int end = 0;          // the last segment's: bit offset after the round
  uint32_t carry = 0;   // and the bits of word end >> 5 before it
  __syncthreads();

  for (int round = 0; round < steps; round += nw * kSeg) {
    const int j0 = round + w * kSeg;
    uint32_t x[kSeg / 4];
    load_seg<VEC>(x, row, j0, in ? steps : 0);
    // a warp whose segments are all live takes the walks without the per-step guards
    const bool full = __all_sync(0xffffffffu, j0 + kSeg <= live);
    int bits = 0;
    if (full) {
#pragma unroll
      for (int r = 0; r < kSeg; ++r) bits += (int)s_tbl[byte_at(x, r)].y;
    } else {
#pragma unroll
      for (int r = 0; r < kSeg; ++r) bits += j0 + r < live ? (int)s_tbl[byte_at(x, r)].y : 0;
    }
    s_bits[w][t] = bits;
    __syncthreads();

    int off = s_off[t];
    for (int q = 0; q < w; ++q) off += s_bits[q][t];
    const int first = off >> 5;  // the word the segment's first emission completes
    uint32_t cur = 0;            // the word in progress; its bits from before the segment are 0
    int j_first = -1;
    uint32_t w_first = 0;
    if (full)
      walk<true>(s_tbl, x, j0, steps, live, off & 31, in, words, emitted, lanes, lane, cur,
                 j_first, w_first);
    else
      walk<false>(s_tbl, x, j0, steps, live, off & 31, in, words, emitted, lanes, lane, cur,
                  j_first, w_first);
    s_tail[w][t] = cur;
    __syncthreads();

    // the first word gets the bits that the rounds and segments before this one put into it
    int o = s_off[t];
    uint32_t head = (o >> 5) == first ? s_carry[t] : 0u;
    for (int q = 0; q < w; ++q) {
      o += s_bits[q][t];
      if ((o >> 5) == first) head |= s_tail[q][t];
    }
    if (in && j_first >= 0) words[(size_t)j_first * lanes + lane] = w_first | head;
    if (w == nw - 1) {  // the round's partial word, carried into the next round
      end = off + bits;
      o = s_off[t];
      carry = (o >> 5) == (end >> 5) ? s_carry[t] : 0u;
      for (int q = 0; q < nw; ++q) {
        o += s_bits[q][t];
        if ((o >> 5) == (end >> 5)) carry |= s_tail[q][t];
      }
    }
    __syncthreads();
    if (w == nw - 1) s_off[t] = end, s_carry[t] = carry;
  }
  if (w == nw - 1 && in) {
    acc_out[lane] = carry;
    nbits_out[lane] = end & 31;
  }
}

}  // namespace

extern "C" int et_pack_blocks(const void* blocks, const void* valid, const void* codes,
                              const void* lengths, void* words, void* emitted, void* acc,
                              void* nbits, int lanes, int steps, void* stream) {
  if (lanes <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  const int segs = std::max(1, std::min(kMaxSegs, (steps + kSeg - 1) / kSeg));
  const bool vec = steps % 16 == 0 && (uintptr_t)blocks % 16 == 0;
  using Kernel = void (*)(const uint8_t*, const int32_t*, const uint32_t*, const uint8_t*,
                          uint32_t*, uint8_t*, uint32_t*, int32_t*, int, int);
  const Kernel kernel = vec ? Kernel(pack_kernel<true>) : Kernel(pack_kernel<false>);
  kernel<<<et::blocks_for(lanes, kBlockLanes), kBlockLanes * segs, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const int32_t*)valid, (const uint32_t*)codes,
      (const uint8_t*)lengths, (uint32_t*)words, (uint8_t*)emitted, (uint32_t*)acc,
      (int32_t*)nbits, lanes, steps);
  return (int)cudaGetLastError();
}
