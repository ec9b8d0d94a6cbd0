// Block bit-packer for Hopper (sm_90a).
//
// Replaces pack_blocks_pallas (_pack_kernel) of entreepy_tpu/ops/pallas_pack.py. Per block:
// look up each byte's (code, length), shift the code into a bit accumulator, and at every step
// write the accumulator's high word plus an `emitted` flag (set when 32 bits are complete).
// The final partial word and its bit count are returned per block.
//
// On the TPU the lookup was a one-hot MXU contraction against a 5-column limb table (kept exact
// in bf16) and the accumulator two int32 halves. Here the 256-entry (code, length) table sits in
// shared memory and the accumulator is one native uint64 in a register.
//
// What bounds it on the card: the per-block serial accumulator chain (steps iterations per
// thread) and device-memory traffic of 1 B read + 5 B written per input byte. One thread owns
// one block; outputs are written k-major ([steps, lanes]) so a warp's stores at step j are
// adjacent, and that is also the layout the compaction kernel reads.

#include "common.cuh"

namespace {

__global__ void pack_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ valid,
                            const uint32_t* __restrict__ codes, const uint8_t* __restrict__ lengths,
                            uint32_t* __restrict__ words, uint8_t* __restrict__ emitted,
                            uint32_t* __restrict__ acc_out, int32_t* __restrict__ nbits_out,
                            int lanes, int steps) {
  __shared__ uint32_t s_code[256];
  __shared__ uint32_t s_len[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_code[i] = codes[i];
    s_len[i] = lengths[i];
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;

  const uint8_t* src = blocks + (size_t)lane * steps;
  const int live = valid[lane];
  uint64_t acc = 0;  // MSB-aligned: bit 63 is the next bit of the block's stream
  int nbits = 0;     // bits held in acc, < 32 between steps
  for (int j = 0; j < steps; ++j) {
    int s = nbits;
    if (j < live) {
      const int b = src[j];
      const int len = (int)s_len[b];  // <= 32, so s <= 63
      s += len;
      if (len) acc |= (uint64_t)s_code[b] << (64 - s);
    }
    const size_t o = (size_t)j * lanes + lane;
    words[o] = (uint32_t)(acc >> 32);
    const bool emit = s >= 32;
    emitted[o] = emit;
    if (emit) {
      acc <<= 32;
      nbits = s - 32;
    } else {
      nbits = s;
    }
  }
  acc_out[lane] = (uint32_t)(acc >> 32);
  nbits_out[lane] = nbits;
}

}  // namespace

extern "C" int et_pack_blocks(const void* blocks, const void* valid, const void* codes,
                              const void* lengths, void* words, void* emitted, void* acc,
                              void* nbits, int lanes, int steps, void* stream) {
  pack_kernel<<<et::blocks_for(lanes, et::kLaneThreads), et::kLaneThreads, 0,
                (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const int32_t*)valid, (const uint32_t*)codes,
      (const uint8_t*)lengths, (uint32_t*)words, (uint8_t*)emitted, (uint32_t*)acc,
      (int32_t*)nbits, lanes, steps);
  return (int)cudaGetLastError();
}
