// The one-pass decode's tables, built on the card from the code trie, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its decode tables in NumPy on the host
// (format/fsm8.py: _build_byte_fsm, then fused_decode_tensors), and so did this port before the
// build moved here. The host keeps only the code trie (fsm8._build_trie, <= 255 internal nodes),
// packed as one 16-bit entry per edge: 0 for a dead edge, kLeaf | symbol, or kChild | node. The
// packed trie (1 KB at most) travels in the launch's parameters, so nothing is uploaded and no
// scratch is allocated: the kernel writes every byte of the two tables that DecodeTables holds,
//   * next_state uint8[S, 256]: the state after a byte, 0 on a padding row and on a walk that
//     crosses a dead edge (ByteFsm.next_state);
//   * fused uint8[256, 2s + 9(mt + 2)]: fused_decode_tensors' layout, one row per byte.
// One block per byte value b, one thread per state (S = 128 or 256 threads). Each thread walks
// the byte's 8 bits from its state: the whole walk gives next_state[state, b], the first code
// completed in it gives fused[b, state] (the first symbol, or the continuation state when no
// code completes) and fused[b, s + state] (p + 16 * invalid_first). Threads p = 0..8 of the
// block also walk bits p..7 from the root (the tail after a first code that ends at bit p; row
// p = 0 stays zero) for the tail columns: count + 16 * invalid, the mt symbol slots and the end
// state.
//
// What bounds it is the launch: it writes ~90 KB (32 KB of next_state and 256 rows of 2s +
// 9(mt + 2) bytes: 228 B at the text's s = 96, m = 3) and reads nothing from device memory.

#include <string.h>

#include "common.cuh"

namespace {

constexpr int kMaxNodes = 256;     // fsm8.N_STATES
constexpr int kTail = 9;           // p = 0..8
constexpr int kMaxTailSlots = 7;   // mt = m - 1 <= 7
constexpr uint16_t kLeaf = 0x100;  // cuda_tables.LEAF
constexpr uint16_t kChild = 0x200;  // cuda_tables.CHILD

struct Trie {
  uint16_t edge[2 * kMaxNodes];  // edge[2 * node + bit]
};

__device__ __forceinline__ int bit_of(int b, int i) { return (b >> (7 - i)) & 1; }

__global__ void __launch_bounds__(kMaxNodes)
    tables_kernel(const __grid_constant__ Trie trie, int n_int, int s, int mt,
                  uint8_t* __restrict__ next_state, uint8_t* __restrict__ fused) {
  __shared__ uint16_t edge[2 * kMaxNodes];
  for (int i = threadIdx.x; i < 2 * n_int; i += blockDim.x) edge[i] = trie.edge[i];
  __syncthreads();
  const int b = blockIdx.x, state = threadIdx.x;
  uint8_t* row = fused + (size_t)b * (2 * s + kTail * (mt + 2));

  // The state's walk; a padding row (state >= n_int) walks from the root, invalid from the start.
  bool invalid = state >= n_int, done = invalid, inv_first = invalid;
  int node = invalid ? 0 : state, first = 0, p = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint16_t e = edge[2 * node + bit_of(b, i)];
    const bool leaf = e & kLeaf, dead = !(e & (kLeaf | kChild));
    if (!done && leaf) {
      first = e & 255;
      p = i + 1;
    }
    inv_first |= !done && dead;
    done |= leaf || dead;
    invalid |= dead;
    node = e & kChild ? e & 255 : 0;
  }
  const int next = invalid ? 0 : node;
  next_state[(size_t)state * 256 + b] = (uint8_t)next;
  if (state < s) {
    row[state] = (uint8_t)(p ? first : next);
    row[s + state] = (uint8_t)(p + 16 * inv_first);
  }

  // The tail from the root after a first code that completed at bit p = state (1..8).
  if (state < kTail) {
    uint8_t sym[kMaxTailSlots] = {};
    int tnode = 0, tcnt = 0;
    bool tinv = false;
    for (int i = state == 0 ? 8 : state; i < 8; ++i) {
      const uint16_t e = edge[2 * tnode + bit_of(b, i)];
      const bool leaf = e & kLeaf, dead = !(e & (kLeaf | kChild));
      if (leaf && !tinv) {
        // past mt symbols (a combination no real walk selects) the last slot is overwritten
        sym[min(tcnt, mt - 1)] = (uint8_t)(e & 255);
        ++tcnt;
      }
      tinv |= dead;
      tnode = e & kChild ? e & 255 : 0;
    }
    uint8_t* tail = row + 2 * s + state;
    tail[0] = (uint8_t)(min(tcnt, mt) + 16 * tinv);
    for (int j = 0; j < mt; ++j) tail[kTail * (1 + j)] = sym[j];
    tail[kTail * (1 + mt)] = (uint8_t)tnode;
  }
}

}  // namespace

// The packed trie uint16[2 * n_int] (host memory, copied into the launch's parameters) ->
// next_state uint8[width, 256] and fused uint8[256, 2s + 9(mt + 2)] on the current device.
extern "C" int et_fsm_tables(const void* edges, int n_int, int width, int s, int mt,
                             void* next_state, void* fused, void* stream) {
  if (n_int < 1 || n_int > kMaxNodes || width < n_int || width > kMaxNodes || s < n_int ||
      s > width || mt < 1 || mt > kMaxTailSlots)
    return (int)cudaErrorInvalidValue;
  Trie trie;
  memset(&trie, 0, sizeof trie);
  memcpy(trie.edge, edges, 2 * sizeof(uint16_t) * n_int);
  tables_kernel<<<256, width, 0, (cudaStream_t)stream>>>(trie, n_int, s, mt,
                                                         (uint8_t*)next_state, (uint8_t*)fused);
  return (int)cudaGetLastError();
}
