// Byte-FSM decode kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of entreepy_tpu/ops/pallas_fsm8.py:
//   et_sync_pass   <- sync_pass_pallas8  (_sync8_kernel):  state-only walk over a chunk suffix
//   et_emit_pass   <- emit_pass_pallas8  (_emit8_kernel):  full walk storing each byte's
//                                                          pre-transition state
//   et_fused_pass  <- fused_pass_pallas8 (_fused_kernel):  one-pass decode sweep
//
// On the TPU every byte's transition was a one-hot MXU contraction against the whole table,
// because the TPU serializes gathers. On the card a transition is a plain table lookup: one
// thread owns one chunk lane, keeps the running state in a register and reads the table from
// shared memory.
//
// What bounds them on the card: the serial state chain. A lane cannot start byte k+1 before
// byte k's state is known. A pass therefore takes about K x (chain latency) once every lane has a
// thread; device-memory traffic is small (1 B read per body byte; emit: 1 B written; fused: 4 B
// written packed, 4(m+1) B unpacked). Every pass reads bytes from the [K, lanes] layout, so a
// warp's loads at step k are one 32-byte sector. The sync and emit passes are one walk
// (walk_kernel); its design and the fused pass's (bytes fetched ahead, lanes per block sized to
// the card) are noted at the kernels below.
//
// Table layouts are those of format/fsm8.py (the JAX package's, copied), as uint8:
//   next_state[S, 256]                       (ByteFsm.next_state)
//   fused[256, C], C = 2s + 9(mt + 2)        (fused_decode_tensors, one row per byte)
// The running state is always a trie node < s: every table entry that feeds it is one.

#include <algorithm>

#include "common.cuh"

namespace {

// Byte k of a lane's column for k < k_len (the loads are issued, not awaited).
template <int R>
__device__ __forceinline__ void load_ring(uint32_t (&ring)[R], const uint8_t* col, int k0,
                                          int k_len, int lanes) {
#pragma unroll
  for (int r = 0; r < R; ++r) ring[r] = k0 + r < k_len ? col[(size_t)(k0 + r) * lanes] : 0;
}

// ---- sync_pass and emit_pass: one state walk ----
//
// walk_kernel<false> replaces sync_pass_pallas8 (_sync8_kernel): each lane walks the last
// w <= 128 bytes of its chunk from the root, state = next_state[state][x], and returns the state
// it ends in. walk_kernel<true> replaces emit_pass_pallas8 (_emit8_kernel): the same walk over
// all K bytes of the chunk from the lane's entry state, storing each byte's state BEFORE its
// transition. The TPU kernel packed four states per int32 word (its store economics); here
// states is uint8[K, lanes] and a warp's stores at step k are 32 adjacent bytes.
//
// What bounds both on this card is the chain (w or K dependent shared-memory loads) plus staging
// the table and the launch; the bytes are a few MB at most. A step is two dependent
// instructions, IMAD (state * 256 + x) and LDS.U8; bank conflicts among a warp's loads barely
// change its latency, and bank-partitioned copies of the table made the walk slower (PERF.md,
// section 6). So:
//   * no device load on the chain: a thread fetches its lane's bytes into register rings of
//     kWalkRing bytes two rings before the chain reaches them, and the first two rings' loads
//     are issued before the table is staged, so their latency hides behind the staging;
//   * (emit) three rings rotate through the roles walked, in flight and refilled, never copied:
//     a copy from ring to ring reads, and so waits for, the ring fetched ahead at the end of the
//     ring that fetched it. The sync pass keeps the two rings and the copy: over its 128-byte
//     window the rotation was slower at a few thousand lanes (though faster at a 65,536-lane
//     tile);
//   * (emit) no store on the chain either: a step stores the state it starts from with a
//     streaming store (st.global.cs) before its lookup; nothing waits for the store, and the
//     states are read by the next kernel, not by this one;
//   * a ring's steps have a compile-time count, so its unrolled steps are one basic block; only
//     the last, partial ring (K need not be a multiple of a ring) is guarded step by step;
//   * the table (S x 256 B, at most 64 KB) is staged with cp.async, every copy in flight at once;
//   * lanes per block: the fewest that still put one block on each SM (at most kWalkMaxLanes),
//     so a body of a few thousand lanes spreads over every SM and a 65,536-lane tile stages the
//     table once per 512 lanes, not once per 64. A block has at least kStageThreads threads
//     for the staging; the rest return after it.
constexpr int kWalkRing = 16;
constexpr int kWalkMaxLanes = 512;  // walking threads per block (3 rings of 16 in registers)
constexpr int kStageThreads = 256;  // threads per block at least, for staging a table

// One ring of a lane's emit walk, bytes [k0, k0 + R): first issue the loads of ring k0 + 2R
// into `ahead` (the ring walked last), then walk `ring`; each step stores the state it starts
// from, then advances. GUARD masks steps at or past k_len.
template <bool GUARD, int R = kWalkRing>
__device__ __forceinline__ void emit_ring(const uint8_t* tbl, int& state, const uint32_t (&ring)[R],
                                          uint32_t (&ahead)[R], const uint8_t* col,
                                          uint8_t* __restrict__ out, int k0, int k_len,
                                          int lanes) {
  load_ring(ahead, col, k0 + 2 * R, k_len, lanes);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!GUARD || k0 + r < k_len) {
      __stcs(out + (size_t)(k0 + r) * lanes, (uint8_t)state);
      state = tbl[state * 256 + ring[r]];
    }
  }
}

// EMIT: states is uint8[k_len, lanes]; otherwise it is not touched (the sync pass passes null).
template <bool EMIT>
__global__ void __launch_bounds__(kWalkMaxLanes)
    walk_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ next_state,
                int n_states, const int32_t* __restrict__ entries, uint8_t* __restrict__ states,
                int32_t* __restrict__ exits, int k_len, int lanes, int block_lanes) {
  extern __shared__ __align__(16) uint8_t tbl[];
  constexpr int R = kWalkRing;
  const int lane = blockIdx.x * block_lanes + threadIdx.x;
  const bool walks = (int)threadIdx.x < block_lanes && lane < lanes;
  const uint8_t* col = xs + lane;
  uint8_t* out = EMIT ? states + lane : nullptr;
  uint32_t ra[R], rb[R];  // the ring walked next and the one after it
  int state = 0;
  if (walks) {
    state = entries[lane];
    load_ring(ra, col, 0, k_len, lanes);
    load_ring(rb, col, R, k_len, lanes);
  }
  et::stage_table_async(tbl, next_state, n_states * 256);
  if (!walks) return;
  int k0 = 0;
  if constexpr (EMIT) {
    uint32_t rc[R];
    for (; k0 + 3 * R <= k_len; k0 += 3 * R) {
      emit_ring<false>(tbl, state, ra, rc, col, out, k0, k_len, lanes);
      emit_ring<false>(tbl, state, rb, ra, col, out, k0 + R, k_len, lanes);
      emit_ring<false>(tbl, state, rc, rb, col, out, k0 + 2 * R, k_len, lanes);
    }
    // the last (fewer than 3R) bytes: whole rings unguarded, then the partial one guarded
    // (each ring's code once: a tail with one more unrolled ring made the walk slower)
    if (k0 + R <= k_len) {
      emit_ring<false>(tbl, state, ra, rc, col, out, k0, k_len, lanes);
      k0 += R;
      if (k0 + R <= k_len) {
        emit_ring<false>(tbl, state, rb, ra, col, out, k0, k_len, lanes);
        if (k0 + R < k_len) emit_ring<true>(tbl, state, rc, rb, col, out, k0 + R, k_len, lanes);
      } else {
        emit_ring<true>(tbl, state, rb, ra, col, out, k0, k_len, lanes);
      }
    } else {
      emit_ring<true>(tbl, state, ra, rc, col, out, k0, k_len, lanes);
    }
  } else {
    for (; k0 + R <= k_len; k0 += R) {
      uint32_t ahead[R];
      load_ring(ahead, col, k0 + 2 * R, k_len, lanes);
#pragma unroll
      for (int r = 0; r < R; ++r) state = tbl[state * 256 + ra[r]];
#pragma unroll
      for (int r = 0; r < R; ++r) ra[r] = rb[r], rb[r] = ahead[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (k0 + r < k_len) state = tbl[state * 256 + ra[r]];
  }
  exits[lane] = state;
}

// ---- fused_pass: the one-pass decode sweep ----
//
// Replaces fused_pass_pallas8 (_fused_kernel). Each step of a lane reads one byte x, emits the
// byte's rows from the fused table and advances the state. What bounds it on this card is each
// lane's serial state chain, so the design takes every wait it can off that chain:
//   * no device load on the chain: a thread holds its lane's bytes in register rings (kRing) and
//     fetches each ring two rings before the chain reaches it, so the ~600-cycle load
//     latency is paid once per ring, not once per byte; at each step a warp's loads are still one
//     32-byte sector;
//   * one shared-memory load per byte on the chain: the next state is a function of (x, state)
//     alone, p > 0 ? tail_end[x][p] : merged[x][state] with p = pv[x][state] & 15, so each block
//     derives chain[x * s + state] from the staged fused table once, and a step is
//     state = chain[x * s + state]. The emitted rows (merged, pv, the tail count and slots) are
//     read off the chain: the loop is software-pipelined, so the chain walks one ring while the
//     rows of the ring before it are read and stored (st.global, which no shared-memory load
//     has to wait behind). The chain table comes from the fused table itself, so it is
//     bit-exact with the reference also after an invalid transition;
//   * shared memory: the fused table plus the chain table, at most 151,808 + 65,536 B
//     (s = 256, m = 8), staged with cp.async so all of a block's copies are in flight at once;
//   * blocks: the walking lanes of a block are sized from the lane count and the blocks that fit
//     an SM at this shared-memory size, so a small body spreads over every SM in one wave and a
//     65,536-lane tile stages the tables once per block, not once per 64 lanes. A block has at
//     least kStageThreads threads for the staging and the derivation; the rest return.
// Device-memory traffic per byte: 1 B read; 4 B written packed, 4(m + 1) B unpacked.
//
// PACKED (m <= 3): one word per byte, row0 << 8m | slot_j << 8(m-1-j), with row0 zeroed at
// lane-linear positions >= n_valid. Otherwise m + 1 rows per byte: row0, then the m slots.

// Bytes of its lane a thread holds per ring: 16 packed; 8 unpacked, whose wider rows need the
// registers (at 16 the unpacked kernel reaches 128 registers and runs slower).
template <bool PACKED>
constexpr int kRing = PACKED ? 16 : 8;
constexpr int kFusedMaxLanes = 512;  // walking threads per block

// Byte offset of the chain table in shared memory: after the fused table, 16-byte aligned.
__host__ __device__ inline int chain_offset(int cols) { return (256 * cols + 15) & ~15; }

// The rows of byte x read in state st, off the chain. The stores are global (st.global.cg), so
// the compiler may move the next steps' shared-memory loads above them. NT: the tail slots,
// exactly (unpacked) or at most (packed, n_tail of them).
template <bool PACKED, int NT>
__device__ __forceinline__ void fused_emit(const uint8_t* tbl, int x, int st,
                                           int32_t* __restrict__ out, int k, int lanes, int lane,
                                           int cols, int s, int off_tc, int m, int n_tail,
                                           long long real_bytes) {
  const uint8_t* row = tbl + x * cols;
  const int mg = row[st];
  const int pv = row[s + st];
  const int p = pv & 15;
  const uint8_t* tail = row + off_tc + p;  // tail count | 16 * invalid, then the slots by p
  const int tcv = tail[0];
  const bool inv = pv >= 16 || (p > 0 && tcv >= 16);
  int row0 = inv ? 16 : (p > 0) + (tcv & 15);
  // the tail slots: a loop of constant trip count, so the unrolled ring stays one basic block
  // the compiler can schedule across steps
  if (PACKED) {
    if (k >= real_bytes) row0 = 0;
    uint32_t word = ((uint32_t)row0 << (8 * m)) | ((uint32_t)mg << (8 * (m - 1)));
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < n_tail) word |= (uint32_t)tail[9 * (1 + j)] << (8 * (m - 2 - j));
    __stcg(out + (size_t)k * lanes + lane, (int32_t)word);
  } else {
    int32_t* o = out + (size_t)k * (m + 1) * lanes + lane;
    __stcg(o, row0);
    __stcg(o + lanes, mg);
#pragma unroll
    for (int j = 0; j < NT; ++j) __stcg(o + (size_t)(2 + j) * lanes, (int32_t)tail[9 * (1 + j)]);
  }
}

// One ring of steps, software-pipelined: the chain walks ring k0 + R (bytes xb) while the rows
// of ring k0 (bytes xa, pre-transition states st) are emitted. nst gets ring k0 + R's
// pre-transition states. GUARD masks steps at or past k_len.
template <bool PACKED, int NT, bool GUARD, int R = kRing<PACKED>>
__device__ __forceinline__ void fused_ring(const uint8_t* tbl, const uint8_t* chain,
                                           const uint32_t (&xa)[R], const uint32_t (&xb)[R],
                                           const int (&st)[R], int (&nst)[R], int& state, int k0,
                                           int k_len,
                                           int32_t* __restrict__ out, int lanes, int lane,
                                           int cols, int s, int off_tc, int m, int n_tail,
                                           long long real_bytes) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    nst[r] = state;
    if (!GUARD || k0 + R + r < k_len) state = chain[xb[r] * s + state];
    if (!GUARD || k0 + r < k_len)
      fused_emit<PACKED, NT>(tbl, xa[r], st[r], out, k0 + r, lanes, lane, cols, s, off_tc, m,
                             n_tail, real_bytes);
  }
}

// PACKED: m <= 3, NT = 2 (n_tail of them used); unpacked: NT = n_tail = min(mt, m - 1).
template <bool PACKED, int NT>
__global__ void __launch_bounds__(kFusedMaxLanes)
    fused_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ fused, int cols,
                 const int32_t* __restrict__ entries, int32_t* __restrict__ out,
                 int32_t* __restrict__ exits, int k_len, int lanes, int m, int mt, int s,
                 long long n_valid, int block_lanes) {
  extern __shared__ __align__(16) uint8_t tbl[];
  uint8_t* chain = tbl + chain_offset(cols);
  et::stage_table_async(tbl, fused, 256 * cols);

  const int off_tc = 2 * s;                  // tail count + 16 * invalid, by p
  const int off_end = 2 * s + 9 * (1 + mt);  // tail end state, by p
  // chain[x * s + st]; s is a multiple of 8, so the 4 entries a thread derives share x. The
  // float quotient is exact here: (i + 0.5) / s is at least 0.5 / s from an integer.
  const float inv_s = 1.0f / s;
  for (int i = 4 * threadIdx.x; i < 256 * s; i += 4 * blockDim.x) {
    const int x = __float2int_rz((i + 0.5f) * inv_s);
    const int st = i - x * s;
    const uint8_t* row = tbl + x * cols;
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = row[s + st + q] & 15;
      word |= (uint32_t)row[p > 0 ? off_end + p : st + q] << (8 * q);
    }
    *reinterpret_cast<uint32_t*>(chain + i) = word;
  }
  __syncthreads();

  const int lane = blockIdx.x * block_lanes + threadIdx.x;
  if ((int)threadIdx.x >= block_lanes || lane >= lanes) return;
  const int n_tail = min(mt, m - 1);  // tail symbol slots emitted after the first
  const long long real_bytes = n_valid - (long long)lane * k_len;
  const uint8_t* col = xs + lane;
  int state = entries[lane];
  // xa: the bytes of the ring being emitted; xb: of the ring being walked; ahead: in flight
  constexpr int R = kRing<PACKED>;
  uint32_t xa[R], xb[R], ahead[R];
  int st[R], nst[R];
  load_ring(xa, col, 0, k_len, lanes);
  load_ring(xb, col, R, k_len, lanes);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st[r] = state;
    if (r < k_len) state = chain[xa[r] * s + state];
  }
  int k0 = 0;
  for (; k0 + 2 * R <= k_len; k0 += R) {
    load_ring(ahead, col, k0 + 2 * R, k_len, lanes);
    fused_ring<PACKED, NT, false>(tbl, chain, xa, xb, st, nst, state, k0, k_len, out, lanes,
                                  lane, cols, s, off_tc, m, n_tail, real_bytes);
#pragma unroll
    for (int r = 0; r < R; ++r) xa[r] = xb[r], xb[r] = ahead[r], st[r] = nst[r];
  }
  for (; k0 < k_len; k0 += R) {
    load_ring(ahead, col, k0 + 2 * R, k_len, lanes);
    fused_ring<PACKED, NT, true>(tbl, chain, xa, xb, st, nst, state, k0, k_len, out, lanes,
                                 lane, cols, s, off_tc, m, n_tail, real_bytes);
#pragma unroll
    for (int r = 0; r < R; ++r) xa[r] = xb[r], xb[r] = ahead[r], st[r] = nst[r];
  }
  exits[lane] = state;
}

template <bool EMIT>
int launch_walk(const void* xs, const void* next_state, int n_states, const void* entries,
                void* states, void* exits, int k_len, int lanes, void* stream) {
  const int smem = n_states * 256;
  cudaError_t err =
      cudaFuncSetAttribute(walk_kernel<EMIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if ((err = et::sm_count(&sms)) != cudaSuccess) return (int)err;
  // the fewest walking lanes per block (a multiple of a warp) that put one block on each SM
  const int block_lanes = std::min(
      kWalkMaxLanes, std::max(32, (et::blocks_for(lanes, std::max(sms, 1)) + 31) / 32 * 32));
  const int threads = std::max(block_lanes, kStageThreads);
  walk_kernel<EMIT><<<et::blocks_for(lanes, block_lanes), threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)xs, (const uint8_t*)next_state, n_states, (const int32_t*)entries,
      (uint8_t*)states, (int32_t*)exits, k_len, lanes, block_lanes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* et_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int et_sync_pass(const void* xs, const void* next_state, int n_states, const void* entries,
                 void* exits, int w, int lanes, void* stream) {
  return launch_walk<false>(xs, next_state, n_states, entries, nullptr, exits, w, lanes, stream);
}

int et_emit_pass(const void* xs, const void* next_state, int n_states, const void* entries,
                 void* states, void* exits, int k_len, int lanes, void* stream) {
  return launch_walk<true>(xs, next_state, n_states, entries, states, exits, k_len, lanes,
                           stream);
}

int et_fused_pass(const void* xs, const void* fused, int cols, const void* entries, void* out,
                  void* exits, int k_len, int lanes, int m, int mt, int s, long long n_valid,
                  int packed, void* stream) {
  const int smem = chain_offset(cols) + 256 * s;
  using Kernel = void (*)(const uint8_t*, const uint8_t*, int, const int32_t*, int32_t*, int32_t*,
                          int, int, int, int, int, long long, int);
  static const Kernel unpacked[] = {fused_kernel<false, 0>, fused_kernel<false, 1>,
                                    fused_kernel<false, 2>, fused_kernel<false, 3>,
                                    fused_kernel<false, 4>, fused_kernel<false, 5>,
                                    fused_kernel<false, 6>, fused_kernel<false, 7>};
  const int n_tail = std::min(mt, m - 1);
  if (n_tail < 0 || n_tail > 7 || (packed && n_tail > 2)) return (int)cudaErrorInvalidValue;
  const Kernel kernel = packed ? fused_kernel<true, 2> : unpacked[n_tail];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = et::sm_count(&sms)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kStageThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // the fewest walking lanes per block (a multiple of a warp) that still fit every lane in one
  // wave of the blocks the SMs hold at this shared-memory size
  const int slots = sms * std::max(per_sm, 1);
  const int block_lanes = std::min(
      kFusedMaxLanes, std::max(32, (et::blocks_for(lanes, slots) + 31) / 32 * 32));
  const int threads = std::max(block_lanes, kStageThreads);
  kernel<<<et::blocks_for(lanes, block_lanes), threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)xs, (const uint8_t*)fused, cols, (const int32_t*)entries, (int32_t*)out,
      (int32_t*)exits, k_len, lanes, m, mt, s, n_valid, block_lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
