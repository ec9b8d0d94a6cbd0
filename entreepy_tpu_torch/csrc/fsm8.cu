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
// byte k's state is known, and each byte costs a short chain of dependent shared-memory loads
// (sync: 1; fused: merged/p -> tail count -> tail end). A pass therefore takes about
// K x (chain latency) once every lane has a thread; device-memory traffic is small (1 B read
// per body byte; emit: 1 B written; fused: 4 B written packed, 4(m+1) B unpacked). The design:
//   * stages the whole table in shared memory once per block (fused: 256 x (2s + 9(mt+2)) B,
//     58 KB for the text corpus, at most 148 KB; sync/emit: S x 256 B, at most 64 KB), raising the
//     block's dynamic shared-memory cap above 48 KB where needed;
//   * reads bytes from the [K, lanes] layout, so a warp's loads at step k are one 32-byte
//     sector and its stores one 128-byte line;
//   * keeps blocks at 64 threads so a body's lanes spread over as many SMs as possible.
//
// Table layouts are those of entreepy_tpu/format/fsm8.py, as uint8:
//   next_state[S, 256]                       (ByteFsm.next_state)
//   fused[256, C], C = 2s + 9(mt + 2)        (fused_decode_tensors, one row per byte)
// The running state is always a trie node < s: every table entry that feeds it is one.

#include "common.cuh"

namespace {

__global__ void sync_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ next_state,
                            int n_states, const int32_t* __restrict__ entries,
                            int32_t* __restrict__ exits, int w, int lanes) {
  extern __shared__ __align__(16) uint8_t tbl[];
  et::stage_table(tbl, next_state, n_states * 256);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int state = entries[lane];
  for (int k = 0; k < w; ++k) state = tbl[state * 256 + xs[(size_t)k * lanes + lane]];
  exits[lane] = state;
}

// The sync walk over all K bytes, storing each byte's state BEFORE its transition. The TPU
// kernel packed four states per int32 word (its store economics); here states is uint8[K, lanes]
// and a warp's stores at step k are 32 adjacent bytes.
__global__ void emit_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ next_state,
                            int n_states, const int32_t* __restrict__ entries,
                            uint8_t* __restrict__ states, int32_t* __restrict__ exits, int k_len,
                            int lanes) {
  extern __shared__ __align__(16) uint8_t tbl[];
  et::stage_table(tbl, next_state, n_states * 256);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int state = entries[lane];
  for (int k = 0; k < k_len; ++k) {
    const size_t o = (size_t)k * lanes + lane;
    states[o] = (uint8_t)state;
    state = tbl[state * 256 + xs[o]];
  }
  exits[lane] = state;
}

// PACKED (m <= 3): one word per byte, row0 << 8m | slot_j << 8(m-1-j), with row0 zeroed at
// lane-linear positions >= n_valid. Otherwise m + 1 rows per byte: row0, then the m slots.
template <bool PACKED>
__global__ void fused_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ fused,
                             int cols, const int32_t* __restrict__ entries,
                             int32_t* __restrict__ out, int32_t* __restrict__ exits, int k_len,
                             int lanes, int m, int mt, int s, long long n_valid) {
  extern __shared__ __align__(16) uint8_t tbl[];
  et::stage_table(tbl, fused, 256 * cols);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;

  const int off_tc = 2 * s;                  // tail count + 16 * invalid, by p
  const int off_end = 2 * s + 9 * (1 + mt);  // tail end state, by p
  const int n_tail = min(mt, m - 1);         // tail symbol slots emitted after the first
  const long long real_bytes = n_valid - (long long)lane * k_len;
  int state = entries[lane];
  for (int k = 0; k < k_len; ++k) {
    const uint8_t* row = tbl + xs[(size_t)k * lanes + lane] * cols;
    const int mg = row[state];
    const int pv = row[s + state];
    const int p = pv & 15;
    const int tcv = row[off_tc + p];
    const bool inv = pv >= 16 || (p > 0 && tcv >= 16);
    int row0 = inv ? 16 : (p > 0) + (tcv & 15);
    if (PACKED) {
      if (k >= real_bytes) row0 = 0;
      uint32_t word = ((uint32_t)row0 << (8 * m)) | ((uint32_t)mg << (8 * (m - 1)));
      for (int j = 0; j < n_tail; ++j)
        word |= (uint32_t)row[off_tc + 9 * (1 + j) + p] << (8 * (m - 2 - j));
      out[(size_t)k * lanes + lane] = (int32_t)word;
    } else {
      int32_t* o = out + (size_t)k * (m + 1) * lanes + lane;
      o[0] = row0;
      o[lanes] = mg;
      for (int j = 0; j < n_tail; ++j) o[(size_t)(2 + j) * lanes] = row[off_tc + 9 * (1 + j) + p];
    }
    state = p > 0 ? row[off_end + p] : mg;
  }
  exits[lane] = state;
}

}  // namespace

extern "C" {

const char* et_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int et_sync_pass(const void* xs, const void* next_state, int n_states, const void* entries,
                 void* exits, int w, int lanes, void* stream) {
  const int smem = n_states * 256;
  cudaError_t err =
      cudaFuncSetAttribute(sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sync_kernel<<<et::blocks_for(lanes, et::kLaneThreads), et::kLaneThreads, smem,
                (cudaStream_t)stream>>>(
      (const uint8_t*)xs, (const uint8_t*)next_state, n_states, (const int32_t*)entries,
      (int32_t*)exits, w, lanes);
  return (int)cudaGetLastError();
}

int et_emit_pass(const void* xs, const void* next_state, int n_states, const void* entries,
                 void* states, void* exits, int k_len, int lanes, void* stream) {
  const int smem = n_states * 256;
  cudaError_t err =
      cudaFuncSetAttribute(emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  emit_kernel<<<et::blocks_for(lanes, et::kLaneThreads), et::kLaneThreads, smem,
                (cudaStream_t)stream>>>(
      (const uint8_t*)xs, (const uint8_t*)next_state, n_states, (const int32_t*)entries,
      (uint8_t*)states, (int32_t*)exits, k_len, lanes);
  return (int)cudaGetLastError();
}

int et_fused_pass(const void* xs, const void* fused, int cols, const void* entries, void* out,
                  void* exits, int k_len, int lanes, int m, int mt, int s, long long n_valid,
                  int packed, void* stream) {
  const int smem = 256 * cols;
  const int blocks = et::blocks_for(lanes, et::kLaneThreads);
  cudaError_t err;
  if (packed) {
    err = cudaFuncSetAttribute(fused_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    fused_kernel<true><<<blocks, et::kLaneThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)xs, (const uint8_t*)fused, cols, (const int32_t*)entries, (int32_t*)out,
        (int32_t*)exits, k_len, lanes, m, mt, s, n_valid);
  } else {
    err = cudaFuncSetAttribute(fused_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    fused_kernel<false><<<blocks, et::kLaneThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)xs, (const uint8_t*)fused, cols, (const int32_t*)entries, (int32_t*)out,
        (int32_t*)exits, k_len, lanes, m, mt, s, n_valid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
