// Symbol expansion kernels of the two-pass decode, for Hopper (sm_90a).
//
// Replace the TPU kernels of entreepy_tpu/ops/pallas_fsm8.py:
//   et_expand_split_pass <- expand_pass_split_pallas8 (_expand_split_kernel): split table
//   et_expand_pass       <- expand_pass_pallas8       (_expand_kernel):       full table
//
// Both turn each (byte, pre-transition state) of a [K, lanes] grid into the byte's m + 1 rows of
// out[K, m + 1, lanes]: row 0 = symbol count | 16 * invalid, rows 1..m = the symbol slots (dead
// slots hold table values, as on the TPU). On the TPU each byte was a one-hot MXU contraction
// against the whole table plus masked reductions, because the TPU serializes gathers. Here the
// states are inputs (the emit pass wrote them), so every byte is independent: one thread owns
// one (k, lane) byte and reads its few table entries with plain loads. There is no serial chain.
//
// What bounds them on the card: device-memory traffic, 2 B read and 4(m + 1) B written per body
// byte, plus the table reads. Threads are numbered lane-fastest, so a warp's byte and state loads
// are one 32-byte sector each and each of its m + 1 row stores is one 128-byte line. The tables:
//   * split (256 x (2S + 9(mt + 1)) B, 71-146 KB) fits a block's shared memory. It is staged
//     once per block of a grid-stride grid sized to fill every SM once, not once per few hundred
//     bytes as a grid over the whole body would stage it;
//   * full (256 x (m + 1)S B, 128 KB at S = 128, m = 3 but 576 KB at S = 256, m = 8) can exceed a
//     block's 227 KB, so it is read from device memory through the read-only path (__ldg). It
//     stays resident in the 50 MB L2.
//
// Table layouts are those of entreepy_tpu/format/fsm8.py, as uint8, indexed by S = fsm.width:
//   split[256, 2S + 9(mt + 1)]  (split_expand_tensors): cols 0:S first symbol by state,
//       S:2S p | 16 * invalid_first by state, then 9-wide blocks by p: tail count | 16 * invalid,
//       tail slot j
//   full[256, (m + 1)S]         (expand_tensors): block j by state; block 0 = count | 16 * invalid

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kExpandThreads = 256;
constexpr int kNP = 9;  // first-code end positions: 1..8 plus 0 = "no code completed"

__global__ void expand_split_kernel(const uint8_t* __restrict__ xs,
                                    const uint8_t* __restrict__ states,
                                    const uint8_t* __restrict__ t_split, int cols, int s, int m,
                                    int mt, int32_t* __restrict__ out, long long n, int lanes) {
  extern __shared__ __align__(16) uint8_t tbl[];
  et::stage_table(tbl, t_split, 256 * cols);
  const int off_tc = 2 * s;           // tail count | 16 * invalid, by p
  const int n_tail = min(mt, m - 1);  // tail symbol slots after the first
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long k = i / lanes;
    const int lane = (int)(i - k * lanes);
    const uint8_t* row = tbl + xs[i] * cols;
    const int st = states[i];
    const int fs = row[st];
    const int pv = row[s + st];
    const int p = pv & 15;
    const int tc = row[off_tc + p];
    // pallas_fsm8.py's split combine verbatim: either flag marks the byte invalid
    const bool inv = pv >= 16 || tc >= 16;
    int32_t* o = out + (size_t)k * (m + 1) * lanes + lane;
    o[0] = inv ? 16 : (p > 0) + (tc & 15);
    o[lanes] = fs;
    for (int j = 0; j < n_tail; ++j) o[(size_t)(2 + j) * lanes] = row[off_tc + kNP * (1 + j) + p];
  }
}

__global__ void expand_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ states,
                              const uint8_t* __restrict__ t_exp, int s, int m,
                              int32_t* __restrict__ out, long long n, int lanes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long k = i / lanes;
  const int lane = (int)(i - k * lanes);
  const uint8_t* src = t_exp + (size_t)xs[i] * (m + 1) * s + states[i];
  int32_t* o = out + (size_t)k * (m + 1) * lanes + lane;
  for (int j = 0; j <= m; ++j) o[(size_t)j * lanes] = __ldg(src + (size_t)j * s);
}

}  // namespace

extern "C" {

int et_expand_split_pass(const void* xs, const void* states, const void* t_split, int cols,
                         int s, int m, int mt, void* out, int k_len, int lanes, void* stream) {
  const int smem = 256 * cols;
  cudaError_t err = cudaFuncSetAttribute(expand_split_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_split_kernel,
                                                      kExpandThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)k_len * lanes;
  const int blocks = std::min(et::blocks_for(n, kExpandThreads), sms * std::max(per_sm, 1));
  expand_split_kernel<<<blocks, kExpandThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)xs, (const uint8_t*)states, (const uint8_t*)t_split, cols, s, m, mt,
      (int32_t*)out, n, lanes);
  return (int)cudaGetLastError();
}

int et_expand_pass(const void* xs, const void* states, const void* t_exp, int s, int m, void* out,
                   int k_len, int lanes, void* stream) {
  const long long n = (long long)k_len * lanes;
  expand_kernel<<<et::blocks_for(n, kExpandThreads), kExpandThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)xs, (const uint8_t*)states, (const uint8_t*)t_exp, s, m, (int32_t*)out, n,
      lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
