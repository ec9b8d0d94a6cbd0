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
// states are inputs (the emit pass wrote them), so every byte is independent and reads its few
// table entries with plain loads. There is no serial chain.
//
// What bounds them on the card: device-memory traffic, 2 B read and (m + 1) rows written per
// body byte (uint8 rows from the split kernel, int32 from the full-table one), plus the table
// reads; and the store instructions that write the rows.
//
// The split table (256 x (2S + 9(mt + 1)) B, 71-146 KB) fits a block's shared memory.
// expand_split_kernel's design:
//   * the rows are uint8, 2 B read + (m + 1) B written per body byte (the int32 rows wrote
//     4(m + 1) B and the caller cast the slots to uint8 in a second pass);
//   * each thread expands a group of 8 adjacent lanes of a row and writes each output row's 8
//     bytes with one streaming 8-byte store (st.global.cs.v2): a warp's store is 256 adjacent
//     bytes. With one byte per thread, a warp's store wrote one 32-byte sector, and those
//     stores, not the loads or the table lookups, set the kernel's time (PERF.md, section 6). The
//     output rows have a pitch of the lanes rounded up to 8, so every store is aligned
//     whatever the lane count; the caller gets the [K, m + 1, lanes] view;
//   * the work is (row, span of 256 lanes) units, row-major; each warp takes one contiguous,
//     equal share of them, so no thread divides per byte and every warp has the same work;
//     two groups take turns, so the next span's loads are in flight while a span's rows are
//     made (the first before the table is staged);
//   * blocks of kSplitThreads, as many on each SM as its shared memory and registers hold (one
//     at the 146 KB table); a block stages the table with cp.async once and then serves all of
//     its warps' spans (1,024-thread blocks were no faster at 5.2 MB text and slower on the
//     run-heavy body);
//   * the tail slots are a loop of compile-time count (one instantiation per tail count), so a
//     group's unrolled lanes are one basic block.
//
// The full table (256 x (m + 1)S B, 128 KB at S = 128, m = 3 but 576 KB at S = 256, m = 8) can
// exceed a block's 227 KB, so expand_kernel reads it from device memory through the read-only
// path (__ldg); it stays resident in the 50 MB L2. One thread owns one (k, lane) byte, so a
// warp's loads are one 32-byte sector and each of its int32 row stores one 128-byte line.
//
// Table layouts are those of entreepy_tpu/format/fsm8.py, as uint8, indexed by S = fsm.width:
//   split[256, 2S + 9(mt + 1)]  (split_expand_tensors): cols 0:S first symbol by state,
//       S:2S p | 16 * invalid_first by state, then 9-wide blocks by p: tail count | 16 * invalid,
//       tail slot j
//   full[256, (m + 1)S]         (expand_tensors): block j by state; block 0 = count | 16 * invalid

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kExpandThreads = 256;  // expand_kernel
constexpr int kNP = 9;  // first-code end positions: 1..8 plus 0 = "no code completed"
constexpr int kSplitThreads = 512;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kGroup = 8;  // adjacent lanes a thread expands: one 8-byte store per output row

// A thread's group at span (k, sp): lanes [8g, 8g + 8) of row k, g = 32 sp + (thread & 31), so
// a warp's span is 256 adjacent lanes. live: the span is in the warp's share and g in the row.
struct Group {
  uint32_t x[kGroup], st[kGroup];  // bytes and pre-transition states (0 past the last lane)
  int k, g;
  bool live;
};

// Issues the loads of a group's bytes and states, without awaiting them.
__device__ __forceinline__ void load_group(Group& gr, const uint8_t* __restrict__ xs,
                                           const uint8_t* __restrict__ states, bool in_share,
                                           int k, int sp, int groups, int lanes) {
  gr.k = k;
  gr.g = (sp << 5) | (threadIdx.x & 31);
  gr.live = in_share && gr.g < groups;
  const int lane0 = gr.g * kGroup;
  const size_t at = (size_t)k * lanes + lane0;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const bool load = gr.live && lane0 + i < lanes;
    gr.x[i] = load ? xs[at + i] : 0;
    gr.st[i] = load ? states[at + i] : 0;
  }
}

// A group's rows: each byte's split-table lookups, its m + 1 row bytes gathered into one
// 8-byte word per row, then one streaming store per row. NT: the tail symbol slots after the
// first, min(mt, m - 1); rows 0 .. NT + 1 are written.
template <int NT>
__device__ __forceinline__ void expand_group(const uint8_t* tbl, const Group& gr, int cols, int s,
                                             int m, int pitch, uint8_t* __restrict__ out) {
  if (!gr.live) return;
  const int off_tc = 2 * s;  // tail count | 16 * invalid, by p
  uint32_t lo[NT + 2] = {}, hi[NT + 2] = {};
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const uint8_t* row = tbl + gr.x[i] * cols;
    const uint32_t fs = row[gr.st[i]];
    const uint32_t pv = row[s + gr.st[i]];
    const uint32_t p = pv & 15;
    const uint8_t* tail = row + off_tc + p;  // tail count | 16 * invalid, then the slots by p
    const uint32_t tc = tail[0];
    // pallas_fsm8.py's split combine verbatim: either flag marks the byte invalid
    const bool inv = pv >= 16 || tc >= 16;
    uint32_t v[NT + 2];  // the byte's row values
    v[0] = inv ? 16 : (p > 0) + (tc & 15);
    v[1] = fs;
#pragma unroll
    for (int j = 0; j < NT; ++j) v[2 + j] = tail[kNP * (1 + j)];
    const int sh = 8 * (i & 3);
#pragma unroll
    for (int j = 0; j < NT + 2; ++j) {
      if (i < 4)
        lo[j] |= v[j] << sh;
      else
        hi[j] |= v[j] << sh;
    }
  }
  uint8_t* o = out + (size_t)gr.k * (m + 1) * pitch + gr.g * kGroup;
#pragma unroll
  for (int j = 0; j < NT + 2; ++j)
    __stcs(reinterpret_cast<uint2*>(o + (size_t)j * pitch), make_uint2(lo[j], hi[j]));
}

// out: rows of pitch bytes (lanes rounded up to kGroup), so every 8-byte store is aligned.
template <int NT>
__global__ void __launch_bounds__(kSplitThreads, 1)
    expand_split_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ states,
                        const uint8_t* __restrict__ t_split, int cols, int s, int m,
                        uint8_t* __restrict__ out, int k_len, int lanes, int pitch) {
  extern __shared__ __align__(16) uint8_t tbl[];
  // this warp's share [f, f_end) of the spans f = k * spans + sp
  const int groups = pitch / kGroup, spans = (groups + 31) >> 5;
  const long long warps = (long long)gridDim.x * kSplitWarps;
  const long long w = (long long)blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  const long long n_spans = (long long)spans * k_len;
  long long f = n_spans * w / warps;
  const long long f_end = n_spans * (w + 1) / warps;
  int k = (int)(f / spans), sp = (int)(f - (long long)k * spans);

  // two groups take turns: the next span's loads are in flight while this one's rows are made
  Group a, b;
  load_group(a, xs, states, f < f_end, k, sp, groups, lanes);
  et::stage_table_async(tbl, t_split, 256 * cols);
  while (f < f_end) {
    if (++sp == spans) sp = 0, ++k;
    load_group(b, xs, states, ++f < f_end, k, sp, groups, lanes);
    expand_group<NT>(tbl, a, cols, s, m, pitch, out);
    if (f >= f_end) break;
    if (++sp == spans) sp = 0, ++k;
    load_group(a, xs, states, ++f < f_end, k, sp, groups, lanes);
    expand_group<NT>(tbl, b, cols, s, m, pitch, out);
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
                         int s, int m, int mt, void* out, int k_len, int lanes, int pitch,
                         void* stream) {
  using Kernel = void (*)(const uint8_t*, const uint8_t*, const uint8_t*, int, int, int, uint8_t*,
                          int, int, int);
  static const Kernel kernels[] = {expand_split_kernel<0>, expand_split_kernel<1>,
                                   expand_split_kernel<2>, expand_split_kernel<3>,
                                   expand_split_kernel<4>, expand_split_kernel<5>,
                                   expand_split_kernel<6>, expand_split_kernel<7>};
  const int n_tail = std::min(mt, m - 1);
  if (n_tail < 0 || n_tail > 7 || pitch % kGroup || pitch < lanes)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernels[n_tail];
  const int smem = 256 * cols;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = et::sm_count(&sms)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSplitThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // the blocks the SMs hold, but no more than give each warp a span
  const long long spans = (long long)(pitch / kGroup + 31) / 32 * k_len;
  const int blocks = (int)std::min<long long>((long long)sms * std::max(per_sm, 1),
                                              et::blocks_for(spans, kSplitWarps));
  kernel<<<blocks, kSplitThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)xs, (const uint8_t*)states, (const uint8_t*)t_split, cols, s, m,
      (uint8_t*)out, k_len, lanes, pitch);
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
