// Symbol expansion kernels of the two-pass decode, for Hopper (sm_90a).
//
// Replace the TPU kernels of entreepy_tpu/ops/pallas_fsm8.py:
//   et_expand_split_pass <- expand_pass_split_pallas8 (_expand_split_kernel): split table
//   et_expand_pass       <- expand_pass_pallas8       (_expand_kernel):       full table
//
// Both turn each (byte, pre-transition state) of a [K, lanes] grid into the byte's m + 1 uint8
// rows of out[K, m + 1, lanes]: row 0 = symbol count | 16 * invalid, rows 1..m = the symbol slots
// (dead slots hold table values, as on the TPU). On the TPU each byte was a one-hot MXU
// contraction against the whole table plus masked reductions, because the TPU serializes
// gathers. Here the states are inputs (the emit pass wrote them), so every byte is independent
// and reads its table entries with plain loads. There is no serial chain.
//
// What bounds them on the card: device-memory traffic, 2 B read and m + 1 B written per body
// byte, plus the table reads; and the instructions that store the rows and look the table up.
//
// What the two share (for_each_span, load_group, store_rows):
//   * each thread expands a group of 8 adjacent lanes of a row and writes each output row's 8
//     bytes with one streaming 8-byte store (st.global.cs.v2): a warp's store is 256 adjacent
//     bytes. With one byte per thread, a warp's store wrote one 32-byte sector, and those
//     stores, not the loads or the table lookups, set the split kernel's time (PERF.md,
//     section 6). The output rows have a pitch of the lanes rounded up to 8, so every store is
//     aligned whatever the lane count; the caller gets the [K, m + 1, lanes] view;
//   * the work is (row, span of 256 lanes) units, row-major; each warp takes one contiguous,
//     equal share of them, so no thread divides per byte and every warp has the same work;
//     two groups take turns, so the next span's loads are in flight while a span's rows are
//     made (the first before the table is staged);
//   * blocks of kSpanThreads, as many on each SM as its shared memory and registers hold
//     (1,024-thread blocks were no faster for the split kernel at 5.2 MB text and slower on
//     the run-heavy body);
//   * the rows are unrolled to a compile-time count (one instantiation per count), so a
//     group's unrolled lanes are one basic block.
//
// expand_split_kernel: the split table (256 x (2S + 9(mt + 1)) B, 71-146 KB) fits a block's
// shared memory; a block stages it with cp.async once and then serves all of its warps' spans.
// A byte takes three dependent lookups (first symbol, then its end position p, then the tail
// by p).
//
// expand_kernel: the full table holds a byte's m + 1 values S apart, so a lookup per row would
// cost a warp up to 32 sectors per row. The kernel reads a private layout of it instead,
// [256][S][P] with P = m + 1 rounded up to 4, 8 or 16 (cuda_fsm8.expand_vector_table): a
// byte's values are one aligned 4-, 8- or 16-byte load, and a 4 x 4 byte transpose (prmt)
// turns 4 lanes' entries into 4 rows' words. That layout is 128 KB at S = 128, m <= 3, which a
// block stages in shared memory with cp.async; at S = 256 or m > 3 it is 256 KB to 1 MB, more
// than a block's 227 KB, so the kernel reads it through the read-only path (ld.global.nc),
// where it stays resident in the 50 MB L2. Which path a table takes follows from its size and
// the device's limit, before the launch.
//
// Table layouts are those of entreepy_tpu/format/fsm8.py, as uint8, indexed by S = fsm.width:
//   split[256, 2S + 9(mt + 1)]  (split_expand_tensors): cols 0:S first symbol by state,
//       S:2S p | 16 * invalid_first by state, then 9-wide blocks by p: tail count | 16 * invalid,
//       tail slot j
//   full[256, (m + 1)S]         (expand_tensors): block j by state; block 0 = count | 16 * invalid
//   vector[256][S][P]           (the full table relaid): entry (x, st) = its m + 1 values, then
//       P - m - 1 pad bytes that no row takes

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kNP = 9;  // first-code end positions: 1..8 plus 0 = "no code completed"
constexpr int kSpanThreads = 512;
constexpr int kSpanWarps = kSpanThreads / 32;
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

// Runs this warp's share [f, f_end) of the spans f = k * spans + sp of a [k_len, pitch] grid:
// stage() once, after the first group's loads are issued, then expand(group) per span.
template <class Stage, class Expand>
__device__ __forceinline__ void for_each_span(const uint8_t* __restrict__ xs,
                                              const uint8_t* __restrict__ states, int k_len,
                                              int lanes, int pitch, Stage stage, Expand expand) {
  const int groups = pitch / kGroup, spans = (groups + 31) >> 5;
  const long long warps = (long long)gridDim.x * kSpanWarps;
  const long long w = (long long)blockIdx.x * kSpanWarps + (threadIdx.x >> 5);
  const long long n_spans = (long long)spans * k_len;
  long long f = n_spans * w / warps;
  const long long f_end = n_spans * (w + 1) / warps;
  int k = (int)(f / spans), sp = (int)(f - (long long)k * spans);

  // two groups take turns: the next span's loads are in flight while this one's rows are made
  Group a, b;
  load_group(a, xs, states, f < f_end, k, sp, groups, lanes);
  stage();
  while (f < f_end) {
    if (++sp == spans) sp = 0, ++k;
    load_group(b, xs, states, ++f < f_end, k, sp, groups, lanes);
    expand(a);
    if (f >= f_end) break;
    if (++sp == spans) sp = 0, ++k;
    load_group(a, xs, states, ++f < f_end, k, sp, groups, lanes);
    expand(b);
  }
}

// Stores a group's rows 0 .. R - 1 of out[k][rows][pitch], one streaming 8-byte store each:
// lo[j] holds lanes 0-3 of row j, hi[j] lanes 4-7, lane i in byte i & 3.
template <int R>
__device__ __forceinline__ void store_rows(const uint32_t* lo, const uint32_t* hi,
                                           const Group& gr, int rows, int pitch,
                                           uint8_t* __restrict__ out) {
  uint8_t* o = out + (size_t)gr.k * rows * pitch + gr.g * kGroup;
#pragma unroll
  for (int j = 0; j < R; ++j)
    __stcs(reinterpret_cast<uint2*>(o + (size_t)j * pitch), make_uint2(lo[j], hi[j]));
}

// A group's rows: each byte's split-table lookups, its m + 1 row bytes gathered into one
// 8-byte word per row, then one streaming store per row. NT: the tail symbol slots after the
// first, min(mt, m - 1); rows 0 .. NT + 1 are written.
template <int NT>
__device__ __forceinline__ void expand_split_group(const uint8_t* tbl, const Group& gr, int cols,
                                                   int s, int m, int pitch,
                                                   uint8_t* __restrict__ out) {
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
  store_rows<NT + 2>(lo, hi, gr, m + 1, pitch, out);
}

// out: rows of pitch bytes (lanes rounded up to kGroup), so every 8-byte store is aligned.
template <int NT>
__global__ void __launch_bounds__(kSpanThreads, 1)
    expand_split_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ states,
                        const uint8_t* __restrict__ t_split, int cols, int s, int m,
                        uint8_t* __restrict__ out, int k_len, int lanes, int pitch) {
  extern __shared__ __align__(16) uint8_t tbl[];
  for_each_span(
      xs, states, k_len, lanes, pitch, [&] { et::stage_table_async(tbl, t_split, 256 * cols); },
      [&](const Group& gr) { expand_split_group<NT>(tbl, gr, cols, s, m, pitch, out); });
}

// 4 x 4 byte transpose: r[j] = byte j of a, b, c and d, in bytes 0-3 (two rounds of prmt).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t* r) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
  r[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  r[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  r[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  r[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// Entry at byte offset `at` of a vector table as P / 4 words, value j in byte j & 3 of word
// j / 4: one load, from shared memory when STAGED, else through the read-only path.
template <int P, bool STAGED>
__device__ __forceinline__ void load_entry(const uint8_t* tbl, uint32_t at, uint32_t* v) {
  const uint8_t* e = tbl + at;
  if constexpr (P == 4) {
    v[0] = STAGED ? *reinterpret_cast<const uint32_t*>(e)
                  : __ldg(reinterpret_cast<const unsigned int*>(e));
  } else if constexpr (P == 8) {
    const uint2 w = STAGED ? *reinterpret_cast<const uint2*>(e)
                           : __ldg(reinterpret_cast<const uint2*>(e));
    v[0] = w.x, v[1] = w.y;
  } else {
    const uint4 w = STAGED ? *reinterpret_cast<const uint4*>(e)
                           : __ldg(reinterpret_cast<const uint4*>(e));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  }
}

// A group's M1 = m + 1 rows through the vector table: one entry load per byte, then per word
// of the entries two 4 x 4 transposes (lanes 0-3 and 4-7) give four rows' lo and hi words.
template <int M1, int P, bool STAGED>
__device__ __forceinline__ void expand_full_group(const uint8_t* tbl, const Group& gr, int s,
                                                  int pitch, uint8_t* __restrict__ out) {
  if (!gr.live) return;
  constexpr int C = P / 4;  // words per entry
  uint32_t v[kGroup][C];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) load_entry<P, STAGED>(tbl, (gr.x[i] * s + gr.st[i]) * P, v[i]);
  uint32_t lo[P], hi[P];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (4 * c >= M1) break;
    transpose4(v[0][c], v[1][c], v[2][c], v[3][c], lo + 4 * c);
    transpose4(v[4][c], v[5][c], v[6][c], v[7][c], hi + 4 * c);
  }
  store_rows<M1>(lo, hi, gr, M1, pitch, out);
}

// t_vec: the vector table [256][s][P]; out: rows of pitch bytes, as for the split kernel.
template <int M1, int P, bool STAGED>
__global__ void __launch_bounds__(kSpanThreads, 1)
    expand_kernel(const uint8_t* __restrict__ xs, const uint8_t* __restrict__ states,
                  const uint8_t* __restrict__ t_vec, int s, uint8_t* __restrict__ out,
                  int k_len, int lanes, int pitch) {
  extern __shared__ __align__(16) uint8_t tbl[];
  for_each_span(
      xs, states, k_len, lanes, pitch,
      [&] {
        if constexpr (STAGED) et::stage_table_async(tbl, t_vec, 256 * s * P);
      },
      [&](const Group& gr) {
        expand_full_group<M1, P, STAGED>(STAGED ? tbl : t_vec, gr, s, pitch, out);
      });
}

// Launches a span kernel: blocks of kSpanThreads with `smem` bytes of shared memory each, as
// many as the SMs hold, but no more than give each warp a span.
template <class... Params, class... Args>
int launch_spans(void (*kernel)(Params...), int smem, int k_len, int pitch, void* stream,
                 Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = et::sm_count(&sms)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSpanThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long spans = (long long)(pitch / kGroup + 31) / 32 * k_len;
  const int blocks = (int)std::min<long long>((long long)sms * std::max(per_sm, 1),
                                              et::blocks_for(spans, kSpanWarps));
  kernel<<<blocks, kSpanThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
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
  return launch_spans(kernels[n_tail], 256 * cols, k_len, pitch, stream, (const uint8_t*)xs,
                      (const uint8_t*)states, (const uint8_t*)t_split, cols, s, m,
                      (uint8_t*)out, k_len, lanes, pitch);
}

// t_vec: the vector table uint8[256][s][p], p = m + 1 rounded up to 4, 8 or 16.
int et_expand_pass(const void* xs, const void* states, const void* t_vec, int s, int m,
                   void* out, int k_len, int lanes, int pitch, void* stream) {
  using Kernel = void (*)(const uint8_t*, const uint8_t*, const uint8_t*, int, uint8_t*, int,
                          int, int);
  static const Kernel staged_kernels[] = {expand_kernel<2, 4, true>, expand_kernel<3, 4, true>,
                                          expand_kernel<4, 4, true>};
  static const Kernel l2_kernels[] = {expand_kernel<2, 4, false>, expand_kernel<3, 4, false>,
                                      expand_kernel<4, 4, false>, expand_kernel<5, 8, false>,
                                      expand_kernel<6, 8, false>, expand_kernel<7, 8, false>,
                                      expand_kernel<8, 8, false>, expand_kernel<9, 16, false>};
  if (m < 1 || m > 8 || pitch % kGroup || pitch < lanes) return (int)cudaErrorInvalidValue;
  const int p = m < 4 ? 4 : m < 8 ? 8 : 16;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // by rule: the table is staged exactly when it fits a block's shared memory (4-byte entries)
  const int bytes = 256 * s * p;
  const bool staged = p == 4 && bytes <= smem_max;
  return launch_spans(staged ? staged_kernels[m - 1] : l2_kernels[m - 1], staged ? bytes : 0,
                      k_len, pitch, stream, (const uint8_t*)xs, (const uint8_t*)states,
                      (const uint8_t*)t_vec, s, (uint8_t*)out, k_len, lanes, pitch);
}

}  // extern "C"
