// entreepy_tpu_torch native host runtime: the port's own copy of
// entreepy_tpu/runtime/native.cpp, unchanged apart from this note and the
// original's et_compact_symbols, which no path of the port calls (the symbols
// are selected on the device). The Python bindings (runtime/__init__.py) bind
// the entry points the port calls.
//
// The device owns the bulk compute path (ops/*.py); this library owns the
// host-side serial/bit-twiddling work around it, replacing the numpy
// fallbacks at memory-bandwidth speed:
//
//   * et_pack_body       — serial encode bit-pack (reference hot loop
//                          encode.zig:301-319, one writeBits per bit there;
//                          here a 64-bit accumulator, one store per word)
//   * et_unpack_body     — serial decode via the flat multi-level LUT
//                          (reference decode.zig:143-203 probes a hash per
//                          candidate length; here one table walk per symbol)
//   * et_assemble_payloads / et_stitch_words — compact per-block emission
//                          slots and merge per-block bitstreams at bit
//                          granularity into the single .et body
//
// Exposed with plain C linkage for ctypes (no pybind11 in this toolchain).
// All bit order is big-endian (MSB first) to match the .et format.

#ifdef __linux__
#include <sched.h>
#endif

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- encode ---
// Pack data[0..n) MSB-first using codes/lens (256 entries, right-aligned
// codes). out must hold at least (sum lens + 7) / 8 bytes. Returns total
// bits, or -1 if a byte with len==0 is hit.
long long et_pack_body(const uint8_t* data, long long n, const uint32_t* codes,
                       const uint8_t* lens, uint8_t* out) {
  uint64_t acc = 0;  // bits held in the TOP `nbits` bits
  int nbits = 0;
  long long total_bits = 0;
  uint8_t* p = out;
  for (long long i = 0; i < n; ++i) {
    const uint8_t b = data[i];
    const int len = lens[b];
    if (len == 0) return -1;
    acc |= (uint64_t)codes[b] << (64 - nbits - len);
    nbits += len;
    total_bits += len;
    while (nbits >= 8) {
      *p++ = (uint8_t)(acc >> 56);
      acc <<= 8;
      nbits -= 8;
    }
  }
  if (nbits > 0) *p++ = (uint8_t)(acc >> 56);
  return total_bits;
}

// ---------------------------------------------------------------- decode ---
// Flat multi-level LUT walk (layout of format/lut.py): entry > 0 is
// (total_len << 8) | symbol, entry < 0 is -child_table_id, 0 is invalid.
// Returns symbols decoded, or -1 on invalid window, -2 on truncated body.
long long et_unpack_body(const uint8_t* body, long long body_bytes,
                         const int32_t* lut, int lookup_bits, uint8_t* out,
                         long long n_symbols) {
  const long long avail_bits = body_bytes * 8;
  const uint32_t fanout = 1u << lookup_bits;
  const uint8_t* p = body;
  uint64_t buf = 0;
  int nbits = 0;
  long long bitpos = 0;
  for (long long i = 0; i < n_symbols; ++i) {
    if (bitpos >= avail_bits) return -2;
    while (nbits <= 56) {
      buf |= (uint64_t)(*p++) << (56 - nbits);
      nbits += 8;
    }
    int32_t tid = 0;
    int consumed = 0;
    for (;;) {
      const uint32_t idx = (uint32_t)((buf << consumed) >> (64 - lookup_bits));
      const int32_t entry = lut[(uint32_t)tid * fanout + idx];
      if (entry > 0) {
        out[i] = (uint8_t)(entry & 0xFF);
        const int len = entry >> 8;
        buf <<= len;
        nbits -= len;
        bitpos += len;
        break;
      }
      if (entry == 0) return -1;
      tid = -entry;
      consumed += lookup_bits;
      if (consumed >= 32) return -1;  // malformed LUT / corrupt stream
    }
  }
  return n_symbols;
}

// Expand the byte-FSM decoder's state sequence into symbols (ops/decode8.py:
// the TPU kernels emit one pre-transition state per compressed byte; the
// symbols come from one table lookup per byte here). counts_tbl: int8[S*256]
// (-1 = invalid transition), syms_tbl: uint8[S*256*8] left-justified.
// `out` must have >= 8 bytes of slack past n_symbols (unconditional 8-byte
// copies). Returns the 0-based byte index at which the n_symbols-th symbol
// completed (the caller's exact-bit invariant: it must be the last body
// byte), or -1 on an invalid transition consumed before the count was met,
// -2 if the body ran out first.
long long et_fsm8_expand(const uint8_t* states, const uint8_t* body,
                         long long n, const int8_t* counts_tbl,
                         const uint8_t* syms_tbl, uint8_t* out,
                         long long n_symbols) {
  long long w = 0;
  for (long long i = 0; i < n; ++i) {
    const uint32_t idx = ((uint32_t)states[i] << 8) | body[i];
    const int c = counts_tbl[idx];
    if (c != 0) {
      if (c < 0) return -1;
      std::memcpy(out + w, syms_tbl + idx * 8, 8);  // w+c advances, 8B slack
      w += c;
      if (w >= n_symbols) return i;
    }
  }
  return -2;
}

// Sum counts over the first n_real slots (truncation validation).
long long et_sum_counts(const int32_t* counts, long long n) {
  long long s = 0;
  for (long long i = 0; i < n; ++i) s += counts[i];
  return s;
}

// --------------------------------------------------------------- streams ---
// Compact dense per-block emission slots into per-block payload rows.
// words/emitted: [lanes, steps] row-major; payload: [lanes, cap] row-major
// (zeroed by caller); acc/nbits: final partial word per lane. Writes
// bit_lens[lane]. Returns 0, or -1 if a row overflows cap.
int et_assemble_payloads(const uint32_t* words, const uint8_t* emitted,
                         long long lanes, long long steps, const uint32_t* acc,
                         const int32_t* nbits, uint32_t* payload, long long cap,
                         long long* bit_lens) {
  for (long long l = 0; l < lanes; ++l) {
    const uint32_t* wrow = words + l * steps;
    const uint8_t* erow = emitted + l * steps;
    uint32_t* prow = payload + l * cap;
    long long k = 0;
    for (long long s = 0; s < steps; ++s) {
      if (erow[s]) {
        if (k >= cap) return -1;
        prow[k++] = wrow[s];
      }
    }
    if (k >= cap) return -1;
    prow[k] = acc[l];
    bit_lens[l] = k * 32 + nbits[l];
  }
  return 0;
}

// Bit-granular concatenation of per-block streams. payload: [lanes, cap]
// row-major u32 words in big-endian bit order; bit_lens per block. out:
// zeroed u32 array with capacity >= (sum bits + 31)/32 + 1 words.
// Returns total bits.
long long et_stitch_words(const uint32_t* payload, long long lanes,
                          long long cap, const long long* bit_lens,
                          uint32_t* out) {
  long long off = 0;
  for (long long l = 0; l < lanes; ++l) {
    const long long bl = bit_lens[l];
    if (bl == 0) continue;
    const uint32_t* w = payload + l * cap;
    const long long nw = (bl + 31) >> 5;
    long long base = off >> 5;
    const int s = (int)(off & 31);
    if (s == 0) {
      for (long long i = 0; i < nw; ++i) out[base + i] |= w[i];
    } else {
      for (long long i = 0; i < nw; ++i) {
        out[base + i] |= w[i] >> s;
        out[base + i + 1] |= (uint32_t)((uint64_t)w[i] << (32 - s));
      }
    }
    off += bl;
  }
  return off;
}

// Like et_stitch_words but over ONE flat word array with per-block start
// offsets (the device compaction's output layout): block l's words begin at
// flat[offs[l]]. out: zeroed u32 array, capacity >= (sum bits + 31)/32 + 1.
// Returns total bits.
long long et_stitch_flat(const uint32_t* flat, const long long* offs,
                         long long lanes, const long long* bit_lens,
                         uint32_t* out) {
  long long off = 0;
  for (long long l = 0; l < lanes; ++l) {
    const long long bl = bit_lens[l];
    if (bl == 0) continue;
    const uint32_t* w = flat + offs[l];
    const long long nw = (bl + 31) >> 5;
    long long base = off >> 5;
    const int s = (int)(off & 31);
    if (s == 0) {
      for (long long i = 0; i < nw; ++i) out[base + i] |= w[i];
    } else {
      for (long long i = 0; i < nw; ++i) {
        out[base + i] |= w[i] >> s;
        out[base + i + 1] |= (uint32_t)((uint64_t)w[i] << (32 - s));
      }
    }
    off += bl;
  }
  return off;
}

}  // extern "C" (scalar entry points)

// ------------------------------------------------------------- parallel ---
// The multithreaded host backend mirrors the TPU kernels' algorithms:
// independent blocks for encode, self-synchronizing chunks for decode
// (SURVEY.md §5 "long-context" row; the reference names block-parallel
// decoding as unimplemented future work, README.md:55).

static int et_nthreads(int requested) {
  if (requested > 0) return requested;
#ifdef __linux__
  // Respect CPU affinity (taskset / cgroup pinning): hardware_concurrency
  // ignores it and oversubscribes pinned processes ~2x.
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof set, &set) == 0) {
    const int c = CPU_COUNT(&set);
    if (c > 0) return c;
  }
#endif
  const unsigned hc = std::thread::hardware_concurrency();
  return hc ? (int)hc : 1;
}

template <typename F>
static void et_parallel_for(long long n, int nthreads, F f) {
  if (n <= 0) return;
  if (nthreads <= 1 || n == 1) {
    for (long long i = 0; i < n; ++i) f(i);
    return;
  }
  std::vector<std::thread> ts;
  const int k = (int)(nthreads < n ? nthreads : n);
  std::atomic<long long> next(0);
  for (int t = 0; t < k; ++t)
    ts.emplace_back([&] {
      for (;;) {
        const long long i = next.fetch_add(1);
        if (i >= n) return;
        f(i);
      }
    });
  for (auto& th : ts) th.join();
}

extern "C" {

// 256-bin histogram, threaded. out256 must be zeroed by the caller.
void et_histogram(const uint8_t* data, long long n, long long* out256,
                  int nthreads) {
  const int k = et_nthreads(nthreads);
  const long long stripe = (n + k - 1) / k;
  std::vector<std::vector<long long>> part((size_t)k);
  et_parallel_for(k, k, [&](long long t) {
    auto& h = part[(size_t)t];
    h.assign(256, 0);
    const long long lo = t * stripe;
    const long long hi = (lo + stripe < n) ? lo + stripe : n;
    // 4-way sub-histograms to break the store-to-load dependency
    long long h4[4][256];
    std::memset(h4, 0, sizeof h4);
    long long i = lo;
    for (; i + 4 <= hi; i += 4) {
      ++h4[0][data[i]];
      ++h4[1][data[i + 1]];
      ++h4[2][data[i + 2]];
      ++h4[3][data[i + 3]];
    }
    for (; i < hi; ++i) ++h4[0][data[i]];
    for (int s = 0; s < 256; ++s)
      h[(size_t)s] = h4[0][s] + h4[1][s] + h4[2][s] + h4[3][s];
  });
  for (int t = 0; t < k; ++t)
    for (int s = 0; s < 256; ++s) out256[s] += part[(size_t)t][(size_t)s];
}

// Per-block 256-bin histograms, threaded over blocks: out[b*256 + s].
// One pass gives the global histogram (sum over blocks), the exact output
// size, AND per-block bit lengths (counts . lens) — so the parallel pack
// can skip its sizing pass entirely (et_pack_parallel_sized).
void et_histogram_blocks(const uint8_t* data, long long n,
                         long long block_bytes, long long* out,
                         int nthreads) {
  const long long nb = (n + block_bytes - 1) / block_bytes;
  et_parallel_for(nb, et_nthreads(nthreads), [&](long long b) {
    const long long lo = b * block_bytes;
    const long long hi = (lo + block_bytes < n) ? lo + block_bytes : n;
    long long h4[4][256];
    std::memset(h4, 0, sizeof h4);
    long long i = lo;
    for (; i + 4 <= hi; i += 4) {
      ++h4[0][data[i]];
      ++h4[1][data[i + 1]];
      ++h4[2][data[i + 2]];
      ++h4[3][data[i + 3]];
    }
    for (; i < hi; ++i) ++h4[0][data[i]];
    long long* h = out + b * 256;
    for (int s = 0; s < 256; ++s) h[s] = h4[0][s] + h4[1][s] + h4[2][s] + h4[3][s];
  });
}

// Threaded block-parallel pack straight into the final (pre-zeroed) stream
// with caller-provided per-block bit lengths (from et_histogram_blocks):
// a prefix sum places every block, then blocks pack concurrently, OR-ing
// the shared boundary bytes atomically.
long long et_pack_parallel_sized(const uint8_t* data, long long n,
                                 const uint32_t* codes, const uint8_t* lens,
                                 long long block_bytes, const long long* bits,
                                 uint8_t* out, int nthreads) {
  if (n == 0) return 0;
  const long long nb = (n + block_bytes - 1) / block_bytes;
  std::vector<long long> off((size_t)nb + 1);
  off[0] = 0;
  for (long long b = 0; b < nb; ++b) off[(size_t)b + 1] = off[(size_t)b] + bits[b];
  const long long total_bits = off[(size_t)nb];

  // Each task interleaves TWO independent blocks so their serial
  // accumulator/lookup chains overlap (same trick as the decode pass 1).
  // `budget` caps writes at the caller's claimed per-block bit length: a
  // wrong `bits` array makes the pack return -1 instead of writing past the
  // output buffer (the offsets — and the caller's allocation — are derived
  // from those same claims).
  std::atomic<bool> oversized(false);
  // Fused (code << 8 | len) lookup: ONE L1 load per symbol instead of two
  // (codes and lens put the same symbol in different cache lines).
  uint64_t tbl[256];
  for (int s = 0; s < 256; ++s)
    tbl[s] = ((uint64_t)codes[s] << 8) | lens[s];
  struct PK {
    const uint8_t* i;
    const uint8_t* hi;
    uint8_t* p;
    uint8_t* safe;  // fast 8-byte stores require p + 8 <= safe (see below)
    uint64_t acc = 0;
    long long budget = 0;
    int nbits = 0;
    bool first = true;
  };
  auto pk_init = [&](long long b, PK& st) {
    const long long lo = b * block_bytes;
    const long long hie = (lo + block_bytes < n) ? lo + block_bytes : n;
    const long long start = off[(size_t)b];
    st.i = data + lo;
    st.hi = data + hie;
    st.p = out + (start >> 3);
    st.safe = out + (off[(size_t)b + 1] >> 3);
    st.nbits = (int)(start & 7);  // lead zeros over the shared boundary byte
    st.budget = bits[b];
    // A block starting ON a byte boundary owns its first byte outright (the
    // previous block's pk_finish only ORs a byte it left partial), so plain
    // stores are safe from the first flush on.
    if ((start & 7) == 0) st.first = false;
  };
  auto pk_step = [&](PK& st) {
    const uint8_t sym = *st.i++;
    st.budget -= lens[sym];
    if (st.budget < 0) {  // claimed size exceeded: truncate this block
      oversized.store(true, std::memory_order_relaxed);
      st.i = st.hi;
      return;
    }
    st.acc |= (uint64_t)codes[sym] << (64 - st.nbits - lens[sym]);
    st.nbits += lens[sym];
    while (st.nbits >= 8) {
      const uint8_t byte = (uint8_t)(st.acc >> 56);
      if (st.first) {
        __atomic_fetch_or(st.p, byte, __ATOMIC_RELAXED);
        st.first = false;
      } else {
        *st.p = byte;
      }
      ++st.p;
      st.acc <<= 8;
      st.nbits -= 8;
    }
  };
  // Branchless fast step: append the symbol's code, then flush with ONE
  // unconditional 8-byte big-endian store and advance by the completed
  // bytes. The old per-byte while-loop flush is data-dependent (~50% taken
  // on text, randomly) — its mispredicts dominated the pack. The store
  // scribbles up to 7 look-ahead bytes (pending bits, then zeros); every
  // scribbled byte is < safe and gets rewritten by a later plain store
  // before the shared boundary byte at `safe` (which only ever sees the
  // pk_finish atomic OR), so the concurrent-neighbor protocol is intact.
  // Requires !first (the block's first byte may need the atomic OR) and
  // p + 8 <= safe. nbits stays < 8 after each flush and codes are <= 32
  // bits, so the 64-bit accumulator never overflows.
  auto pk_fast = [&](PK& st) {
    const uint64_t e = tbl[*st.i++];
    const int len = (int)(e & 0xFF);
    st.budget -= len;
    if (st.budget < 0) {  // claimed size exceeded: truncate this block
      oversized.store(true, std::memory_order_relaxed);
      st.i = st.hi;
      return;
    }
    st.acc |= (e >> 8) << (64 - st.nbits - len);
    st.nbits += len;
    uint64_t be = __builtin_bswap64(st.acc);
    std::memcpy(st.p, &be, 8);
    const int nw = st.nbits >> 3;
    st.p += nw;
    st.acc <<= nw * 8;
    st.nbits &= 7;
  };
  auto pk_finish = [&](PK& st) {
    if (st.nbits > 0) __atomic_fetch_or(st.p, (uint8_t)(st.acc >> 56), __ATOMIC_RELAXED);
  };
  // Pair-interleave the blocks: overlaps the serial code-lookup/accumulator
  // chains. NB: 4-way interleave (which wins 1.7x on the decode pass 1,
  // whose 65 KB tables miss L1) measured ~25% SLOWER here — the 1 KB code
  // table is L1-resident, so latency is already hidden and the extra state
  // only spills registers.
  const long long npair = (nb + 1) / 2;
  et_parallel_for(npair, et_nthreads(nthreads), [&](long long pi) {
    PK a, b2;
    pk_init(2 * pi, a);
    if (2 * pi + 1 < nb) {
      pk_init(2 * pi + 1, b2);
      // byte-wise until each block's boundary OR has landed
      while (a.first && a.i < a.hi) pk_step(a);
      while (b2.first && b2.i < b2.hi) pk_step(b2);
      while (a.i < a.hi && a.p + 8 <= a.safe &&
             b2.i < b2.hi && b2.p + 8 <= b2.safe) {
        pk_fast(a);
        pk_fast(b2);
      }
      while (b2.i < b2.hi && b2.p + 8 <= b2.safe) pk_fast(b2);
      while (b2.i < b2.hi) pk_step(b2);
      pk_finish(b2);
    } else {
      while (a.first && a.i < a.hi) pk_step(a);
    }
    while (a.i < a.hi && a.p + 8 <= a.safe) pk_fast(a);
    while (a.i < a.hi) pk_step(a);
    pk_finish(a);
  });
  if (oversized.load()) return -1;
  return total_bits;
}

// Self-sizing variant: pass 1 sizes every block, then delegates.
long long et_pack_parallel(const uint8_t* data, long long n,
                           const uint32_t* codes, const uint8_t* lens,
                           long long block_bytes, uint8_t* out, int nthreads) {
  if (n == 0) return 0;
  const long long nb = (n + block_bytes - 1) / block_bytes;
  std::vector<long long> bits((size_t)nb);
  std::atomic<bool> bad(false);
  et_parallel_for(nb, et_nthreads(nthreads), [&](long long b) {
    const long long lo = b * block_bytes;
    const long long hi = (lo + block_bytes < n) ? lo + block_bytes : n;
    long long s = 0;
    for (long long i = lo; i < hi; ++i) {
      const int len = lens[data[i]];
      if (len == 0) bad.store(true, std::memory_order_relaxed);
      s += len;
    }
    bits[(size_t)b] = s;
  });
  if (bad.load()) return -1;
  return et_pack_parallel_sized(data, n, codes, lens, block_bytes, bits.data(),
                                out, nthreads);
}

// Sliding-bit-buffer decoder state: one byte load per 8 stream bits instead
// of an 8-byte load per symbol. `body` must be padded >= 16 bytes past the
// stream end.
struct EtWalker {
  const uint8_t* p = nullptr;
  uint64_t buf = 0;
  int nbits = 0;
  long long pos = 0;
  bool bad = false;  // last step hit an invalid window (corrupt stream)

  inline void init(const uint8_t* body, long long start) {
    p = body + (start >> 3);
    buf = 0;
    nbits = 0;
    pos = start;
    while (nbits <= 56) {
      buf |= (uint64_t)(*p++) << (56 - nbits);
      nbits += 8;
    }
    buf <<= (start & 7);  // drop the sub-byte phase
    nbits -= (int)(start & 7);
  }

  // Decode one symbol (caller checks pos < end first). Returns the symbol.
  inline uint8_t step(const int32_t* lut, int lookup_bits) {
    while (nbits <= 56) {
      buf |= (uint64_t)(*p++) << (56 - nbits);
      nbits += 8;
    }
    int len = 1;
    uint8_t sym = 0;
    int32_t tid = 0;
    int consumed = 0;
    bad = false;
    for (;;) {
      const uint32_t idx = (uint32_t)((buf << consumed) >> (64 - lookup_bits));
      const int32_t e = lut[(uint32_t)tid * (1u << lookup_bits) + idx];
      if (e > 0) {
        len = e >> 8;
        sym = (uint8_t)(e & 0xFF);
        break;
      }
      if (e == 0) {  // invalid window: emit 0, advance 1 bit, flag
        bad = true;
        break;
      }
      tid = -e;
      consumed += lookup_bits;
      if (consumed >= 32) {  // malformed LUT / corrupt stream
        bad = true;
        break;
      }
    }
    buf <<= len;
    nbits -= len;
    pos += len;
    return sym;
  }
};

// Threaded single-pass speculative chunk decode ("gap array" scheme, cf. the
// GPU decoders in PAPERS.md): every chunk decodes once in parallel from its
// own start bit (a guess for all but chunk 0), recording its first few
// codeword boundary positions; prefix codes self-synchronize, so the true
// entry of chunk i+1 (= chunk i's exit) is almost always one of those
// recorded boundaries, and a serial O(chunks) confirmation walk just looks
// it up (plus a handful of serially-decoded "gap" symbols bridging entry to
// the sync point). Chunks whose guess never synced within the recorded
// window (rare, pathological) are finished serially. Returns symbols
// written, -1 (corrupt stream: some true-path codeword hit an invalid LUT
// window), or -2 (truncated stream). max_passes is kept for ABI stability
// (the single-pass scheme has no fixed-point iteration).
long long et_decode_parallel(const uint8_t* body, long long body_bytes,
                             const int32_t* lut, int lookup_bits,
                             long long chunk_bits, uint8_t* out,
                             long long n_symbols, int nthreads,
                             int max_passes) {
  (void)max_passes;
  const long long avail = body_bytes * 8;
  const long long nc = (avail + chunk_bits - 1) / chunk_bits;
  const int k = et_nthreads(nthreads);
  constexpr int NSYNC = 64;  // boundary positions recorded per chunk

  constexpr int GAPCAP = 96;  // serially-decoded symbols bridging the gap
  struct Chunk {
    long long bounds[NSYNC];  // start bits of the first NSYNC codes (guess walk)
    uint8_t gap[GAPCAP];      // true symbols between entry and the sync point
    long long exit = 0;
    long long count = 0;      // codes in the guess walk
    long long entry = 0;      // true entry (after confirmation)
    long long emit = 0;       // true codes in this chunk
    long long from = 0;       // scratch index of the first synced code
    long long ngap = 0;
    long long last_bad = -1;  // guess-walk index of the last invalid window
    int nbounds = 0;
    bool rewalk = false;      // overflow / no sync: emit pass re-walks
  };
  std::vector<Chunk> ch((size_t)nc);

  // Per-chunk scratch for the speculative symbols. chunk_bits/2 covers every
  // realistic stream (> 2 syms/bit is impossible; exactly 1 sym/bit needs a
  // 1-bit code on every symbol); the rare overflow re-walks in the emit pass.
  const long long cap = chunk_bits / 2;
  std::unique_ptr<uint8_t[]> scratch(new uint8_t[(size_t)(nc * cap)]);
  const bool trace = std::getenv("ENTREEPY_TRACE_NATIVE") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!trace) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[native] %s %.2fms\n", name,
                 std::chrono::duration<double, std::milli>(now - tick).count());
    tick = now;
  };
  lap("alloc");

  // --- pass 1: parallel speculative decode from each chunk's own start ----
  et_parallel_for(nc, k, [&](long long i) {
    Chunk& c = ch[(size_t)i];
    const long long end = ((i + 1) * chunk_bits < avail) ? (i + 1) * chunk_bits : avail;
    uint8_t* const s = scratch.get() + i * cap;
    // hot state in locals: writes through `s`/`c` must not pin the counters
    // (or the walker) to memory via aliasing
    long long bounds[NSYNC];
    int nb = 0;
    long long count = 0;
    long long last_bad = -1;
    EtWalker w;
    w.init(body, i * chunk_bits);
    while (w.pos < end && count < cap) {
      if (nb < NSYNC) bounds[nb++] = w.pos;
      s[count] = w.step(lut, lookup_bits);
      if (w.bad) last_bad = count;
      ++count;
    }
    while (w.pos < end) {  // scratch exhausted (run-heavy stream): count only
      c.rewalk = true;
      w.step(lut, lookup_bits);
      if (w.bad) last_bad = count;
      ++count;
    }
    c.exit = w.pos;
    c.count = count;
    c.last_bad = last_bad;
    c.nbounds = nb;
    std::memcpy(c.bounds, bounds, (size_t)nb * sizeof(long long));
  });
  lap("pass1");

  // --- serial confirmation ("gap" decode): from each chunk's true entry,
  // decode serially until the walk lands on one of the guess walk's recorded
  // boundaries — prefix codes self-synchronize, so this takes a handful of
  // symbols; from that point the speculative decode is exact --------------
  std::atomic<bool> corrupt(false);
  long long entry = 0;
  for (long long i = 0; i < nc; ++i) {
    Chunk& c = ch[(size_t)i];
    const long long end = ((i + 1) * chunk_bits < avail) ? (i + 1) * chunk_bits : avail;
    c.entry = entry;
    EtWalker w;
    w.init(body, entry);
    int j = 0;
    long long vf = -1;
    while (w.pos < end) {
      while (j < c.nbounds && c.bounds[j] < w.pos) ++j;
      if (j < c.nbounds && c.bounds[j] == w.pos) {
        vf = j;
        break;
      }
      if (c.ngap >= GAPCAP) break;  // sync window exhausted
      c.gap[c.ngap++] = w.step(lut, lookup_bits);
      if (w.bad) corrupt.store(true, std::memory_order_relaxed);
    }
    if (vf >= 0) {
      // The guess walk is the true decode from bounds[vf] on, so its exit is
      // the true exit even when the scratch overflowed (vf < NSYNC <= cap);
      // overflowed chunks keep rewalk=true and re-decode in the emit pass.
      c.from = vf;
      c.emit = c.ngap + (c.count - vf);  // gap + synced suffix
      if (!c.rewalk && c.last_bad >= vf)
        corrupt.store(true, std::memory_order_relaxed);
    } else {
      // no sync within the window (pathological): finish this chunk serially
      long long cnt = c.ngap;
      while (w.pos < end) {
        w.step(lut, lookup_bits);
        if (w.bad) corrupt.store(true, std::memory_order_relaxed);
        ++cnt;
      }
      c.exit = w.pos;
      c.emit = cnt;
      c.ngap = 0;
      c.rewalk = true;
    }
    entry = c.exit;
  }
  lap("confirm");

  // --- offsets + parallel emit straight into the output buffer ------------
  std::vector<long long> off((size_t)nc + 1);
  off[0] = 0;
  for (long long i = 0; i < nc; ++i) off[(size_t)i + 1] = off[(size_t)i] + ch[(size_t)i].emit;
  if (off[(size_t)nc] < n_symbols) return -2;

  et_parallel_for(nc, k, [&](long long i) {
    const long long start = off[(size_t)i];
    if (start >= n_symbols) return;
    const Chunk& c = ch[(size_t)i];
    long long cnt = c.emit;
    if (start + cnt > n_symbols) cnt = n_symbols - start;
    if (cnt <= 0) return;
    if (!c.rewalk) {
      const long long g = c.ngap < cnt ? c.ngap : cnt;
      std::memcpy(out + start, c.gap, (size_t)g);
      if (cnt > g)
        std::memcpy(out + start + g, scratch.get() + i * cap + c.from,
                    (size_t)(cnt - g));
      return;
    }
    EtWalker w;
    w.init(body, c.entry);
    uint8_t* o = out + start;
    bool bad = false;
    for (long long j = 0; j < cnt; ++j) {
      o[j] = w.step(lut, lookup_bits);
      bad |= w.bad;
    }
    if (bad) corrupt.store(true, std::memory_order_relaxed);
  });
  lap("emit");
  if (corrupt.load()) return -1;
  return n_symbols;
}

// 256-entry byte map, threaded — the aligned-8 fast path (every code
// exactly 8 bits: decode AND encode are pure byte substitutions at memory
// bandwidth). lut: int16[256], negative = no mapping (consumed-invalid for
// decode, symbol-without-code for encode). Returns 0, or -1 if any byte
// hit a negative entry.
int et_map_bytes(const uint8_t* in, long long n, const int16_t* lut,
                 uint8_t* out, int nthreads) {
  std::atomic<bool> bad(false);
  const int k = et_nthreads(nthreads);
  const long long stripe = (n + k - 1) / k;
  et_parallel_for(k, k, [&](long long t) {
    const long long lo = t * stripe;
    const long long hi = (lo + stripe < n) ? lo + stripe : n;
    int16_t acc = 0;
    for (long long i = lo; i < hi; ++i) {
      const int16_t v = lut[in[i]];
      acc |= v;
      out[i] = (uint8_t)v;
    }
    if (acc < 0) bad.store(true, std::memory_order_relaxed);
  });
  return bad.load() ? -1 : 0;
}

// Expand a whole precomputed state/byte region to symbols with per-chunk
// metadata — the multi-host local-expansion kernel (each process expands
// only its own chunks; ops/decode8.validate_chunk_meta applies the global
// accept/reject). Chunks are independent (states are the decode passes'
// output), so this threads perfectly. out layout: [nc, chunk_bytes*m]
// row-major regions, chunk c's symbols left-justified in row c (m = the
// table's max symbols/byte; counts_tbl never exceeds it). chunk_counts[c] =
// symbols in chunk c; w_inv[c] = symbols before chunk c's FIRST invalid
// transition, or -1. Requires 8 bytes of slack per row (unconditional
// copies). Returns total symbols.
long long et_fsm8_expand_chunks(const uint8_t* states, const uint8_t* body,
                                long long n, const int8_t* counts_tbl,
                                const uint8_t* syms_tbl, long long chunk_bytes,
                                long long m, uint8_t* out,
                                long long* chunk_counts, long long* w_inv,
                                int nthreads) {
  if (n <= 0) return 0;
  const long long nc = (n + chunk_bytes - 1) / chunk_bytes;
  const long long cap = chunk_bytes * m + 8;
  et_parallel_for(nc, et_nthreads(nthreads), [&](long long c) {
    const long long lo = c * chunk_bytes;
    const long long hi = (lo + chunk_bytes < n) ? lo + chunk_bytes : n;
    uint8_t* o = out + c * cap;
    long long w = 0;
    long long winv = -1;
    for (long long i = lo; i < hi; ++i) {
      const uint32_t idx = ((uint32_t)states[i] << 8) | body[i];
      const int cnt = counts_tbl[idx];
      if (cnt > 0) {
        std::memcpy(o + w, syms_tbl + (size_t)idx * 8, 8);  // cap slack
        w += cnt;
      } else if (cnt < 0 && winv < 0) {
        winv = w;
      }
    }
    chunk_counts[c] = w;
    w_inv[c] = winv;
  });
  long long total = 0;
  for (long long c = 0; c < nc; ++c) total += chunk_counts[c];
  return total;
}

// Byte-FSM chunk-parallel decode (gen 2) — the host twin of the TPU byte-FSM
// decoder (ops/decode8.py): one table transition per compressed byte instead
// of a bit-LUT walk per symbol. Chunks decode speculatively in parallel from
// a root entry guess, recording the pre-state of their first SYNCB bytes; a
// serial confirmation walks each chunk from its true entry until the state
// matches the recorded one (prefix codes self-synchronize within a few
// bytes), then the speculative output is exact.
//
// Measured design notes (do not "optimize" these away): a scratch-free
// variant whose emit pass re-walks each chunk instead of memcpy-ing the
// speculative symbols benchmarked ~2x slower at every size (table walks
// don't stream; memcpy does), and madvise(MADV_HUGEPAGE) on the scratch
// made cold calls ~4x slower on this kernel (synchronous huge-page zeroing). Tables: next_tbl u8[S*256],
// counts_tbl i8[S*256] (-1 = invalid transition), syms_tbl u8[S*256*8].
// out must have >= 8 bytes of slack past n_symbols. Returns the 0-based
// byte index at which the n_symbols-th symbol completed (the caller checks
// it is the final body byte — the exact-bit invariant), or -1 (corrupt:
// invalid transition consumed before the count was met), -2 (truncated).
long long et_fsm8_decode_parallel(const uint8_t* body, long long n,
                                  const uint8_t* next_tbl,
                                  const int8_t* counts_tbl,
                                  const uint8_t* syms_tbl, long long chunk_bytes,
                                  uint8_t* out, long long n_symbols,
                                  int nthreads) {
  if (n_symbols <= 0) return 0;
  if (n <= 0) return -2;
  const long long nc = (n + chunk_bytes - 1) / chunk_bytes;
  const int k = et_nthreads(nthreads);
  constexpr int SYNCB = 160;  // pre-states recorded per chunk

  struct Chunk {
    uint8_t states[SYNCB];    // pre-state of byte j in the guess walk
    uint16_t syms_at[SYNCB];  // symbols emitted before byte j (guess walk)
    uint8_t gap[SYNCB * 8];   // true symbols between entry and the sync byte
    long long count = 0;      // symbols in the guess walk
    long long emit = 0;       // true symbol count
    long long ngap = 0;
    long long from_sym = 0;   // scratch symbol index where sync begins
    long long last_bad = -1;  // LAST guess-walk byte with an invalid
                              // transition: any invalid at-or-after the sync
                              // byte lies on the true path (the guess and
                              // true walks coincide from the sync byte on),
                              // and "last_bad >= sync" detects that even when
                              // a spurious pre-sync invalid also occurred
                              // (tracking only the first invalid silently
                              // accepted such corruptions)
    uint8_t entry = 0, exit = 0;
    int nrec = 0;
    bool rewalk = false;      // scratch overflow / no sync: emit re-walks
    bool bad_true = false;    // invalid transition on a serially-walked path
  };
  std::vector<Chunk> ch((size_t)nc);

  // 2 symbols of scratch per compressed byte plus copy slack; the guess walk
  // stops storing (and flags a re-walk) when the next 8-byte copy would not
  // fit, so run-heavy streams degrade to counting, never overflow. The
  // prefix recorder writes unconditionally for its first SYNCB bytes (up to
  // 8 symbols each), so cap must cover that even for tiny chunk_bytes.
  const long long cap =
      (chunk_bytes * 2 > (long long)SYNCB * 8 ? chunk_bytes * 2
                                              : (long long)SYNCB * 8) + 8;
  std::unique_ptr<uint8_t[]> scratch(new uint8_t[(size_t)(nc * cap)]);
  // Merged (count<<8 | next) table for the hot pass-1 walk: ONE random
  // cache line per walked byte instead of two (counts_tbl and next_tbl put
  // the same idx in different lines). Big-table corpora (255-state skewed
  // trees exceed L2 alongside the 512 KB syms table) measured +5-14%;
  // 92-state text +0-7% (20 MB interleaved A/B medians). Built per call:
  // <= 128 KB, trivial next to the walk.
  std::unique_ptr<uint16_t[]> comb(new uint16_t[65536]);
  {
    int hi_state = 0;
    for (long long i = 0; i < 256; ++i)
      if (next_tbl[i] > hi_state) hi_state = next_tbl[i];
    for (long long s = 1; s <= hi_state; ++s)
      for (long long b = 0; b < 256; ++b)
        if (next_tbl[(s << 8) | b] > hi_state) hi_state = next_tbl[(s << 8) | b];
    for (long long i = 0; i < (((long long)hi_state + 1) << 8); ++i)
      comb[i] = (uint16_t)(((uint16_t)(uint8_t)counts_tbl[i] << 8) | next_tbl[i]);
  }
  const bool trace = std::getenv("ENTREEPY_TRACE_NATIVE") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!trace) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[native fsm8] %s %.2fms\n", name,
                 std::chrono::duration<double, std::milli>(now - tick).count());
    tick = now;
  };
  lap("alloc");

  // --- pass 1: parallel speculative walk from state 0 at each chunk -------
  // The per-chunk walk is a serial dependency chain through next_tbl loads;
  // each task interleaves TWO independent chunks so the chains' load
  // latencies overlap (~1.4x on this host).
  struct P1State {
    const uint8_t* j;
    const uint8_t* hi;
    uint8_t* s;
    Chunk* c;
    uint32_t state = 0;
    long long w = 0;
    long long last_bad = -1;
    long long lo_idx = 0;
    bool rewalk = false;
  };
  auto p1_prefix = [&](long long i, P1State& st) {
    Chunk& c = ch[(size_t)i];
    const long long lo = i * chunk_bytes;
    const long long hi = (lo + chunk_bytes < n) ? lo + chunk_bytes : n;
    st.s = scratch.get() + i * cap;
    st.c = &c;
    st.lo_idx = lo;
    const long long rec_end = (lo + SYNCB < hi) ? lo + SYNCB : hi;
    int nrec = 0;
    for (long long j = lo; j < rec_end; ++j) {
      c.states[nrec] = (uint8_t)st.state;
      c.syms_at[nrec] = (uint16_t)st.w;  // w <= SYNCB*8 here
      ++nrec;
      const uint32_t idx = (st.state << 8) | body[j];
      const uint16_t e = comb[idx];
      const int cnt = (int8_t)(e >> 8);
      if (cnt > 0) {
        std::memcpy(st.s + st.w, syms_tbl + (size_t)idx * 8, 8);  // cap slack
        st.w += cnt;
      } else if (cnt < 0) {
        st.last_bad = j - lo;
      }
      st.state = (uint8_t)e;
    }
    c.nrec = nrec;
    st.j = body + rec_end;
    st.hi = body + hi;
  };
  auto p1_step = [&](P1State& st) {
    const uint32_t idx = (st.state << 8) | *st.j;
    const uint16_t e = comb[idx];
    const int cnt = (int8_t)(e >> 8);
    if (cnt > 0) {
      if (st.w + 8 <= cap) {
        std::memcpy(st.s + st.w, syms_tbl + (size_t)idx * 8, 8);
      } else {
        st.rewalk = true;  // scratch out of room: count only
      }
      st.w += cnt;
    } else if (cnt < 0) {
      st.last_bad = (st.j - body) - st.lo_idx;
    }
    st.state = (uint8_t)e;
    ++st.j;
  };
  auto p1_finish = [&](P1State& st) {
    Chunk& c = *st.c;
    c.count = st.w;
    c.exit = (uint8_t)st.state;
    c.last_bad = st.last_bad;
    c.rewalk = st.rewalk;
  };
  // Interleave FSM8_IL chunks per task: each chunk's walk is a serial
  // dependency chain through next_tbl loads, so interleaving overlaps the
  // load latencies (2-way measured ~1.4x in r2; 4-way adds more MLP on
  // this 2-physical-core host).
  constexpr int FSM8_IL = 4;
  const long long ngrp = (nc + FSM8_IL - 1) / FSM8_IL;
  et_parallel_for(ngrp, k, [&](long long gi) {
    P1State st[FSM8_IL];
    int nlive = 0;
    for (int t = 0; t < FSM8_IL; ++t)
      if (gi * FSM8_IL + t < nc) p1_prefix(gi * FSM8_IL + t, st[nlive++]);
    for (;;) {  // tight phase: all chains live (chunks are equal-sized)
      bool all = true;
      for (int t = 0; t < nlive; ++t) all &= st[t].j < st[t].hi;
      if (!all) break;
      for (int t = 0; t < nlive; ++t) p1_step(st[t]);
    }
    for (int t = 0; t < nlive; ++t) {  // drain the (short) tails
      while (st[t].j < st[t].hi) p1_step(st[t]);
      p1_finish(st[t]);
    }
  });
  lap("pass1");

  // --- serial confirmation: walk from the true entry until the state
  // matches the recorded guess-walk state at the same byte ------------------
  uint8_t entry = 0;
  for (long long i = 0; i < nc; ++i) {
    Chunk& c = ch[(size_t)i];
    const long long lo = i * chunk_bytes;
    const long long hi = (lo + chunk_bytes < n) ? lo + chunk_bytes : n;
    c.entry = entry;
    uint32_t state = entry;
    long long j = 0;
    long long sync = -1;
    long long ng = 0;
    for (; j < hi - lo && j < c.nrec; ++j) {
      if ((uint8_t)state == c.states[j]) {
        sync = j;
        break;
      }
      const uint32_t idx = (state << 8) | body[lo + j];
      const int cnt = counts_tbl[idx];
      if (cnt > 0) {
        std::memcpy(c.gap + ng, syms_tbl + (size_t)idx * 8, 8);
        ng += cnt;
      } else if (cnt < 0) {
        c.bad_true = true;
      }
      state = next_tbl[idx];
    }
    c.ngap = ng;
    if (sync >= 0 && !c.rewalk) {
      c.from_sym = c.syms_at[sync];
      c.emit = ng + (c.count - c.from_sym);
      // invalid transitions on/after the sync byte are on the true path
      if (c.last_bad >= sync) c.bad_true = true;
      entry = c.exit;
    } else if (sync >= 0) {
      // synced but scratch overflowed: count is exact, emit re-walks
      c.emit = ng + (c.count - c.syms_at[sync]);
      if (c.last_bad >= sync) c.bad_true = true;
      c.from_sym = sync;  // reused as the sync BYTE for the re-walk
      entry = c.exit;
    } else {
      // no sync within the recorded window (pathological): finish serially
      long long cnt2 = ng;
      for (; j < hi - lo; ++j) {
        const uint32_t idx = (state << 8) | body[lo + j];
        const int cnt = counts_tbl[idx];
        if (cnt > 0) cnt2 += cnt;
        else if (cnt < 0) c.bad_true = true;
        state = next_tbl[idx];
      }
      c.emit = cnt2;
      c.ngap = 0;
      c.rewalk = true;
      c.from_sym = -1;  // re-walk from the chunk start
      entry = (uint8_t)state;
      c.exit = entry;
    }
  }

  lap("confirm");

  // --- offsets + exact cutoff --------------------------------------------
  std::vector<long long> off((size_t)nc + 1);
  off[0] = 0;
  for (long long i = 0; i < nc; ++i)
    off[(size_t)i + 1] = off[(size_t)i] + ch[(size_t)i].emit;
  if (off[(size_t)nc] < n_symbols) return -2;

  // The chunk containing the n_symbols-th symbol: corruption consumed fully
  // is only what lies in chunks before it, plus — found by one exact table
  // walk of that chunk — anything up to the byte where the count is met.
  long long icut = 0;
  while (off[(size_t)icut + 1] < n_symbols) ++icut;
  bool bad = false;
  for (long long i = 0; i < icut; ++i)
    if (ch[(size_t)i].bad_true) bad = true;
  long long end_byte = -1;
  {
    const long long lo = icut * chunk_bytes;
    const long long hi = (lo + chunk_bytes < n) ? lo + chunk_bytes : n;
    uint32_t state = ch[(size_t)icut].entry;
    long long w = off[(size_t)icut];
    for (long long j = lo; j < hi; ++j) {
      const uint32_t idx = (state << 8) | body[j];
      const int cnt = counts_tbl[idx];
      if (cnt < 0) bad = true;
      else w += cnt;
      if (w >= n_symbols) {
        end_byte = j;
        break;
      }
      state = next_tbl[idx];
    }
  }
  if (bad) return -1;
  if (end_byte < 0) return -2;  // unreachable: off[icut+1] >= n_symbols
  lap("cutoff");

  et_parallel_for(nc, k, [&](long long i) {
    const long long start = off[(size_t)i];
    if (start >= n_symbols) return;
    const Chunk& c = ch[(size_t)i];
    long long cnt = c.emit;
    if (start + cnt > n_symbols) cnt = n_symbols - start;
    if (cnt <= 0) return;
    if (!c.rewalk) {
      const long long g = c.ngap < cnt ? c.ngap : cnt;
      std::memcpy(out + start, c.gap, (size_t)g);
      if (cnt > g)
        std::memcpy(out + start + g, scratch.get() + i * cap + c.from_sym,
                    (size_t)(cnt - g));
      return;
    }
    // serial re-walk: emit straight from the tables. If the chunk synced
    // (from_sym >= 0 is the sync byte), the gap prefix is already exact.
    const long long lo = i * chunk_bytes;
    const long long hi = (lo + chunk_bytes < n) ? lo + chunk_bytes : n;
    long long w = 0;
    long long j = lo;
    uint32_t state;
    if (c.from_sym >= 0) {
      const long long g = c.ngap < cnt ? c.ngap : cnt;
      std::memcpy(out + start, c.gap, (size_t)g);
      w = c.ngap;
      j = lo + c.from_sym;
      state = c.states[c.from_sym];
    } else {
      state = c.entry;
    }
    for (; j < hi && w < cnt; ++j) {
      const uint32_t idx = (state << 8) | body[j];
      const int cc = counts_tbl[idx];
      if (cc > 0) {
        const uint8_t* sy = syms_tbl + (size_t)idx * 8;
        if (w + 8 <= cnt) {
          // fast path: 8-byte copy stays inside this chunk's output region
          std::memcpy(out + start + w, sy, 8);
        } else {
          for (int t = 0; t < cc && w + t < cnt; ++t) out[start + w + t] = sy[t];
        }
        w += cc;
      }
      state = next_tbl[idx];
    }
  });
  lap("emit");
  return end_byte;
}

}  // extern "C"
