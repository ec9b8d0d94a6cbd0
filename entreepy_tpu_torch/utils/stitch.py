"""Bit-granular stitching of per-block packed streams (host, vectorized numpy).

Blocks pack independently on device; the .et body is a single continuous
bitstream, so block payloads must be merged with sub-byte shifts. Each merge
is two vectorized funnel-shift ORs over the block's words, O(total bytes) at
memory bandwidth. The C++ runtime's ``stitch_flat`` does the same when it is
built; this is the portable fallback and the correctness reference for it.
"""

from __future__ import annotations

import numpy as np

from .. import runtime


def stitch_words(payloads, bit_lens) -> tuple[np.ndarray, int]:
    """Merge per-block bitstreams into one.

    payloads: iterable of uint32 arrays (big-endian bit order: bit 0 of the
    stream is the MSB of word 0), zero beyond each block's ``bit_len``.
    bit_lens: exact bit length per block.

    Returns (uint32 words of the concatenated stream, total_bits).
    """
    bit_lens = [int(b) for b in bit_lens]
    total_bits = sum(bit_lens)
    out = np.zeros((total_bits + 31) // 32 + 1, dtype=np.uint32)
    off = 0
    for words, bl in zip(payloads, bit_lens):
        if bl == 0:
            continue
        nw = (bl + 31) // 32
        w = np.asarray(words[:nw], dtype=np.uint32)
        base = off >> 5
        s = off & 31
        if s == 0:
            out[base : base + nw] |= w
        else:
            out[base : base + nw] |= w >> s
            out[base + 1 : base + nw + 1] |= (w << (32 - s)).astype(np.uint32)
        off += bl
    return out, total_bits


def stitch_flat_payload(
    flat: np.ndarray, nwords: np.ndarray, bit_lens, offs: np.ndarray | None = None
) -> tuple[np.ndarray, int]:
    """Stitch the device compaction's flat layout: block l's ``nwords[l]``
    words start at ``offs[l]`` (default ``sum(nwords[:l])``, the
    single-device layout; the sharded encode passes rank-based offsets).
    Dispatches to the C++ runtime, else per-block views through
    :func:`stitch_words`."""
    nw = np.asarray(nwords, dtype=np.int64)
    bl = np.asarray(bit_lens, dtype=np.int64)
    if bl.size and bl.min(initial=0) < 0:
        # the device compaction poisons bit_lens to -1 on subgroup-cap
        # overflow; enforce the fail-loud contract at the consumption point
        # instead of emitting a silently corrupt stream.
        raise ValueError("negative block bit length: device compaction overflowed")
    if offs is None:
        offs = np.concatenate([[0], np.cumsum(nw)[:-1]])
    offs = np.asarray(offs, dtype=np.int64)
    native = runtime.stitch_flat(flat, offs, bl)
    if native is not None:
        return native
    views = [flat[offs[l] : offs[l] + nw[l]] for l in range(nw.size)]
    return stitch_words(views, bit_lens)


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Big-endian u32 words -> the stream's bytes (zero-padded final byte)."""
    n_bytes = (total_bits + 7) // 8
    return words.astype(">u4").tobytes()[:n_bytes]


def split_blocks(arr: np.ndarray, block_bytes: int) -> tuple[np.ndarray, np.ndarray]:
    """Reshape a byte array into zero-padded [n_blocks, block_bytes] + valid counts."""
    n = arr.size
    n_blocks = max(1, -(-n // block_bytes))
    padded = np.zeros(n_blocks * block_bytes, dtype=np.uint8)
    padded[:n] = arr
    valid = np.full(n_blocks, block_bytes, dtype=np.int32)
    valid[-1] = n - (n_blocks - 1) * block_bytes
    return padded.reshape(n_blocks, block_bytes), valid
