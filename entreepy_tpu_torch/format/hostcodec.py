"""Host (numpy) codec — exact, vectorized encode pack + serial decode.

This is the correctness anchor: the encode pack is the same
prefix-sum + scatter design the TPU kernels use (in exact uint64 arithmetic),
and the decoder is a straightforward serial LUT automaton. Device paths are
tested against these.

Replaces the reference's serial bit-at-a-time loops:
* body pack — ``encode.zig:301-319`` (one ``writeBits(..., 1)`` per bit)
* body decode — ``decode.zig:143-203`` (u32 shift register + hash probes)
"""

from __future__ import annotations

import numpy as np

from .etformat import parse_header, serialize_header
from .huffman import CodeTable, build_code_table, histogram
from .lut import DecodeLut, build_decode_lut, lut_lookup_host


def pack_body_host(
    data: np.ndarray, table: CodeTable, counts: np.ndarray | None = None
) -> tuple[bytes, int]:
    """Bit-pack ``data`` (uint8[n]) with ``table`` → (body bytes, total bits).

    Dispatches to the C++ runtime when available, else the pure-numpy
    reference (:func:`pack_body_np`). Both are bit-identical; the numpy path
    is the independent correctness anchor the native/device paths are tested
    against. ``counts`` (a byte histogram of ``data``, if the caller already
    has one) lets the native path skip its sizing histogram pass.
    """
    data = np.asarray(data, dtype=np.uint8)
    if data.size == 0:
        return b"", 0

    from .. import runtime

    if table.min_len == table.max_len == 8:
        # aligned-8 fast path (near-uniform 256-symbol data): the pack is a
        # pure byte substitution — no bit accumulator needed
        lut = np.full(256, -1, dtype=np.int16)
        present = np.flatnonzero(table.lengths == 8)
        lut[present] = table.codes[present].astype(np.int16)
        try:
            native_map = runtime.map_bytes(data, lut)
        except ValueError:
            raise ValueError("symbol without a code in the table") from None
        if native_map is not None:
            return native_map.tobytes(), data.size * 8

    exact_bits = None
    if counts is not None:
        exact_bits = int(
            (np.asarray(counts, np.int64) * table.lengths.astype(np.int64)).sum()
        )
    native = runtime.pack_body(data, table.codes, table.lengths, exact_bits)
    if native is not None:
        return native
    return pack_body_np(data, table)


def pack_body_np(data: np.ndarray, table: CodeTable) -> tuple[bytes, int]:
    """Pure-numpy pack: an exclusive prefix sum of code lengths gives every
    symbol's absolute output bit offset; each code then lands in at most two
    consecutive u32 words (code length <= 32), deposited with a scatter-add
    (codes never overlap, so add == or)."""
    data = np.asarray(data, dtype=np.uint8)
    if data.size == 0:
        return b"", 0
    lens = table.lengths[data].astype(np.int64)
    if (lens == 0).any():
        bad = int(data[lens == 0][0])
        raise ValueError(f"symbol {bad:#04x} has no code in the table")
    codes = table.codes[data].astype(np.uint64)

    ends = np.cumsum(lens)
    total_bits = int(ends[-1])
    offs = ends - lens
    word0 = (offs >> 5).astype(np.int64)
    bitpos = (offs & 31).astype(np.uint64)

    # Place each code in a 64-bit window starting at word0's bit 0 (big-endian
    # bit order: bit 0 of the window is the MSB of word0).
    contrib = codes << (np.uint64(64) - bitpos - lens.astype(np.uint64))
    hi = (contrib >> np.uint64(32)).astype(np.uint32)
    lo = (contrib & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    n_words = (total_bits + 31) // 32
    words = np.zeros(n_words + 1, dtype=np.uint32)
    np.add.at(words, word0, hi)
    np.add.at(words, word0 + 1, lo)

    n_bytes = (total_bits + 7) // 8
    return words[:n_words].astype(">u4").tobytes()[:n_bytes], total_bits


def unpack_body_host(body: bytes, lut: DecodeLut, n_symbols: int) -> np.ndarray:
    """LUT decode of a packed body → uint8[n_symbols] (C++ runtime when
    available, else the pure-Python reference :func:`unpack_body_np`)."""
    from .. import runtime

    native = runtime.unpack_body(body, lut.flat, lut.lookup_bits, n_symbols)
    if native is not None:
        return native
    return unpack_body_np(body, lut, n_symbols)


# Below this body size the LUT walk wins (byte-FSM table build ~1-2 ms).
FSM8_HOST_MIN_BYTES = 1 << 18


def _decode_aligned8(body: bytes, table: CodeTable, n_symbols: int) -> np.ndarray:
    """Fast path when EVERY code is exactly 8 bits (near-uniform 256-symbol
    data — e.g. random bytes — converges here): codes align with byte
    boundaries, so decode is one vectorized 256-entry byte map at DRAM
    bandwidth. The general FSM path is bound by its speculative-scratch ->
    output copy (~200-400 ms per 100 MB on this host) plus the 65 KB
    table walk; none of that machinery is needed when the stream has no
    cross-byte codes.

    Accept/reject matches the FSM path exactly: a byte with no 8-bit code
    raises (consumed invalid transition — only possible when the dictionary
    is incomplete), and the exact-bit invariant degenerates to
    ``len(body) == n_symbols``."""
    if len(body) != n_symbols:
        if len(body) < n_symbols:
            raise ValueError(
                f"bitstream ended early: decoded {len(body)} of {n_symbols} symbols"
            )
        raise ValueError(
            f"corrupt bitstream: {n_symbols} symbols end in body byte "
            f"{n_symbols - 1} of {len(body)}"
        )
    lut = np.full(256, -1, dtype=np.int16)
    present = np.flatnonzero(table.lengths == 8)
    lut[table.codes[present]] = present
    from .. import runtime

    native = runtime.map_bytes(body, lut)  # threaded, raises on holes
    if native is not None:
        return native
    out = lut[np.frombuffer(body, dtype=np.uint8)]
    if out.min(initial=0) < 0:
        raise ValueError("invalid bitstream: unreachable trie edge")
    return out.astype(np.uint8)


def unpack_body_fsm8(body: bytes, table: CodeTable, n_symbols: int, progress=None):
    """Byte-FSM threaded decode (gen 2 host hot path): one table transition
    per compressed byte instead of a bit-LUT walk per symbol. Returns
    uint8[n_symbols] or None when the native runtime is unavailable.
    Enforces the exact-bit invariant (sum of decoded code lengths must land
    in the body's final byte) on top of the runtime's own checks."""
    from .. import runtime
    from .fsm8 import build_byte_fsm

    if not runtime.available():
        return None
    tick = progress or (lambda pct, msg: None)
    fsm = build_byte_fsm(table)
    tick(30, "Decoding text...")
    res = runtime.fsm8_decode_parallel(
        body, fsm.next_state, fsm.counts, fsm.syms, n_symbols
    )
    if res is None:
        return None
    out, end_byte = res
    tick(75, "Decoding text...")
    _check_end_byte(end_byte, len(body), n_symbols)
    return out


def _check_end_byte(end_byte: int, n_body: int, n_symbols: int) -> None:
    """Exact-bit invariant: the n_symbols-th symbol must complete in the
    body's final byte (equivalently: the decoded code lengths sum into
    ``((n-1)*8, n*8]`` bits — anything else is a truncated-but-plausible or
    over-long stream)."""
    if end_byte != n_body - 1:
        raise ValueError(
            f"corrupt bitstream: {n_symbols} symbols end in body byte "
            f"{end_byte} of {n_body}"
        )


def _check_stream_bits(out: np.ndarray, lengths: np.ndarray, n_body: int) -> None:
    """The exact-bit invariant for paths that do not track an end byte (the
    serial LUT walk): sum the decoded code lengths via a histogram and
    require them to land in the final body byte — keeps accept/reject
    behavior identical across every backend."""
    from .. import runtime

    hist = runtime.histogram(out)
    if hist is None:
        hist = np.bincount(out, minlength=256).astype(np.int64)
    used = int((hist * lengths.astype(np.int64)).sum())
    if not (n_body - 1) * 8 < used <= n_body * 8:
        raise ValueError(
            f"corrupt bitstream: {out.size} symbols span {used} bits, "
            f"body has {n_body * 8}"
        )


def unpack_body_np(body: bytes, lut: DecodeLut, n_symbols: int) -> np.ndarray:
    """Pure-Python serial LUT walk — the independent correctness anchor."""
    buf = np.frombuffer(body, dtype=np.uint8)
    # Zero-pad so any 32-bit window read beyond the stream end is valid.
    padded = np.zeros(((buf.size + 3) // 4 + 2) * 4, dtype=np.uint8)
    padded[: buf.size] = buf
    words = padded.view(">u4").astype(np.uint32)

    out = np.empty(n_symbols, dtype=np.uint8)
    avail_bits = buf.size * 8
    bitpos = 0
    for i in range(n_symbols):
        if bitpos >= avail_bits:
            raise ValueError(
                f"bitstream ended early: decoded {i} of {n_symbols} symbols"
            )
        w0 = int(words[bitpos >> 5])
        w1 = int(words[(bitpos >> 5) + 1])
        sh = bitpos & 31
        window = ((w0 << sh) | (w1 >> (32 - sh) if sh else 0)) & 0xFFFFFFFF
        sym, length = lut_lookup_host(lut, window)
        out[i] = sym
        bitpos += length
    if bitpos > len(body) * 8:
        raise ValueError("bitstream ended before all symbols were decoded")
    return out


def compress_host(data: bytes, *, strict: bool = True, progress=None) -> bytes:
    """bytes → complete .et file, byte-identical to the reference's output.

    ``progress(pct, msg)`` (optional) is called at *measured* completion
    points: the histogram runs in 10 slices (the reference's 10 encode
    sections, ``encode.zig:303-315``, measured here instead of staged), then
    tree build, body pack, and serialization tick as they actually finish.
    """
    from ..utils.trace import phase

    from .. import runtime

    tick = progress or (lambda pct, msg: None)
    arr = np.frombuffer(data, dtype=np.uint8)

    # Fast path: ONE data pass computes per-block histograms; their sum is
    # the global histogram, their dot with the code lengths gives both the
    # exact output size and each block's bit offset — so the threaded pack
    # needs no sizing pass of its own. With a progress callback the same
    # pass runs in 10 block-aligned sections (measured ticks, same result).
    counts_blocks = None
    if arr.size >= runtime.PARALLEL_MIN_BYTES:
        with phase("histogram", arr.size):
            if progress is None:
                counts_blocks = runtime.histogram_blocks(arr)
            else:
                bb = runtime.PACK_BLOCK_BYTES
                nb = -(-arr.size // bb)
                groups = np.linspace(0, nb, 11, dtype=np.int64)
                rows = []
                for gi in range(10):
                    b0, b1 = int(groups[gi]), int(groups[gi + 1])
                    if b1 > b0:
                        part = runtime.histogram_blocks(
                            arr[b0 * bb : min(b1 * bb, arr.size)], bb
                        )
                        if part is None:
                            rows = None
                            break
                        rows.append(part)
                    tick(5 + 3 * (gi + 1), "Counting characters...")
                if rows:
                    counts_blocks = np.concatenate(rows)
    if counts_blocks is not None:
        counts = counts_blocks.sum(axis=0)
        with phase("code_table"):
            table = build_code_table(counts, strict=strict)
        tick(40, "Building tree...")
        with phase("pack_body", arr.size):
            if table.min_len == table.max_len == 8:
                # aligned-8 byte map (counts keep the fallback single-pass)
                packed = pack_body_host(arr, table, counts=counts)
            else:
                block_bits = counts_blocks @ table.lengths.astype(np.int64)
                packed = runtime.pack_body_sized(
                    arr, table.codes, table.lengths, block_bits
                )
            if packed is None:  # stale lib without the sized entry point
                packed = pack_body_host(arr, table, counts=counts)
        tick(90, "Writing compressed text...")
        return serialize_header(table, arr.size) + packed[0]

    with phase("histogram", arr.size):
        if progress is not None and arr.size >= 10:
            counts = np.zeros(256, dtype=np.int64)
            bounds = np.linspace(0, arr.size, 11, dtype=np.int64)
            for i in range(10):
                counts += histogram(arr[bounds[i] : bounds[i + 1]])
                tick(5 + 3 * (i + 1), "Counting characters...")
        else:
            counts = histogram(arr)
    with phase("code_table"):
        table = build_code_table(counts, strict=strict)
    tick(40, "Building tree...")
    with phase("pack_body", arr.size):
        body, _ = pack_body_host(arr, table, counts=counts)
    tick(90, "Writing compressed text...")
    return serialize_header(table, arr.size) + body


def decompress_host(et: bytes, *, progress=None) -> bytes:
    """complete .et file → original bytes (validates magic/version).
    ``progress(pct, msg)`` ticks at measured phase completions."""
    from ..utils.trace import phase

    tick = progress or (lambda pct, msg: None)
    with phase("parse_header"):
        hdr = parse_header(et)
    tick(15, "Decoding text...")
    body = memoryview(et)[hdr.body_start :]  # zero-copy (the slice would
    # memcpy ~the whole file; every consumer below is buffer-protocol)
    if hdr.table.min_len == hdr.table.max_len == 8 and hdr.body_len > 0:
        with phase("unpack_body_aligned8", hdr.body_len):
            out = _decode_aligned8(body, hdr.table, hdr.body_len)
        tick(90, "Writing decoded text...")
        return out.tobytes()
    if len(body) >= FSM8_HOST_MIN_BYTES:
        with phase("unpack_body_fsm8", hdr.body_len):
            out = unpack_body_fsm8(body, hdr.table, hdr.body_len, progress=tick)
        if out is not None:
            tick(90, "Writing decoded text...")
            return out.tobytes()
    with phase("unpack_body", hdr.body_len):
        lut = build_decode_lut(hdr.table)
        tick(25, "Decoding text...")
        out = unpack_body_host(body, lut, hdr.body_len)
        _check_stream_bits(out, hdr.table.lengths, len(body))
    tick(90, "Writing decoded text...")
    return out.tobytes()
