"""C++ host runtime bindings (ctypes) of the port's host codec.

The port's own copy of the JAX package's runtime, reduced to the entry
points the port calls. The library loaded is the first of:

1. ``ENTREEPY_NATIVE_LIB=<path>``, a prebuilt library loaded as it is;
2. ``_native_ext.so`` beside ``native.cpp``, the portable build a wheel
   bundles (``setup.py``: ``-O3 -mtune=generic``), which needs no compiler;
3. ``native-<key>.so`` in ``_build.build_dir()`` (``build/entreepy_tpu_torch/``
   in a checkout, beside the CUDA kernels' library; the per-user cache when
   installed), keyed by a hash of the source and the CPU model, compiled
   from ``native.cpp`` with ``g++ -march=native`` the first time it is
   needed.

Without a library and a compiler (or with ``ENTREEPY_NO_NATIVE`` set) every
entry point returns None and the callers run their numpy versions: the
host codec's own fallback, not a device one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .._build import build_dir

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "native.cpp"
_EXT = _HERE / "_native_ext.so"  # the portable build a wheel bundles (setup.py)
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_ll = ctypes.c_longlong
_int = ctypes.c_int

# (name, restype, argtypes) of every entry point the port calls
_ENTRIES = (
    ("et_pack_body", _ll, [_u8p, _ll, _u32p, _u8p, _u8p]),
    ("et_unpack_body", _ll, [_u8p, _ll, _i32p, _int, _u8p, _ll]),
    ("et_decode_parallel", _ll, [_u8p, _ll, _i32p, _int, _ll, _u8p, _ll, _int, _int]),
    ("et_fsm8_expand", _ll, [_u8p, _u8p, _ll, _i8p, _u8p, _u8p, _ll]),
    ("et_fsm8_expand_chunks", _ll,
     [_u8p, _u8p, _ll, _i8p, _u8p, _ll, _ll, _u8p, _i64p, _i64p, _int]),
    ("et_fsm8_decode_parallel", _ll, [_u8p, _ll, _u8p, _i8p, _u8p, _ll, _u8p, _ll, _int]),
    ("et_histogram", None, [_u8p, _ll, _i64p, _int]),
    ("et_histogram_blocks", None, [_u8p, _ll, _ll, _i64p, _int]),
    ("et_pack_parallel", _ll, [_u8p, _ll, _u32p, _u8p, _ll, _u8p, _int]),
    ("et_pack_parallel_sized", _ll, [_u8p, _ll, _u32p, _u8p, _ll, _i64p, _u8p, _int]),
    ("et_stitch_flat", _ll, [_u32p, _i64p, _ll, _i64p, _u32p]),
    ("et_map_bytes", _int, [_u8p, _ll, _i16p, _u8p, _int]),
)


def library_path() -> Path:
    """Build path of the library: keyed by a hash of the source and the CPU
    model (the build uses -march=native, so a library built on one machine
    must not be loaded on another that shares the checkout)."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "Processor")):
                    cpu = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    key = hashlib.sha256(_SRC.read_bytes() + cpu.encode()).hexdigest()[:16]
    return build_dir() / f"native-{key}.so"


def _build(dst: Path) -> bool:
    """g++ ``native.cpp`` into ``dst`` through a private temporary file, so
    processes building at once never load a half-written library."""
    tmp = dst.with_name(f"{dst.stem}.{os.getpid()}.tmp")
    try:
        dst.parent.mkdir(parents=True, exist_ok=True)
        r = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             "-o", str(tmp), str(_SRC)],
            capture_output=True, timeout=120,
        )
        if r.returncode != 0:
            return False
        os.replace(tmp, dst)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _open() -> ctypes.CDLL | None:
    """The library by the order above with its entry points declared, or
    None. A bundled or own build that does not load or lacks an entry point
    raises: it is the package's own, not something to fall back from."""
    if os.environ.get("ENTREEPY_NO_NATIVE"):
        return None
    # ENTREEPY_NATIVE_LIB is how tools/sanitize_torch.sh injects its TSAN and
    # ASAN builds; a path there that does not load leaves the runtime off
    override = os.environ.get("ENTREEPY_NATIVE_LIB")
    if override:
        so = Path(override)
    elif _EXT.exists():
        so = _EXT
    else:
        so = library_path()
        if not so.exists() and not _build(so):
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        if so == _EXT:
            raise
        return None
    try:
        for name, restype, argtypes in _ENTRIES:
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    except AttributeError:
        if not override:
            raise
        return None
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _lib = _open()  # raises again on the next call when it raised
            _tried = True
        return _lib


def available() -> bool:
    return _load() is not None


def histogram(data: np.ndarray):
    """Threaded 256-bin byte histogram -> int64[256], or None if no lib."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.zeros(256, dtype=np.int64)
    lib.et_histogram(data, data.size, out, 0)
    return out


# Below this size a single thread wins (thread spawn ~50 us each).
PARALLEL_MIN_BYTES = 1 << 18
PACK_BLOCK_BYTES = 1 << 16
DECODE_CHUNK_BITS = 1 << 15
FSM8_CHUNK_BYTES = 1 << 16


def pack_body(data: np.ndarray, codes: np.ndarray, lengths: np.ndarray,
              exact_bits: int | None = None):
    """uint8[n] + code table -> (body bytes, total_bits) or None if no lib.

    Large inputs pack block-parallel across host threads straight into the
    final stream (shared boundary bytes OR-ed atomically). ``exact_bits``
    (the known output size, = sum over symbols of count*len) skips a whole
    histogram pass when the caller already holds the counts."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    codes_c = np.ascontiguousarray(codes, dtype=np.uint32)
    lens_c = np.ascontiguousarray(lengths, dtype=np.uint8)
    if data.size >= PARALLEL_MIN_BYTES:
        if exact_bits is None:
            # exact output size from the (threaded) histogram: worst-case
            # sizing (max_len * n bits) would over-allocate ~4x
            counts = np.zeros(256, dtype=np.int64)
            lib.et_histogram(data, data.size, counts, 0)
            exact_bits = int((counts * lengths.astype(np.int64)).sum())
        out = np.zeros(exact_bits // 8 + 2, dtype=np.uint8)  # pre-zeroed: OR-packing
        total = lib.et_pack_parallel(
            data, data.size, codes_c, lens_c, PACK_BLOCK_BYTES, out, 0
        )
    else:
        out = np.empty(int(lengths.max(initial=0)) * data.size // 8 + 2, dtype=np.uint8)
        total = lib.et_pack_body(data, data.size, codes_c, lens_c, out)
    if total < 0:
        raise ValueError("symbol without a code in the table")
    return out[: (int(total) + 7) // 8].tobytes(), int(total)


def unpack_body(body: bytes, lut_flat: np.ndarray, lookup_bits: int, n_symbols: int):
    """Packed body -> uint8[n_symbols] or None if no lib. Raises on corrupt
    or truncated streams.

    Large bodies decode chunk-parallel across host threads via the
    speculative gap-array scheme (prefix-code self-synchronization); it
    handles pathological chunks internally with serial re-walks and reports
    corrupt streams just like the serial walk does."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(body, dtype=np.uint8)
    padded = np.zeros(buf.size + 16, dtype=np.uint8)
    padded[: buf.size] = buf
    lut_c = np.ascontiguousarray(lut_flat, dtype=np.int32)
    out = np.empty(max(n_symbols, 1), dtype=np.uint8)
    if buf.size >= PARALLEL_MIN_BYTES:
        r = lib.et_decode_parallel(
            padded, buf.size, lut_c, lookup_bits, DECODE_CHUNK_BITS, out,
            n_symbols, 0, 32,
        )
    else:
        r = lib.et_unpack_body(padded, buf.size, lut_c, lookup_bits, out, n_symbols)
    if r == -1:
        raise ValueError("invalid bitstream: no code matches window")
    if r == -2:
        raise ValueError(f"bitstream ended early: decoded fewer than {n_symbols} symbols")
    return out[:n_symbols]


def fsm8_expand(states, body, counts_tbl, syms_tbl, n_symbols: int):
    """Byte-FSM state sequence -> (uint8[n_symbols], end_byte) or None if no
    lib. ``end_byte`` is the 0-based body byte where the n_symbols-th symbol
    completed (callers enforce end_byte == len(body)-1, the exact-bit
    invariant). Raises on invalid transitions / truncated streams."""
    lib = _load()
    if lib is None:
        return None
    st = np.ascontiguousarray(states, dtype=np.uint8)
    bd = np.ascontiguousarray(body, dtype=np.uint8)
    ct = np.ascontiguousarray(counts_tbl.reshape(-1), dtype=np.int8)
    sy = np.ascontiguousarray(syms_tbl.reshape(-1), dtype=np.uint8)
    out = np.empty(n_symbols + 8, dtype=np.uint8)  # 8B slack: unconditional copies
    r = lib.et_fsm8_expand(st, bd, st.size, ct, sy, out, n_symbols)
    if r == -1:
        raise ValueError("invalid bitstream: unreachable trie edge")
    if r == -2:
        raise ValueError(
            f"bitstream ended early: decoded fewer than {n_symbols} symbols"
        )
    return out[:n_symbols], int(r)


def fsm8_expand_chunks(states, body, counts_tbl, syms_tbl, chunk_bytes: int,
                       m: int):
    """Expand a precomputed state/byte region into per-chunk symbol rows.

    Returns (rows uint8[nc, chunk_bytes*m + 8] — chunk symbols
    left-justified, chunk_counts int64[nc], w_inv int64[nc]) or None if no
    lib. Validation is the caller's (ops/decode8.validate_chunk_meta)."""
    lib = _load()
    if lib is None:
        return None
    st = np.ascontiguousarray(states, dtype=np.uint8).reshape(-1)
    bd = np.ascontiguousarray(body, dtype=np.uint8).reshape(-1)
    n = st.size
    nc = max(1, -(-n // chunk_bytes))
    cap = chunk_bytes * m + 8
    out = np.empty((nc, cap), dtype=np.uint8)
    counts = np.zeros(nc, dtype=np.int64)
    w_inv = np.full(nc, -1, dtype=np.int64)
    lib.et_fsm8_expand_chunks(
        st, bd, n,
        np.ascontiguousarray(counts_tbl.reshape(-1), dtype=np.int8),
        np.ascontiguousarray(syms_tbl.reshape(-1), dtype=np.uint8),
        chunk_bytes, m, out.reshape(-1), counts, w_inv, 0,
    )
    return out, counts, w_inv


def map_bytes(data, lut16: np.ndarray):
    """Threaded 256-entry byte substitution (aligned-8 fast path).
    -> uint8 array, None if no lib, raises ValueError on a negative entry."""
    lib = _load()
    if lib is None:
        return None
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(data, np.uint8)
    lut_c = np.ascontiguousarray(lut16, dtype=np.int16)
    out = np.empty(arr.size, dtype=np.uint8)
    if lib.et_map_bytes(arr, arr.size, lut_c, out, 0) != 0:
        raise ValueError("invalid bitstream: unreachable trie edge")
    return out


def histogram_blocks(data: np.ndarray, block_bytes: int = PACK_BLOCK_BYTES):
    """Per-block 256-bin histograms -> int64[n_blocks, 256], or None. One
    pass yields the global histogram (sum), the exact packed size, AND the
    per-block bit lengths for :func:`pack_body_sized`."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    nb = max(1, -(-data.size // block_bytes))
    out = np.empty((nb, 256), dtype=np.int64)
    lib.et_histogram_blocks(data, data.size, block_bytes, out.reshape(-1), 0)
    return out


def pack_body_sized(data, codes, lengths, block_bits: np.ndarray,
                    block_bytes: int = PACK_BLOCK_BYTES):
    """Threaded pack with precomputed per-block bit lengths (no sizing pass).
    -> (body bytes, total_bits) or None. The caller guarantees every present
    symbol has a code (check the histogram against lengths)."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    bits = np.ascontiguousarray(block_bits, dtype=np.int64)
    total = int(bits.sum())
    out = np.zeros(total // 8 + 2, dtype=np.uint8)  # pre-zeroed: OR-packing
    r = lib.et_pack_parallel_sized(
        data, data.size,
        np.ascontiguousarray(codes, dtype=np.uint32),
        np.ascontiguousarray(lengths, dtype=np.uint8),
        block_bytes, bits, out, 0,
    )
    if r == -1:  # a block needed more bits than its claim: writes truncated
        raise RuntimeError(
            "pack_body_sized: a block's bits exceed its claimed size "
            "(histogram and data out of sync?)"
        )
    if r != total:  # under-used claims: totals disagree with the data
        raise RuntimeError(
            f"pack_body_sized: packed {r} bits but sizing said {total} "
            "(histogram and data out of sync?)"
        )
    return out[: (total + 7) // 8].tobytes(), total


def fsm8_decode_parallel(body, next_tbl, counts_tbl, syms_tbl, n_symbols: int):
    """Packed body -> (uint8[n_symbols], end_byte) via the threaded byte-FSM
    chunk decoder, or None if no lib. ``end_byte`` is where the n_symbols-th
    symbol completed (callers enforce end_byte == len(body)-1, the exact-bit
    invariant). Raises on invalid transitions / truncated streams."""
    lib = _load()
    if lib is None:
        return None
    bd = np.ascontiguousarray(np.frombuffer(body, dtype=np.uint8))
    nx = np.ascontiguousarray(next_tbl.reshape(-1), dtype=np.uint8)
    ct = np.ascontiguousarray(counts_tbl.reshape(-1), dtype=np.int8)
    sy = np.ascontiguousarray(syms_tbl.reshape(-1), dtype=np.uint8)
    out = np.empty(n_symbols + 8, dtype=np.uint8)  # 8B slack: unconditional copies
    r = lib.et_fsm8_decode_parallel(
        bd, bd.size, nx, ct, sy, FSM8_CHUNK_BYTES, out, n_symbols, 0
    )
    if r == -1:
        raise ValueError("invalid bitstream: unreachable trie edge")
    if r == -2:
        raise ValueError(
            f"bitstream ended early: decoded fewer than {n_symbols} symbols"
        )
    return out[:n_symbols], int(r)


def stitch_flat(flat: np.ndarray, offs: np.ndarray, bit_lens: np.ndarray):
    """Flat device-compacted words + per-block start offsets -> (stream
    uint32 words, total_bits), or None if no lib."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, dtype=np.uint32)
    offs_c = np.ascontiguousarray(offs, dtype=np.int64)
    bl = np.ascontiguousarray(bit_lens, dtype=np.int64)
    total = int(bl.sum())
    out = np.zeros(total // 32 + 2, dtype=np.uint32)
    lib.et_stitch_flat(flat, offs_c, offs_c.size, bl, out)
    return out, total
