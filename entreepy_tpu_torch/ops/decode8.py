"""Chunk-parallel Huffman decode on one device: the byte-FSM routes.

Counterpart of ``entreepy_tpu/ops/decode8.py`` (its module docstring has the
design). The body splits into ``chunk_bytes`` chunks, one lane each. A suffix
sync pass guesses each chunk's entry state, then full passes run until the
entry states reach a fixed point (:func:`_fixed_point`). The caller picks the
route (``expand``; the JAX package's ``ENTREEPY_EXPAND`` and
``ENTREEPY_DEVICE_E2E`` choose the same routes from the environment):

* ``onepass`` (default): fused passes emit the symbols with the state chain.
  For m <= 3 (the table's most symbols per byte) each byte is one masked
  word, read as it is by the symbols kernel (:func:`packed_symbols`); for
  m > 3 each byte is m + 1 rows, packed by the per-subgroup compaction
  kernel first (:func:`plane_symbols`);
* ``split`` / ``fused``: two-pass. Emit passes write each byte's
  pre-transition state (:func:`fsm8_decode`), an expansion kernel turns
  (byte, state) into rows through the split or the full expand table, and
  the compaction kernel packs them (:func:`plane_symbols`);
* ``host``: the emit passes' states are fetched in stream order, one byte
  per body byte, and the host runtime expands them
  (:func:`decode_body_device`).

One card and each rank of a mesh (``parallel.dist``) run one route step:
:func:`route_tables`, :func:`route_passes` (upload and fixed point),
:func:`route_symbols`. The device routes end in the symbols kernel
(``ops/cuda_symbols``), which writes each lane's symbols at the lane's
offset on the device, so the host fetches only the symbols in stream order
and the per-lane metadata, lands them in the output (:func:`land_symbols`)
and runs the host tail (:func:`host_validate`, :func:`host_check_bits`).
:func:`decode_body_device_tiled` runs the step in tiles of up to
``TILE_LANES`` lanes on the one-pass route, each tile's fetch overlapped
with the next tile's upload and passes, and as one tile up to the int32
position bound on the two-pass device routes.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from .. import format as _fmt
from .. import runtime
from ..format.etformat import parse_header
from ..format.fsm8 import ByteFsm, build_byte_fsm
from ..format.hostcodec import _check_end_byte, _check_stream_bits
from ..format.huffman import CodeTable
from ..tables import (
    CodeTrie,
    ExpandTables,
    builds_on_card,
    card_decode_tables,
    code_trie,
    decode_tables,
    expand_tables,
    fetch,
    next_state_tensor,
    to_device,
)
from ..trace import count, phase
from . import cuda_fsm8
from .cuda_compact import compact_rows
from .cuda_symbols import NO_INVALID, symbol_counts, write_symbols
from .cuda_fsm8 import emit_pass, fused_pass, sync_pass

DEFAULT_CHUNK_BYTES = 512
# Suffix bytes per chunk for the entry-state first guess (one missed guess
# costs a whole extra fused pass over every lane).
SYNC_WINDOW = 128
MAX_SYNC_PASSES = 24
SUB_BYTES = 8  # bytes per compaction subgroup on the m > 3 route
CAP_SYM_ROUND = 16  # per-subgroup symbol caps round up to this
# The untiled route keeps lane-linear byte positions within int32, like the
# JAX route it ports; larger bodies belong to the streaming tiled route.
MAX_UNTILED_BYTES = (1 << 31) - 1
# Decode routes of ``decompress_device`` (see the module docstring).
EXPAND_MODES = ("onepass", "split", "fused", "host")
# Lanes per tile of the streaming one-pass decode: 65536 lanes x 512 B chunks
# = 32 MB of compressed body per tile, so the device working set is bounded
# by the tile, not the body.
TILE_LANES = 65536


def bytes_to_cols(padded: np.ndarray, lanes: int, k: int, device) -> torch.Tensor:
    """uint8[lanes*k] -> uint8[lanes, k] byte columns on ``device``."""
    return to_device(padded.reshape(lanes, k), device)


def _one_rank(exits: torch.Tensor):
    return exits, 0


def _fixed_point(xs: torch.Tensor, next_state: torch.Tensor, n_real_lanes: int,
                 entry0: int | torch.Tensor, run_pass, gather=_one_rank):
    """Entry states of xs uint8[K, lanes] to their fixed point: the suffix
    sync pass guesses each lane's entry, then ``run_pass(entries) -> (out,
    exits int32[lanes])`` runs until no real lane's entry changes. Lanes from
    ``n_real_lanes`` on are padding and stay out of the convergence test;
    ``entry0`` pins lane 0's entry state: an int, or a one-element int32
    tensor on the device (a previous tile's exit, read without a host sync).
    Returns (out, exits, unconverged bool) of the last pass.

    ``gather(exits) -> (exits of every lane in rank order, this rank's first
    lane)`` spans the chain over ranks that each hold ``lanes`` of the
    lanes (the sharded decode; the default is one rank holding them all).
    The chain, the convergence test, ``n_real_lanes``, ``entry0`` and the
    returned exits are over every lane; each pass gets this rank's slice.
    The loop decides only on gathered values, so every rank runs the same
    passes (and the same collectives).

    The fixed point is a Python loop with one small device-to-host check per
    pass; it normally runs one pass (the suffix guess is near exact)."""
    k, lanes = xs.shape
    dev = xs.device
    e0 = (entry0.reshape(1) if torch.is_tensor(entry0)
          else torch.full((1,), entry0, dtype=torch.int32, device=dev))
    w = min(SYNC_WINDOW, k)
    suffix_exits, lo = gather(sync_pass(xs[k - w:], next_state,
                                        torch.zeros(lanes, dtype=torch.int32, device=dev)))
    real = torch.arange(suffix_exits.numel(), device=dev) < n_real_lanes
    entries = torch.cat([e0, suffix_exits[:-1]])
    prev = entries - 1  # forces the first pass
    out = exits = None
    for _ in range(MAX_SYNC_PASSES):
        if not bool(((entries != prev) & real).any()):
            break
        out, exits = run_pass(entries[lo:lo + lanes])
        exits, _ = gather(exits)
        prev, entries = entries, torch.cat([e0, exits[:-1]])
    unconverged = bool(((entries != prev) & real).any())
    return out, exits, unconverged


def fsm8_decode_fused(cols: torch.Tensor, next_state: torch.Tensor,
                      t_fused: torch.Tensor, n_real_lanes: int, m: int,
                      mt: int, s: int, *, packed: bool = False,
                      n_valid: int | None = None, entry0: int | torch.Tensor = 0,
                      gather=_one_rank):
    """One-pass decode of cols uint8[lanes, K] -> (vals, exits int32[lanes],
    unconverged bool). vals is int32[K, m+1, lanes], or with ``packed``
    MASKED one-word rows int32[K, lanes] (``n_valid`` required, in this
    rank's lane-linear positions). Padding lanes, ``entry0`` and
    ``gather`` as in :func:`_fixed_point`."""
    xs = cols.t().contiguous()  # [K, lanes]
    return _fixed_point(
        xs, next_state, n_real_lanes, entry0,
        lambda entries: fused_pass(xs, t_fused, entries, m, mt, s,
                                   packed=packed, n_valid=n_valid),
        gather,
    )


def fsm8_decode(xs: torch.Tensor, next_state: torch.Tensor, n_real_lanes: int,
                gather=_one_rank):
    """The two-pass decode's state pass: emit passes over xs uint8[K, lanes]
    (the kernels' layout; the JAX package's is its transpose) to the fixed
    point, lane 0 entering at the root. Returns (states uint8[K, lanes],
    each byte's pre-transition state, and unconverged bool). Padding lanes
    and ``gather`` as in :func:`_fixed_point`."""
    states, _exits, unconverged = _fixed_point(
        xs, next_state, n_real_lanes, 0,
        lambda entries: emit_pass(xs, next_state, entries),
        gather,
    )
    return states, unconverged


def _expand_mask(raw: torch.Tensor, syms: torch.Tensor, n_valid: int):
    """Unpacked rows: apply the real-byte mask (lane-linear position <
    ``n_valid``) and split count | 16*invalid (row 0, int32 or uint8) ->
    (counts int32, inv bool, syms)."""
    k, lanes = raw.shape
    dev = raw.device
    raw = raw.int()
    pos = (torch.arange(lanes, device=dev)[None, :] * k
           + torch.arange(k, device=dev)[:, None])
    real = pos < n_valid
    return torch.where(real, raw & 15, 0), real & (raw >= 16), syms


def expand_rows(xs: torch.Tensor, states: torch.Tensor, tables: ExpandTables) -> torch.Tensor:
    """The two-pass expansion kernel (the JAX package's ``expand_pass_split``
    and ``expand_pass_device``): xs/states uint8[K, lanes] through the split
    table, or the full one when ``tables.mt`` is None -> unmasked uint8 rows
    [K, m+1, lanes] (row 0 count | 16*invalid, then the m slots)."""
    if tables.mt is None:
        return cuda_fsm8.expand_pass(xs, states, tables.table, tables.m, tables.vec)
    return cuda_fsm8.expand_pass_split(xs, states, tables.table, tables.m, tables.mt)


def _sub_width(k: int) -> int:
    return SUB_BYTES if k % SUB_BYTES == 0 else k


def _write_lanes(items: torch.Tensor, lane_n: torch.Tensor, m: int,
             mini_tot: torch.Tensor | None = None, cap: int = 0) -> torch.Tensor:
    """The symbols kernel's write launch over ``items`` whose lanes hold
    ``lane_n`` int32[lanes] symbols each: their inclusive scan gives each
    lane's end, and the last end, read back, sizes the output."""
    ends = lane_n.cumsum(0, dtype=torch.int64)
    return write_symbols(items, ends, int(ends[-1]), m, mini_tot, cap)


def packed_symbols(words: torch.Tensor, m: int):
    """MASKED packed words int32[K, lanes] (m <= 3) -> (symbols uint8 in
    stream order, lane_tot int32[lanes], w_inv int32[lanes]) on their
    device: the symbols kernel's count launch, then its write launch."""
    count("plane_slots", words.numel() * m)
    lane_tot, w_inv = symbol_counts(words, m)
    return _write_lanes(words, lane_tot, m), lane_tot, w_inv


def plane_symbols(vals: torch.Tensor, m: int, n_valid: int):
    """Unpacked rows [K, m+1, lanes] (int32 of the fused pass, or uint8 of
    an expansion) -> (symbols uint8 in stream order, lane_tot, w_inv). Inside
    the stage ``plane_compact``: the real-byte mask (lane-linear position <
    ``n_valid``, :func:`_expand_mask`), the cap read back (:func:`sym_cap`)
    and the compacted plane (:func:`compact_symbols_device`), counted once
    in ``plane_compactions``; then the symbols kernel's write launch over
    the plane. ``lane_tot`` is poisoned to -1 on a cap overflow, which
    :func:`validate_chunk_meta` then refuses; the symbols are the slots the
    plane kept."""
    with phase("plane_compact"):
        counts, inv, syms = _expand_mask(vals[:, 0], vals[:, 1:].to(torch.uint8), n_valid)
        cap = sym_cap(counts, m)
        plane, mini_tot, lane_tot, w_inv = compact_symbols_device(counts, inv, syms, m, cap)
    count("plane_compactions", 1)
    count("plane_slots", plane.numel())
    kept = mini_tot.clamp(max=cap).sum(0, dtype=torch.int32)
    return _write_lanes(plane, kept, 1, mini_tot, cap), lane_tot, w_inv


def onepass_symbols(vals: torch.Tensor, m: int, packed: bool, n_valid: int):
    """Fused-pass rows -> (symbols, lane_tot, w_inv) on their device: MASKED
    packed words (m <= 3) straight into the symbols kernel, else
    :func:`plane_symbols`."""
    if packed:
        return packed_symbols(vals, m)
    return plane_symbols(vals, m, n_valid)


def sym_cap(counts: torch.Tensor, m: int) -> int:
    """Per-subgroup symbol cap for :func:`compact_symbols_device`: fetches
    the subgroup totals' max and rounds it up to CAP_SYM_ROUND."""
    k, lanes = counts.shape
    sb = _sub_width(k)
    mx = max(int(counts.reshape(k // sb, sb, lanes).sum(1).max()), 1)
    return min(-(-mx // CAP_SYM_ROUND) * CAP_SYM_ROUND, sb * m)


def compact_symbols_device(counts: torch.Tensor, inv: torch.Tensor,
                           syms: torch.Tensor, m: int, cap_sym: int):
    """Dense per-byte symbol slots -> per-subgroup compacted symbol planes.

    counts/inv int32/bool[K, lanes], syms uint8[K, m, lanes]. Each
    SUB_BYTES-byte subgroup of a lane packs its live slots (``j < count``)
    to its front through the compaction kernel; row ``g*cap_sym + j`` of
    column ``l`` is slot ``j`` of subgroup ``g`` of lane ``l``. Returns
    (plane uint8[Gs*cap_sym, lanes], mini_tot int32[Gs, lanes], lane_tot
    int32[lanes] — poisoned to -1 if a subgroup overflows the cap — and
    w_inv int32[lanes])."""
    k, lanes = counts.shape
    dev = counts.device
    sb = _sub_width(k)
    gs, sg = k // sb, sb * m
    c3 = counts.reshape(gs, sb, lanes)
    cums = c3.cumsum(1, dtype=torch.int32) - c3
    mini_tot = cums[:, -1] + c3[:, -1]
    g_start = mini_tot.cumsum(0, dtype=torch.int32) - mini_tot
    lane_tot = g_start[-1] + mini_tot[-1]
    w_inv = torch.where(inv.reshape(gs, sb, lanes), g_start[:, None] + cums,
                        NO_INVALID).amin((0, 1))

    live = torch.arange(m, device=dev)[None, :, None] < counts[:, None, :]
    # one contiguous int32 copy, also of a strided view of an expansion's rows' slots
    plane, _ = compact_rows(syms.to(torch.int32).reshape(k * m, lanes),
                            live.reshape(k * m, lanes), sg, cap_sym)
    # an under-sized cap would silently truncate a subgroup: reject loudly
    lane_tot = torch.where(mini_tot.max() > cap_sym, -1, lane_tot)
    return plane.to(torch.uint8), mini_tot, lane_tot, w_inv


def validate_chunk_meta(counts: np.ndarray, w_inv: np.ndarray, n_symbols: int) -> None:
    """Serial-exact accept/reject from per-chunk metadata: ``counts[c]`` =
    symbols chunk c emits, ``w_inv[c]`` = symbols emitted before chunk c's
    FIRST invalid transition (-1 if none). An invalid transition raises iff
    it is consumed — i.e. lies at-or-before the byte where the n_symbols-th
    symbol completes — matching the serial walk."""
    total = int(counts.sum())
    if total < n_symbols:
        raise ValueError(
            f"bitstream ended early: decoded {total} of {n_symbols} symbols"
        )
    starts = np.cumsum(counts) - counts
    if bool(((w_inv >= 0) & (starts + w_inv < n_symbols)).any()):
        raise ValueError("invalid bitstream: unreachable trie edge")


def extract_plane_symbols(syms: np.ndarray, room: int) -> np.ndarray:
    """A fetch's symbols, already in stream order (the symbols kernel put
    each lane's live slots at the lane's offset), cut to the ``room`` the
    output has left -> uint8 symbols in stream order."""
    return syms[:room]


def fetch_symbols(pending):
    """Wait for the fetch of (symbols, lane_tot, w_inv) -> their numpy
    arrays. ``pending`` is the tensors, fetched here, or the wait of a
    fetch that :func:`_fetch_async` started earlier (the tiled decode's,
    behind the next tile's passes)."""
    with phase("device_sym_fetch"):
        wait = pending if callable(pending) else _fetch_async(pending)
        syms, lane_tot, w_inv = wait()
    count("symbols", syms.size)
    return syms, lane_tot, w_inv


def land_symbols(pending, out: np.ndarray, at: int, metas: list) -> int:
    """Fetch ``pending``'s symbols (:func:`fetch_symbols`) and land them in
    ``out`` from ``at`` on, as many as fit; its (lane_tot, w_inv) joins
    ``metas``. Returns the next free position. The fetched buffer is let go
    on return, so a tiled decode holds one tile's symbols at a time."""
    syms, lane_tot, w_inv = fetch_symbols(pending)
    metas.append((lane_tot, w_inv))
    with phase("host_extract"):
        got = extract_plane_symbols(syms, out.size - at)
        out[at:at + got.size] = got
    return at + got.size


def take_symbols(pending):
    """A mesh rank's fetch (:func:`fetch_symbols`), its symbols taken whole
    (``host_extract``; the caller joins the ranks') -> (symbols, lane_tot, w_inv)."""
    syms, lane_tot, w_inv = fetch_symbols(pending)
    with phase("host_extract"):
        return extract_plane_symbols(syms, syms.size), lane_tot, w_inv


def host_validate(metas, n_symbols: int) -> None:
    """Serial-exact accept/reject over the concatenated per-lane metadata
    (``metas``: one (lane_tot, w_inv) per tile or rank, in stream order;
    ``w_inv`` NO_INVALID or -1 where a lane has no invalid transition)."""
    with phase("host_validate"):
        lane_tot = np.concatenate([np.asarray(c, dtype=np.int64) for c, _ in metas])
        w_inv = np.concatenate([np.asarray(w, dtype=np.int64) for _, w in metas])
        w_inv[w_inv >= NO_INVALID] = -1
        validate_chunk_meta(lane_tot, w_inv, n_symbols)


def host_check_bits(out: np.ndarray, filled: int, n_symbols: int, table,
                    n_body: int) -> np.ndarray:
    """``out``, whose first ``filled`` symbols were landed, held to
    ``n_symbols`` and to the exact-bit invariant -> ``out``."""
    if filled < n_symbols:
        raise ValueError(f"bitstream ended early: decoded {filled} of {n_symbols} symbols")
    with phase("host_check_bits"):
        _check_stream_bits(out, table.lengths, n_body)
    return out


def decode_host(buf: np.ndarray, table: CodeTable, n_symbols: int) -> np.ndarray:
    """The exact serial host decoder, for streams whose chunk self-sync does
    not converge in MAX_SYNC_PASSES (pathologically periodic streams).
    ``decode_host.calls`` counts its uses (under a lock: the ranks of a
    local mesh call it from several threads)."""
    with _calls_lock:
        decode_host.calls += 1
    lut = _fmt.build_decode_lut(table)
    out = _fmt.unpack_body_host(buf.tobytes(), lut, n_symbols)
    _check_stream_bits(out, table.lengths, buf.size)
    return out


decode_host.calls = 0
_calls_lock = threading.Lock()


def _body_buf(body: bytes | np.ndarray) -> np.ndarray:
    return (
        np.frombuffer(body, dtype=np.uint8)
        if isinstance(body, (bytes, bytearray, memoryview))
        else np.asarray(body, dtype=np.uint8)
    )


def _upload_body(buf: np.ndarray, lanes: int, chunk_bytes: int, device) -> torch.Tensor:
    """The body zero-padded to ``lanes`` chunks, as cols uint8[lanes, K] on
    ``device``."""
    with phase("body_upload", buf.size):
        padded = np.zeros(lanes * chunk_bytes, dtype=np.uint8)
        padded[: buf.size] = buf
        return bytes_to_cols(padded, lanes, chunk_bytes, device)


def route_tables(table: CodeTable, device, expand: str,
                 fsm: ByteFsm | CodeTrie | None = None):
    """The ``expand`` route's tables on ``device`` (stage ``decode_tables``)
    -> (fsm, tables): the one-pass ``DecodeTables``, the two-pass
    ``ExpandTables`` with the split or the full expand table, or on the
    host route the state pass's ``next_state`` alone. ``fsm`` is what they
    are built from, built from ``table`` inside the stage unless given (a
    mesh's ranks share the caller's): on a CUDA device the one-pass tables'
    ``CodeTrie``, from which the card builds them
    (``tables.card_decode_tables``; fsm None on return), else a
    ``ByteFsm``."""
    with phase("decode_tables"):
        if builds_on_card(device, expand):
            return None, card_decode_tables(code_trie(table) if fsm is None else fsm, device)
        fsm = build_byte_fsm(table) if fsm is None else fsm
        if expand == "onepass":
            return fsm, decode_tables(fsm, device)
        if expand == "host":
            return fsm, next_state_tensor(fsm, device)
        return fsm, expand_tables(fsm, device, split=expand == "split")


def route_passes(seg: np.ndarray, lanes: int, chunk_bytes: int, device, tables, expand: str,
                 n_symbols: int, *, n_real_lanes: int | None = None,
                 entry0: int | torch.Tensor = 0, gather=_one_rank):
    """``seg`` of the body uploaded as ``lanes`` chunks (:func:`_upload_body`,
    let go on return), then the fixed point (``device_fsm8_decode``) of the
    fused passes on "onepass", else of the emit passes -> (rows for
    :func:`route_symbols`: the vals, or (xs, states); exits on "onepass",
    else None; unconverged). ``n_real_lanes`` (default ``lanes``),
    ``entry0`` (one-pass only) and ``gather`` as in :func:`_fixed_point`."""
    n_real_lanes = lanes if n_real_lanes is None else n_real_lanes
    cols = _upload_body(seg, lanes, chunk_bytes, device)
    with phase("device_fsm8_decode", n_symbols):
        if expand == "onepass":
            return fsm8_decode_fused(cols, tables.next_state, tables.fused, n_real_lanes,
                                     tables.m, tables.mt, tables.s, packed=tables.m <= 3,
                                     n_valid=seg.size, entry0=entry0, gather=gather)
        xs = cols.t().contiguous()  # [K, lanes]
        next_state = tables if expand == "host" else tables.next_state
        states, unconverged = fsm8_decode(xs, next_state, n_real_lanes, gather)
        return (xs, states), None, unconverged


def route_symbols(rows, tables, expand: str, n_valid: int, n_symbols: int):
    """``rows`` of :func:`route_passes` -> (symbols, lane_tot, w_inv) on
    their device (``device_expand``): :func:`onepass_symbols`, or the
    two-pass expansion into :func:`plane_symbols`; the tensors that
    :func:`fetch_symbols` and :func:`_fetch_async` take. Real bytes are
    those at lane-linear positions < ``n_valid``."""
    with phase("device_expand", n_symbols):
        if expand == "onepass":
            return onepass_symbols(rows, tables.m, tables.m <= 3, n_valid)
        return plane_symbols(expand_rows(*rows, tables), tables.m, n_valid)


@functools.cache
def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of ``device``'s fetches. Ranks of a local mesh on one
    card share it: each queues its wait, its copies and its event in that
    order, so a rank's event may also cover another rank's copies and ends
    no earlier than its own."""
    return torch.cuda.Stream(device)


def _fetch_async(tensors):
    """Start copying ``tensors`` to the host behind the work queued so far,
    without blocking; returns a callable that waits for the copy and gives
    the numpy arrays, whose holder then owns the host buffers alone (the
    callable keeps none). On CUDA a side stream waits on the current one,
    copies into pinned host tensors and records an event, so the copy
    overlaps whatever is queued next; the source tensors are marked as used
    by that stream, so their memory is not reused before the copy ends. CPU
    tensors are already on the host."""
    dev = tensors[0].device
    count("d2h_bytes", sum(t.numel() * t.element_size() for t in tensors))
    host, done = list(tensors), None
    if dev.type == "cuda":
        side = _copy_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        with torch.cuda.stream(side):
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
            done = torch.cuda.Event()
            done.record(side)

    def wait():
        if done is not None:
            done.synchronize()
        arrays = [h.numpy() for h in host]
        host.clear()
        return arrays

    return wait


def decode_body_device_tiled(body: bytes | np.ndarray, table: CodeTable, n_symbols: int, *,
                             device, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                             expand: str = "onepass", tile_lanes: int | None = None) -> np.ndarray:
    """The device decode by the ``expand`` route ("onepass", "split" or
    "fused") -> uint8[n_symbols] (host array). On "onepass" the body's
    lanes run in tiles of ``tile_lanes`` (default TILE_LANES; a test hook,
    not an option), in stream order: each tile's lane 0 enters EXACTLY at
    the previous tile's last exit (a device tensor: the chaining reads
    nothing back), self-sync runs within a tile, and byte positions are
    tile-local, so no int32 wraps at any body size. The two-pass routes run
    as one tile of every lane, up to MAX_UNTILED_BYTES. Per tile: the route
    step, then the fetch of the symbols and the per-lane metadata, which on
    "onepass" overlaps the next tile's upload and passes (depth-2 pipeline)
    and lands in the output (:func:`land_symbols`) before the next tile's
    extraction, so the device and the pinned host memory hold one tile's
    symbols at a time. The host tail runs once over every tile's metadata.
    A tile whose self-sync does not converge sends the whole body to the
    exact serial decoder (:func:`decode_host`)."""
    if n_symbols == 0:
        return np.zeros(0, dtype=np.uint8)
    buf = _body_buf(body)
    lanes = max(1, -(-buf.size // chunk_bytes))
    tiled = expand == "onepass"
    if not tiled and lanes * chunk_bytes > MAX_UNTILED_BYTES:
        raise NotImplementedError(f"{buf.size} B body exceeds the untiled device decode's int32 "
                                  f"positions; expand={expand!r} has no tiled route (only "
                                  "'onepass' streams in tiles)")
    t_lanes = max(1, tile_lanes or TILE_LANES) if tiled else lanes
    _, tables = route_tables(table, device, expand)
    out, filled, metas, pending, entry0 = np.empty(n_symbols, dtype=np.uint8), 0, [], None, 0
    for l0 in range(0, lanes, t_lanes):
        tl = min(t_lanes, lanes - l0)
        seg = buf[l0 * chunk_bytes:(l0 + tl) * chunk_bytes]  # seg.size: the tile's n_valid
        rows, exits, unconverged = route_passes(seg, tl, chunk_bytes, device, tables, expand,
                                                n_symbols, entry0=entry0)
        if unconverged:
            return decode_host(buf, table, n_symbols)
        # this tile's columns left with the passes; the previous tile's
        # symbols leave the device before this tile's extraction
        if pending is not None:
            filled = land_symbols(pending, out, filled, metas)
        symbols = route_symbols(rows, tables, expand, seg.size, n_symbols)
        # a tile's fetch overlaps the next tile's passes; a route of one
        # tile fetches inside ``device_sym_fetch``
        pending, entry0 = (_fetch_async(symbols), exits[-1:]) if tiled else (symbols, 0)
        del rows, symbols
    filled = land_symbols(pending, out, filled, metas)
    host_validate(metas, n_symbols)
    return host_check_bits(out, filled, n_symbols, table, buf.size)


def expand_states(states: np.ndarray, body: np.ndarray, fsm: ByteFsm,
                  n_symbols: int) -> np.ndarray:
    """(per-byte pre-states, body bytes) -> uint8[n_symbols] in stream order.

    The C++ runtime's walk when it is available, else vectorized numpy.
    Raises on invalid transitions, early stream end, and on the exact-bit
    invariant: the n_symbols-th symbol must complete in the body's final
    byte (the stream is neither truncated nor over-long)."""
    n = body.size
    st = np.ascontiguousarray(states.reshape(-1)[:n], dtype=np.uint8)
    res = runtime.fsm8_expand(st, body, fsm.counts, fsm.syms, n_symbols)
    if res is not None:
        out, end_byte = res
    else:
        cnt = fsm.counts[st, body].astype(np.int64)  # [n], -1 invalid
        cum = np.cumsum(np.maximum(cnt, 0))
        done = int(np.searchsorted(cum, n_symbols, side="left"))
        if done >= n or cum[done] < n_symbols:
            raise ValueError(
                f"bitstream ended early: decoded {int(cum[-1]) if n else 0} "
                f"of {n_symbols} symbols"
            )
        if (cnt[: done + 1] < 0).any():
            raise ValueError("invalid bitstream: unreachable trie edge")
        sy = fsm.syms[st[: done + 1], body[: done + 1]]  # [done + 1, 8]
        mask = np.arange(8, dtype=np.int64)[None, :] < cnt[: done + 1, None]
        out = sy[mask][:n_symbols]
        end_byte = done
    _check_end_byte(end_byte, n, n_symbols)
    return out


def decode_body_device(
    body: bytes | np.ndarray,
    table: CodeTable,
    n_symbols: int,
    *,
    device,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> np.ndarray:
    """Decode a packed body with host expansion -> uint8[n_symbols] (host
    array): the emit passes run on ``device``, their states are transposed
    to stream order there and fetched, one byte per body byte, and the host
    runtime walks (state, byte) pairs into symbols (:func:`expand_states`)."""
    if n_symbols == 0:
        return np.zeros(0, dtype=np.uint8)
    buf = _body_buf(body)
    lanes = max(1, -(-buf.size // chunk_bytes))
    fsm, next_state = route_tables(table, device, "host")
    (_, states), _, unconverged = route_passes(buf, lanes, chunk_bytes, device, next_state,
                                               "host", n_symbols)
    if unconverged:
        return decode_host(buf, table, n_symbols)
    with phase("device_state_fetch", buf.size):
        (st,) = fetch(states.t().contiguous().reshape(-1)[: buf.size])
    with phase("host_expand", n_symbols):
        return expand_states(st, buf, fsm, n_symbols)


def check_expand(expand: str) -> None:
    if expand not in EXPAND_MODES:
        raise ValueError(f"unknown expand route {expand!r} (want one of {EXPAND_MODES})")


def decompress_device(et: bytes, *, device, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                      expand: str = "onepass") -> bytes:
    """Complete .et file -> original bytes, decoded chunk-parallel on
    ``device`` through the ``expand`` route (one of EXPAND_MODES)."""
    check_expand(expand)
    with phase("parse_header"):
        hdr = parse_header(et)
        body = et[hdr.body_start:]
    decode = (decode_body_device if expand == "host"
              else functools.partial(decode_body_device_tiled, expand=expand))
    out = decode(body, hdr.table, hdr.body_len, device=device, chunk_bytes=chunk_bytes)
    with phase("join_output"):
        return out.tobytes()
