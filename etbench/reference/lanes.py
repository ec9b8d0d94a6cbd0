"""Each lane's symbols, and each rank's share of them, from a serial decode
of an ``.et`` file: the plain reference of the sharded decode's partition.

The chunk-parallel decode cuts the body into chunks of ``chunk_bytes``
(lanes) and counts, per lane, the symbols whose code ends in it (the byte
that completes a code emits its symbol). The sharded backend pads the lanes
to a multiple of the world W, and rank r owns lanes ``[r*L, (r+1)*L)`` with
``L = ceil(lanes / W)``; the padding lanes, at the end, hold no symbol.

Here the body is decoded serially through the code lengths alone, with no
automaton and no chunk self-synchronisation: the length of the code that
starts at every bit position is read from a table of the codes, and the
symbol starts are the chain 0, then each start plus its code's length,
walked one step after another (2^STRIDE_LOG codes a step, then every start
between), which gives exactly the serial walk's positions. As that walk does, it decodes every complete code
of the body's bytes, the zero padding of the last byte included, and stops
where a code no longer fits (or no code matches). Plain NumPy on the host,
as the rest of the reference, with no threads; it imports nothing of the
program and no framework.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .etformat import parse_table

# The code lookup is one table over every ``max_len``-bit window.
MAX_TABLE_BITS = 28
# The walk's long steps cover 2^STRIDE_LOG codes each.
STRIDE_LOG = 8
# Bytes read for the window at each byte: 56 bits, for a code of up to 49
# bits at any of a byte's 8 bit offsets (the format's codes have up to 32).
_WINDOW_BYTES = 7


@dataclass
class Lanes:
    """The serial decode of one body, laid over lanes."""

    lane_tot: np.ndarray  # int64[lanes]: symbols whose code ends in each lane
    symbols: np.ndarray  # uint8: every decoded symbol in stream order
    n_symbols: int  # the header's original length
    chunk_bytes: int

    def ranks(self, world: int) -> list[tuple[range, np.ndarray, np.ndarray]]:
        """Per rank of a mesh of ``world``: (its lanes, its lane_tot over
        them, padding lanes 0, and its symbols in stream order)."""
        lanes = self.lane_tot.size
        per = -(-lanes // world)
        tot = np.zeros(per * world, dtype=np.int64)
        tot[:lanes] = self.lane_tot
        ends = np.concatenate([[0], np.cumsum(tot)])
        return [(range(r * per, (r + 1) * per), tot[r * per:(r + 1) * per],
                 self.symbols[ends[r * per]:ends[(r + 1) * per]]) for r in range(world)]


def _code_lookup(codes: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """(length uint8, symbol uint8) of the code that starts each
    ``max_len``-bit window (length 0: none does), and ``max_len``."""
    max_len = int(lengths.max())
    if max_len > MAX_TABLE_BITS:
        raise ValueError(f"codes of {max_len} bits: the lookup keeps windows of at most "
                         f"{MAX_TABLE_BITS}")
    length = np.zeros(1 << max_len, dtype=np.uint8)
    symbol = np.zeros(1 << max_len, dtype=np.uint8)
    for s in np.flatnonzero(lengths):
        n = int(lengths[s])
        lo = int(codes[s]) << (max_len - n)
        hi = lo + (1 << (max_len - n))
        if length[lo:hi].any():
            raise ValueError("the codes are not a prefix code")
        length[lo:hi], symbol[lo:hi] = n, s
    return length, symbol, max_len


def _windows(body: np.ndarray, max_len: int) -> np.ndarray:
    """int64[8 * bytes]: the ``max_len`` bits from every bit position of
    ``body`` on, zero past its end."""
    n = body.size
    padded = np.concatenate([body, np.zeros(_WINDOW_BYTES, dtype=np.uint8)]).astype(np.int64)
    word = np.zeros(n, dtype=np.int64)
    for i in range(_WINDOW_BYTES):
        word = (word << 8) | padded[i:i + n]
    shifts = 8 * _WINDOW_BYTES - max_len - np.arange(8, dtype=np.int64)
    return ((word[:, None] >> shifts[None, :]) & ((1 << max_len) - 1)).reshape(-1)


def _walk(jump: np.ndarray, n_bits: int) -> np.ndarray:
    """The serial walk's starts from bit 0 (0, jump[0], jump[jump[0]], ...)
    below ``n_bits``, in order: first 2^STRIDE_LOG codes at a time, one
    step after another, then every start between two of those."""
    stride = jump
    for _ in range(STRIDE_LOG):
        stride = stride[stride]
    coarse = [0]
    while coarse[-1] < n_bits:
        coarse.append(int(stride[coarse[-1]]))
    rows = np.empty((len(coarse), 1 << STRIDE_LOG), dtype=jump.dtype)
    at = np.array(coarse, dtype=jump.dtype)
    for j in range(1 << STRIDE_LOG):
        rows[:, j] = at
        at = jump[at]
    flat = rows.reshape(-1)
    return flat[flat < n_bits]


def symbol_starts(body, codes: np.ndarray, lengths: np.ndarray):
    """The serial decode of ``body`` -> (start bit of every complete code,
    int64; its length, int64; its symbol, uint8), in stream order."""
    raw = np.frombuffer(body, dtype=np.uint8)
    n_bits = 8 * raw.size
    if n_bits == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.uint8)
    length_of, symbol_of, max_len = _code_lookup(codes, lengths)
    win = _windows(raw, max_len)
    idx = np.int32 if n_bits + max_len < np.iinfo(np.int32).max else np.int64
    length = length_of[win].astype(idx)
    nxt = np.arange(n_bits, dtype=idx) + length
    fits = (length > 0) & (nxt <= n_bits)
    # the next start after each position; n_bits once the walk has ended
    nxt[~fits] = n_bits
    starts = _walk(np.append(nxt, idx(n_bits)), n_bits)
    starts = starts[fits[starts]].astype(np.int64)  # the last start may hold an incomplete code
    return starts, length[starts].astype(np.int64), symbol_of[win[starts]]


def decode_lanes(et: bytes, chunk_bytes: int = 512) -> Lanes:
    """An ``.et`` file -> its serial decode over lanes of ``chunk_bytes``."""
    table, n_orig, body_at = parse_table(et)
    body = np.frombuffer(et, dtype=np.uint8)[body_at:]
    lanes = max(1, -(-body.size // chunk_bytes))
    starts, length, symbol = symbol_starts(body, table.codes, table.lengths)
    end_lane = (starts + length - 1) // (8 * chunk_bytes)
    lane_tot = np.bincount(end_lane, minlength=lanes).astype(np.int64)
    return Lanes(lane_tot, symbol, n_orig, chunk_bytes)
