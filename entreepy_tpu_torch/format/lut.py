"""Dense multi-level decode LUT — the fixed-shape replacement for the
reference's ``AutoHashMap(code_int, [32]u8)`` decode map (``decode.zig:47-52``).

The reference probes every code length per symbol with a hash lookup
(``decode.zig:166-200``). On TPU we need O(1) fixed-shape gathers instead: a
table indexed directly by the next ``lookup_bits`` bits of the stream resolves
any prefix code in one gather per level (one level suffices whenever
``max_code_len <= lookup_bits``; rare longer codes descend into child tables).

Entry encoding, int32:

* ``0``         — invalid index (no code has this prefix; corrupt stream)
* ``> 0``       — terminal: ``(total_code_length << 8) | symbol``
* ``< 0``       — escape: ``-child_table_id`` (child ids start at 1)

All levels share one flat array ``flat[table_id * 2**lookup_bits + idx]`` so a
device kernel can walk levels with plain gathers. Unlike the reference's map,
this design has no NUL-byte ambiguity (the reference cannot represent symbol
0x00 — ``decode.zig:182`` treats it as an empty slot; see SURVEY.md §2 #7c).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .huffman import CodeTable

DEFAULT_LOOKUP_BITS = 12


@dataclass(frozen=True)
class DecodeLut:
    flat: np.ndarray  # int32[num_tables * 2**lookup_bits]
    lookup_bits: int
    num_tables: int
    max_len: int
    min_len: int

    @property
    def fanout(self) -> int:
        return 1 << self.lookup_bits


def build_decode_lut(table: CodeTable, lookup_bits: int | None = None) -> DecodeLut:
    max_len = table.max_len
    min_len = table.min_len
    if max_len == 0:
        raise ValueError("empty code table")
    lb = lookup_bits if lookup_bits is not None else min(max(max_len, 1), DEFAULT_LOOKUP_BITS)
    fanout = 1 << lb

    tables = [np.zeros(fanout, dtype=np.int32)]
    children: dict[tuple[int, int], int] = {}

    present = np.flatnonzero(table.lengths > 0)
    for sym in present.tolist():
        length = int(table.lengths[sym])
        code = int(table.codes[sym])
        tid, level = 0, 0
        while True:
            end = min((level + 1) * lb, length)
            width = end - level * lb
            part = (code >> (length - end)) & ((1 << width) - 1)
            if end == length:  # terminal at this level
                lo = part << (lb - width)
                tables[tid][lo : lo + (1 << (lb - width))] = (length << 8) | sym
                break
            key = (tid, part)
            if key not in children:
                tables.append(np.zeros(fanout, dtype=np.int32))
                children[key] = len(tables) - 1
                tables[tid][part] = -children[key]
            tid = children[key]
            level += 1

    return DecodeLut(
        flat=np.concatenate(tables),
        lookup_bits=lb,
        num_tables=len(tables),
        max_len=max_len,
        min_len=min_len,
    )


def lut_lookup_host(lut: DecodeLut, window: int) -> tuple[int, int]:
    """Resolve one symbol from a >= max_len-bit window (MSB-aligned at bit 31).

    Returns (symbol, code_length). Host-side scalar version, mirrors what the
    device kernels do with gathers. ``window`` is a uint32 whose top bits are
    the next bits of the stream.
    """
    lb = lut.lookup_bits
    tid = 0
    for level in range(8):  # 32 / lookup_bits <= 8 levels for lb >= 4
        idx = (window >> (32 - (level + 1) * lb)) & ((1 << lb) - 1) if (level + 1) * lb <= 32 else 0
        entry = int(lut.flat[tid * lut.fanout + idx])
        if entry > 0:
            return entry & 0xFF, entry >> 8
        if entry == 0:
            raise ValueError("invalid bitstream: no code matches window")
        tid = -entry
    raise ValueError("LUT walk exceeded max depth")
