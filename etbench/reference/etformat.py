"""The ``.et`` header and dictionary, written as the upstream tool writes them.

magic ``e7 c0 de``, version ``01``, dictionary count - 1 (one byte), the
original length (u32, big-endian), then for every present byte in ascending
order its value (8 bits), its code length (8 bits) and its code (MSB first),
bit-packed with no alignment, zero-padded to a byte. The body follows.
"""

from __future__ import annotations

import numpy as np

from .huffman import ALPHABET, CodeTable

MAGIC = b"\xe7\xc0\xde"
VERSION = 0x01
HEADER_BYTES = 9


def serialize_header(table: CodeTable, body_len: int) -> bytes:
    """Header and dictionary of a file whose original is ``body_len`` bytes."""
    present = [s for s in range(ALPHABET) if table.lengths[s]]
    if body_len >= 1 << 32:
        raise ValueError("original length past the format's u32 field")
    bits = []
    for s in present:
        n = int(table.lengths[s])
        bits.append(format(s, "08b") + format(n, "08b") + format(int(table.codes[s]), f"0{n}b"))
    flat = np.frombuffer("".join(bits).encode(), dtype=np.uint8) - ord("0")
    return (MAGIC + bytes([VERSION, len(present) - 1]) + int(body_len).to_bytes(4, "big")
            + np.packbits(flat).tobytes())


def parse_table(et: bytes) -> tuple[CodeTable, int, int]:
    """(code table, original length, body offset) of a complete file."""
    if et[:3] != MAGIC or et[3] != VERSION:
        raise ValueError("not a .et file")
    count = et[4] + 1
    n_orig = int.from_bytes(et[5:9], "big")
    head = np.unpackbits(np.frombuffer(et, dtype=np.uint8, count=min(len(et), 9 + 1536))[9:])
    codes = np.zeros(ALPHABET, dtype=np.uint32)
    lengths = np.zeros(ALPHABET, dtype=np.uint8)
    pos = 0
    for _ in range(count):
        sym = int(np.packbits(head[pos:pos + 8])[0])
        n = int(np.packbits(head[pos + 8:pos + 16])[0])
        code = int("".join(map(str, head[pos + 16:pos + 16 + n])), 2)
        codes[sym], lengths[sym] = code, n
        pos += 16 + n
    return CodeTable(codes, lengths), n_orig, HEADER_BYTES + (pos + 7) // 8
