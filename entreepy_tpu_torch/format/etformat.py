""".et wire format — serialization and parsing (host side, numpy bit-ops).

Layout (normative; reference: ``encode.zig:260-319``, ``README.md:57-73``;
big-endian bit order throughout):

::

    magic              3 bytes   e7 c0 de
    format version     1 byte    0x01
    dict count - 1     1 byte
    body length        4 bytes   u32 BE = ORIGINAL (uncompressed) byte count
    dictionary, bit-packed with no alignment between entries, symbols in
    ascending byte order:
      symbol           8 bits
      code length      8 bits
      code             <length> bits, MSB first
    <zero-pad to byte boundary>
    body: concatenated codes, MSB first, zero-padded to the final byte

The reference CLI strips magic+version unvalidated before decode
(``main.zig:199-204`` — its own TODO). We validate them (and the header
length) and raise ``FormatError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .huffman import ALPHABET, CodeTable, code_table_from_entries

MAGIC = b"\xe7\xc0\xde"
VERSION = 0x01
HEADER_BYTES = 9  # magic(3) + version(1) + dictcount(1) + bodylen(4)


class FormatError(ValueError):
    """Input is not a valid .et file."""


@dataclass(frozen=True)
class EtHeader:
    """Parsed .et header + dictionary."""

    table: CodeTable
    num_symbols: int  # distinct symbols in the dictionary
    body_len: int  # ORIGINAL byte count (symbols to decode)
    body_start: int  # byte offset of the packed body within the file
    version: int = 1  # parsed format version byte


def dict_bits(table: CodeTable) -> int:
    """Exact bit length of the packed dictionary section."""
    present = table.lengths > 0
    return int((16 + table.lengths[present].astype(np.int64)).sum())


def serialize_header(table: CodeTable, body_len: int) -> bytes:
    """Serialize magic..dictionary (padded to a byte boundary).

    Byte-identical to the reference's bit writer output
    (``encode.zig:260-299``).
    """
    n = table.num_symbols
    if n < 1:
        raise FormatError("cannot serialize an empty dictionary")
    if body_len >= 1 << 32:
        raise FormatError("body length exceeds the format's u32 field")

    head = bytearray()
    head += MAGIC
    head.append(VERSION)
    head.append(n - 1)
    head += int(body_len).to_bytes(4, "big")

    # Dictionary: build a flat bit vector then pack MSB-first.
    nbits = dict_bits(table)
    bits = np.zeros(nbits, dtype=np.uint8)
    pos = 0
    for sym in range(ALPHABET):
        length = int(table.lengths[sym])
        if length == 0:
            continue
        for val, width in ((sym, 8), (length, 8), (int(table.codes[sym]), length)):
            shifts = np.arange(width - 1, -1, -1)
            bits[pos : pos + width] = (val >> shifts) & 1
            pos += width
    head += np.packbits(bits).tobytes()  # packbits zero-pads the final byte
    return bytes(head)


def serialize(table: CodeTable, body: bytes, body_len: int) -> bytes:
    """Full .et file from a code table, packed body bytes, and original length."""
    return serialize_header(table, body_len) + body


def parse_header(data) -> EtHeader:
    """Parse and validate a full .et file's header + dictionary."""
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    if buf.size < HEADER_BYTES + 1:
        raise FormatError(f"file too short ({buf.size} B) to be a .et file")
    if buf[:3].tobytes() != MAGIC:
        raise FormatError(f"bad magic {buf[:3].tobytes().hex()} (want {MAGIC.hex()})")
    if buf[3] != VERSION:
        raise FormatError(f"unsupported format version {int(buf[3])}")

    num_symbols = int(buf[4]) + 1
    body_len = int.from_bytes(buf[5:9].tobytes(), "big")

    # Bit-parse the dictionary. Worst case it spans 256*(16+32) bits = 1536 B.
    # One big int + shifts: ~5x faster than per-field numpy bit slicing.
    max_dict_bytes = min(buf.size - HEADER_BYTES, (num_symbols * (16 + 32) + 7) // 8)
    dict_int = int.from_bytes(buf[HEADER_BYTES : HEADER_BYTES + max_dict_bytes].tobytes(), "big")
    nbits = max_dict_bytes * 8
    entries = []
    pos = 0
    for _ in range(num_symbols):
        if pos + 16 > nbits:
            raise FormatError("truncated dictionary")
        head = (dict_int >> (nbits - pos - 16)) & 0xFFFF
        sym, length = head >> 8, head & 0xFF
        pos += 16
        if length == 0 or length > 32:
            raise FormatError(f"invalid code length {length} for symbol {sym}")
        if pos + length > nbits:
            raise FormatError("truncated dictionary")
        code = (dict_int >> (nbits - pos - length)) & ((1 << length) - 1)
        pos += length
        entries.append((sym, length, code))

    body_start = HEADER_BYTES + (pos + 7) // 8  # dict padded to byte boundary
    if len({(sym) for sym, _, _ in entries}) != num_symbols:
        raise FormatError("duplicate symbol in dictionary")
    return EtHeader(
        table=code_table_from_entries(entries),
        num_symbols=num_symbols,
        body_len=body_len,
        body_start=body_start,
        version=int(buf[3]),
    )
