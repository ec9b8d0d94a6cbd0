"""Host-side .et format layer of the port (its own copy of
``entreepy_tpu.format``): deterministic code construction, wire format,
decode LUTs and FSM tables, and the exact host codec the device paths are
verified against."""

from .etformat import EtHeader, FormatError, parse_header, serialize, serialize_header
from .hostcodec import compress_host, decompress_host, pack_body_host, unpack_body_host
from .huffman import (
    ALPHABET,
    MAX_CODE_LEN,
    CodeOverflowError,
    CodeTable,
    DegenerateInputError,
    build_code_table,
    code_table_from_entries,
    histogram,
    sorted_symbols,
)
from .lut import DecodeLut, build_decode_lut

__all__ = [
    "ALPHABET",
    "MAX_CODE_LEN",
    "CodeOverflowError",
    "CodeTable",
    "DecodeLut",
    "DegenerateInputError",
    "EtHeader",
    "FormatError",
    "build_code_table",
    "build_decode_lut",
    "code_table_from_entries",
    "compress_host",
    "decompress_host",
    "histogram",
    "pack_body_host",
    "parse_header",
    "serialize",
    "serialize_header",
    "sorted_symbols",
    "unpack_body_host",
]
