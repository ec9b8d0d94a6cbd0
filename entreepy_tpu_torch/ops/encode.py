"""Single-device compress pipeline: histogram, block pack, plane compaction
and the bit-granular stitch on the device; the code table and the header on
the host.

Counterpart of ``entreepy_tpu/ops/encode.py``. An input of up to
``tile_blocks`` blocks is uploaded once and shared by the histogram and the
pack; a larger one streams through the device in tiles of that many blocks,
one upload per tile for the histogram and one for the pack, so the device
working set is bounded by the tile. Blocks are independent, so tiling is
exact. Each tile's blocks are stitched on the device (``ops/cuda_stitch``)
into the body's big-endian bytes at the tile's bit offset, and only those
bytes come back, into one host buffer that becomes the ``.et``; a tile that
starts inside a word takes the previous tile's last word along on the device
and ORs it in. Block size and tile width change only device efficiency — the
``.et`` output is byte-identical for every value (and to the host codec).
"""

from __future__ import annotations

import numpy as np
import torch

from ..format.etformat import serialize_header
from ..format.huffman import CodeTable, build_code_table
from ..tables import code_tensors, fetch, fetch_into, to_device
from ..trace import count, phase
from .bitpack import compact_plane_rows, grouped_counts_plane, histogram_device, plane_cap_g
from .cuda_pack import pack_blocks
from .cuda_stitch import stitch_tile

DEFAULT_BLOCK_BYTES = 1024
# Blocks per tile of the streaming encode: 32 MB of input at the default
# block size.
TILE_BLOCKS = (32 << 20) // DEFAULT_BLOCK_BYTES


def histogram_on_device(data: torch.Tensor) -> np.ndarray:
    """int64[256] histogram of a uint8 device tensor, fetched to the host."""
    return fetch(histogram_device(data))[0]


def encode_blocks_device(data: torch.Tensor, table: CodeTable,
                         block_bytes: int = DEFAULT_BLOCK_BYTES, shift: int = 0,
                         carry: torch.Tensor | None = None):
    """Pack ``data`` (uint8 tensor) block-parallel on its device and stitch
    the blocks into one bitstream that starts ``shift`` (0-31) bits into its
    first word, ORed with ``carry`` (uint8[4], the word before, or None).

    Returns (the stream as big-endian bytes, uint8[4 * words] on the
    device, its bit count without the shift)."""
    n = data.numel()
    dev = data.device
    n_blocks = max(1, -(-n // block_bytes))
    with phase("device_pack", n):
        blocks = torch.zeros(n_blocks * block_bytes, dtype=torch.uint8, device=dev)
        blocks[:n] = data
        valid = np.full(n_blocks, block_bytes, dtype=np.int32)
        valid[-1] = n - (n_blocks - 1) * block_bytes
        codes, lengths = code_tensors(table, dev)
        words, emitted, acc, nbits = pack_blocks(
            blocks.reshape(n_blocks, block_bytes), to_device(valid, dev),
            codes, lengths,
        )
        del blocks
    with phase("sizing_fetch"):
        counts_g = grouped_counts_plane(emitted)
        bits = counts_g.sum(dtype=torch.int64) * 32 + nbits.sum(dtype=torch.int64)
        max_g, bits = torch.stack([counts_g.max().long(), bits]).tolist()
        cap_g = plane_cap_g(max_g, block_bytes)
    with phase("device_compact"):
        plane, counts = compact_plane_rows(words, emitted, cap_g)
        del words, emitted  # the stitch's output takes their place, not more
    with phase("device_stitch"):
        stream = stitch_tile(plane, counts, acc, nbits, shift, (shift + bits + 31) >> 5, carry)
        count("device_stitches", 1)
    return stream, bits


def _uploads(arr: np.ndarray, tile_bytes: int, device):
    """``arr`` in slices of ``tile_bytes``, each uploaded to ``device`` as
    it is reached."""
    for off in range(0, max(arr.size, 1), tile_bytes):
        seg = arr[off:off + tile_bytes]
        with phase("input_upload", seg.size):
            tile = to_device(seg, device)
        yield tile


def histogram_tiles(tiles) -> np.ndarray:
    """int64[256] histogram of the device tiles, summed on the host."""
    total = np.zeros(256, dtype=np.int64)
    for t in tiles:
        with phase("device_histogram", t.numel()):
            total += histogram_on_device(t)
    return total


def encode_tiles(tiles, table: CodeTable, body: torch.Tensor,
                 block_bytes: int = DEFAULT_BLOCK_BYTES) -> int:
    """:func:`encode_blocks_device` of each device tile, its bytes fetched
    into ``body`` (uint8 on the host) at its bit offset; returns the bits
    written. Where a tile ends inside a byte, the next tile's first byte is
    fetched again, with both tiles' bits: the previous tile's last word goes
    along on the device as the next one's ``carry``."""
    at, carry = 0, None
    for tile in tiles:
        shift = at & 31
        stream, bits = encode_blocks_device(tile, table, block_bytes, shift, carry)
        end = at + bits
        with phase("device_fetch"):
            fetch_into(body[at >> 3:(end + 7) >> 3], stream[shift >> 3:(shift + bits + 7) >> 3])
        carry = stream[-4:].clone() if end & 31 else None
        del stream  # before the next tile's pack
        at = end
    return at


def compress_device(data: bytes, *, device, strict: bool = True,
                    block_bytes: int = DEFAULT_BLOCK_BYTES,
                    tile_blocks: int | None = None) -> bytes:
    """bytes -> complete .et file, byte-identical to the host codec's. Inputs
    past ``tile_blocks`` blocks (default TILE_BLOCKS; a test hook, not an
    option) stream in tiles."""
    arr = np.frombuffer(data, dtype=np.uint8)
    tile_bytes = max(1, tile_blocks or TILE_BLOCKS) * block_bytes
    # one tile: a single upload shared by both passes
    one = list(_uploads(arr, tile_bytes, device)) if arr.size <= tile_bytes else None
    counts = histogram_tiles(one or _uploads(arr, tile_bytes, device))
    with phase("code_table"):
        table = build_code_table(counts, strict=strict)
    total_bits = table.encoded_body_bits(counts)
    with phase("join_tiles"):
        # the one buffer every tile's bytes land in; pinned on a card
        body = torch.empty((total_bits + 7) // 8, dtype=torch.uint8,
                           pin_memory=torch.device(device).type == "cuda")
    got = encode_tiles(one or _uploads(arr, tile_bytes, device), table, body, block_bytes)
    if got != total_bits:
        raise ValueError(f"the device packed {got} bits, the histogram says {total_bits}")
    with phase("serialize"):
        return b"".join((serialize_header(table, arr.size), body.numpy()))
