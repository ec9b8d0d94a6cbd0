"""Single-device compress pipeline: histogram, block pack and plane compaction
on the device; code construction and bit-granular stitch on the host.

Counterpart of ``entreepy_tpu/ops/encode.py``. An input of up to
``tile_blocks`` blocks is uploaded once and shared by the histogram and the
pack; a larger one streams through the device in tiles of that many blocks,
one upload per tile for the histogram and one for the pack, so the device
working set is bounded by the tile. Blocks are independent, so tiling is
exact. Block size and tile width change only device efficiency — the
stitched ``.et`` output is byte-identical for every value (and to the host
codec).
"""

from __future__ import annotations

import numpy as np
import torch

from ..format.etformat import serialize_header
from ..format.huffman import CodeTable, build_code_table
from ..tables import code_tensors, fetch, to_device
from ..trace import phase
from ..utils.stitch import stitch_flat_payload, words_to_bytes
from .bitpack import (
    assemble_plane_payload,
    compact_payload_plane,
    grouped_counts_plane,
    histogram_device,
    plane_cap_g,
)
from .cuda_pack import pack_blocks

DEFAULT_BLOCK_BYTES = 1024
# Blocks per tile of the streaming encode: 32 MB of input at the default
# block size.
TILE_BLOCKS = (32 << 20) // DEFAULT_BLOCK_BYTES


def histogram_on_device(data: torch.Tensor) -> np.ndarray:
    """int64[256] histogram of a uint8 device tensor, fetched to the host."""
    return fetch(histogram_device(data))[0]


def encode_blocks_device(data: torch.Tensor, table: CodeTable,
                         block_bytes: int = DEFAULT_BLOCK_BYTES):
    """Pack ``data`` (uint8 tensor) block-parallel on its device.

    Returns (flat uint32 numpy — every block's compacted words back to back,
    nwords int64[n_blocks] — words per block incl. the final partial one,
    bit_lens int64[n_blocks]), for ``stitch_flat_payload``."""
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
    with phase("sizing_fetch"):
        counts_g = grouped_counts_plane(emitted)
        cap_g = plane_cap_g(int(counts_g.max()), block_bytes)
    with phase("device_compact"):
        plane, counts_gd, bit_lens = compact_payload_plane(
            words, emitted, acc, nbits, cap_g
        )
    with phase("device_fetch"):
        plane_np, counts_np, bit_lens_np = fetch(plane.view(torch.int32), counts_gd, bit_lens)
    with phase("host_assemble"):
        flat, nwords = assemble_plane_payload(plane_np.view(np.uint32), counts_np)
    return flat, nwords, bit_lens_np.astype(np.int64)


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


def encode_tiles(tiles, table: CodeTable, block_bytes: int = DEFAULT_BLOCK_BYTES):
    """:func:`encode_blocks_device` of each device tile, concatenated: each
    tile's flat payload trimmed to its ``nwords.sum()`` words, so the
    stitch's cumsum(nwords) offsets stay aligned across tiles."""
    flats, nwords, bit_lens = zip(*(encode_blocks_device(t, table, block_bytes) for t in tiles))
    with phase("join_tiles"):
        return (np.concatenate([f[: int(nw.sum())] for f, nw in zip(flats, nwords)]),
                np.concatenate(nwords), np.concatenate(bit_lens))


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
    flat, nwords, bit_lens = encode_tiles(one or _uploads(arr, tile_bytes, device),
                                          table, block_bytes)
    with phase("stitch"):
        words, total_bits = stitch_flat_payload(flat, nwords, bit_lens)
    with phase("serialize"):
        return serialize_header(table, arr.size) + words_to_bytes(words, total_bits)
