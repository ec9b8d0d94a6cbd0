"""The encode's stitch: CUDA kernel on the card, plain PyTorch on the CPU.

Replaces no TPU kernel: the JAX package stitches the encode's blocks on the
host (``utils/stitch.py`` here, which the sharded encode still uses). The
kernel is ``csrc/stitch.cu``, whose header says what bounds it and how it is
laid out. Caller: the single-device encode (``ops/encode.encode_blocks_device``),
once per tile. It takes the compaction kernel's k-major plane as
``compact_rows`` returns it, with the pack's final partial words, and writes
the tile's part of the ``.et`` body as big-endian bytes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_M32 = 0xFFFFFFFF


@functools.cache
def _stitch_fn():
    return _build.entry("et_stitch_tile", [_P] * 5 + [_I, _I, _I, _P, _P, _P])


def lane_offsets(counts: torch.Tensor, nbits: torch.Tensor, shift: int) -> torch.Tensor:
    """Each block's bit offset in the tile's stream, int64[lanes]: the
    exclusive scan of the blocks' bit lengths (32 per live word, plus the
    partial word's ``nbits``) after ``shift`` bits."""
    bits = counts.sum(0, dtype=torch.int64) * 32 + nbits.long()
    return bits.cumsum(0) - bits + shift


def _check(plane, counts, acc, nbits, shift, n_words, carry) -> int:
    rows, lanes = plane.shape if plane.dim() == 2 else (0, 0)
    g = counts.shape[0] if counts.dim() == 2 else 0
    if lanes == 0 or g == 0 or rows % g or counts.shape[1] != lanes \
            or acc.shape != (lanes,) or nbits.shape != (lanes,) or not 0 <= shift < 32 \
            or n_words < 0 or (carry is not None and carry.shape != (4,)):
        raise ValueError(
            f"stitch_tile: plane {tuple(plane.shape)}, counts {tuple(counts.shape)}, acc "
            f"{tuple(acc.shape)}, nbits {tuple(nbits.shape)}, shift {shift}, n_words {n_words}")
    return rows // g


def stitch_tile_plain(plane: torch.Tensor, counts: torch.Tensor, acc: torch.Tensor,
                      nbits: torch.Tensor, shift: int, n_words: int,
                      carry: torch.Tensor | None = None) -> torch.Tensor:
    """The tile's stream as big-endian bytes, uint8[4 * n_words].

    plane int32[G*cap, lanes] (the compaction's k-major plane: row g*cap + j
    of lane l is block l's j-th word of subgroup g, live while j <
    ``counts[g, l]``), counts int32[G, lanes], acc uint32[lanes] (each
    block's final partial word, MSB-aligned), nbits int32[lanes] (its bits).
    Block l's words start at bit :func:`lane_offsets` of the stream; its
    bits past ``nbits`` in ``acc`` are ignored. ``carry`` uint8[4], when
    given, is ORed into the first word: the previous tile's last word, where
    this one starts inside it. Each word is added into the two int64 words
    it reaches (``index_add_``): the blocks' bits never overlap, so the sum
    is the OR the kernel computes."""
    cap = _check(plane, counts, acc, nbits, shift, n_words, carry)
    rows, lanes = plane.shape
    dev = plane.device
    live = (torch.arange(cap, device=dev)[None, :, None] < counts[:, None, :]).reshape(rows, lanes)
    offs = lane_offsets(counts, nbits, shift)
    k = live.long().cumsum(0) - 1  # each live word's place in its block's stream
    nb = nbits.long()
    tail = torch.where(nb > 0, acc.view(torch.int32).long() & (_M32 << (32 - nb)) & _M32, 0)
    pos = torch.cat([(offs[None, :] + 32 * k)[live], offs + 32 * counts.sum(0, dtype=torch.int64)])
    w = torch.cat([plane.view(torch.int32).long()[live] & _M32, tail])
    s = pos & 31
    words = torch.zeros(n_words + 2, dtype=torch.int64, device=dev)
    words.index_add_(0, pos >> 5, w >> s)
    words.index_add_(0, (pos >> 5) + 1, torch.where(s > 0, (w << (32 - s)) & _M32, 0))
    shifts = torch.tensor([24, 16, 8, 0], device=dev)
    out = ((words[:n_words, None] >> shifts) & 255).to(torch.uint8).reshape(-1)
    if carry is not None:
        out[:4] |= carry
    return out


@_build.counted
def stitch_tile(plane: torch.Tensor, counts: torch.Tensor, acc: torch.Tensor,
                nbits: torch.Tensor, shift: int, n_words: int,
                carry: torch.Tensor | None = None) -> torch.Tensor:
    """The stitch kernel (replaces no TPU kernel); see
    :func:`stitch_tile_plain`."""
    if plane.device.type == "cpu":
        return stitch_tile_plain(plane, counts, acc, nbits, shift, n_words, carry)
    cap = _check(plane, counts, acc, nbits, shift, n_words, carry)
    rows, lanes = plane.shape
    dev = plane.device
    _build.require(plane, torch.int32, "plane")
    _build.require(counts, torch.int32, "counts", dev)
    _build.require(acc, torch.uint32, "acc", dev)
    _build.require(nbits, torch.int32, "nbits", dev)
    if carry is not None:
        _build.require(carry, torch.uint8, "carry", dev)
    offs = lane_offsets(counts, nbits, shift)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    out.zero_()
    if n_words:
        with torch.cuda.device(dev):
            rc = _stitch_fn()(
                plane.data_ptr(), counts.data_ptr(), acc.data_ptr(), nbits.data_ptr(),
                offs.data_ptr(), rows, lanes, cap,
                None if carry is None else carry.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(rc, "et_stitch_tile")
        _build.count_launch(stitch_tile, dev)
    return out.view(torch.uint8)
