"""Block bit-packer: CUDA kernel on the card, plain PyTorch on the CPU.

Counterpart of ``entreepy_tpu/ops/pallas_pack.py``; the kernel is in
``csrc/pack.cu``. :func:`pack_blocks` keeps the contract of
``entreepy_tpu.ops.bitpack.pack_blocks_scan``. Both versions write their
per-step outputs k-major (``[steps, lanes]``, what the compaction reads) and
return ``[lanes, steps]`` transposed views of them.
:func:`pack_blocks_scan_plain` is the kernel's decomposition (prefix sums of
the code lengths instead of a serial accumulator) in plain PyTorch.
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
def _pack_fn():
    return _build.entry("et_pack_blocks", [_P] * 8 + [_I, _I, _P])


def pack_blocks_plain(blocks: torch.Tensor, valid: torch.Tensor,
                      codes: torch.Tensor, lengths: torch.Tensor):
    """Pack every block independently (``pack_blocks_scan``'s arithmetic:
    the 64-bit accumulator as two 32-bit halves held in int64).

    blocks uint8[lanes, steps] zero-padded, valid int32[lanes] real bytes per
    block, codes uint32[256], lengths uint8[256]. Returns (words
    uint32[lanes, steps] — the accumulator's high word after every step,
    emitted bool[lanes, steps], acc uint32[lanes] — final partial word
    MSB-aligned, nbits int32[lanes] — bits held in acc)."""
    lanes, steps = blocks.shape
    dev = blocks.device
    code_t = codes.long() & _M32
    len_t = lengths.long()
    valid_l = valid.long()
    hi = torch.zeros(lanes, dtype=torch.int64, device=dev)
    lo = torch.zeros_like(hi)
    nbits = torch.zeros_like(hi)
    words = torch.empty((steps, lanes), dtype=torch.int32, device=dev)
    emitted = torch.empty((steps, lanes), dtype=torch.bool, device=dev)
    for j, x in enumerate(blocks.t().long()):
        live = j < valid_l
        length = torch.where(live, len_t[x], 0)
        code = torch.where(live, code_t[x], 0)
        s = nbits + length  # <= 63
        fits = s <= 32
        hi = hi | torch.where(
            fits, (code << (32 - s).clamp(0, 31)) & _M32, code >> (s - 32).clamp(0, 31)
        )
        lo = lo | torch.where(fits, 0, (code << (64 - s).clamp(0, 31)) & _M32)
        emit = s >= 32
        words[j] = hi.int()
        emitted[j] = emit
        hi = torch.where(emit, lo, hi)
        lo = torch.where(emit, 0, lo)
        nbits = torch.where(emit, s - 32, s)
    return (words.view(torch.uint32).t(), emitted.t(),
            hi.int().view(torch.uint32), nbits.int())


def pack_blocks_scan_plain(blocks: torch.Tensor, valid: torch.Tensor,
                           codes: torch.Tensor, lengths: torch.Tensor):
    """:func:`pack_blocks_plain`'s function in the kernel's decomposition:
    the bit offset of each step is an exclusive prefix sum of the live code
    lengths, step j emits where ``(off_j & 31) + len_j >= 32``, and the word
    it emits is stream word ``off_j >> 5`` of the block. The stream words
    are built by adding every code's bits into the word(s) it lands in (the
    bit ranges are disjoint, so the sum is the OR). Same arguments and
    results; ``words`` holds stream word ``off_j >> 5`` at every step, dead
    where nothing is emitted."""
    lanes, steps = blocks.shape
    dev = blocks.device
    x = blocks.long()
    live = torch.arange(steps, device=dev)[None, :] < valid.long()[:, None]
    length = torch.where(live, lengths.long()[x], 0)
    off = length.cumsum(1) - length
    total = length.sum(1)
    emitted = (off & 31) + length >= 32
    # each code MSB-aligned in 32 bits, then split over its word and the next
    aligned = torch.where(length > 0, ((codes.long() & _M32)[x] << (32 - length)) & _M32, 0)
    nb = off & 31
    idx = off >> 5
    base = torch.arange(lanes, device=dev)[:, None] * (steps + 1)
    sword = torch.zeros(lanes * (steps + 1), dtype=torch.int64, device=dev)
    sword.index_add_(0, (base + idx).reshape(-1), (aligned >> nb).reshape(-1))
    sword.index_add_(0, (base + idx + 1).reshape(-1), ((aligned << (32 - nb)) & _M32).reshape(-1))
    sword = sword.reshape(lanes, steps + 1)
    words = sword.gather(1, idx).int().view(torch.uint32)
    acc = sword.gather(1, (total >> 5)[:, None])[:, 0].int().view(torch.uint32)
    return words, emitted, acc, (total & 31).int()


@_build.counted
def pack_blocks(blocks: torch.Tensor, valid: torch.Tensor, codes: torch.Tensor,
                lengths: torch.Tensor):
    """Kernel 3 (replaces ``pack_blocks_pallas``); see
    :func:`pack_blocks_plain`. The kernel computes it as
    :func:`pack_blocks_scan_plain` does; words at steps that emit nothing
    are unspecified."""
    if blocks.device.type == "cpu":
        return pack_blocks_plain(blocks, valid, codes, lengths)
    lanes, steps = blocks.shape
    dev = blocks.device
    _build.require(blocks, torch.uint8, "blocks")
    _build.require(valid, torch.int32, "valid", dev)
    _build.require(codes, torch.uint32, "codes", dev)
    _build.require(lengths, torch.uint8, "lengths", dev)
    if lanes == 0 or valid.numel() != lanes or codes.numel() != 256 \
            or lengths.numel() != 256:
        raise ValueError("pack_blocks: empty blocks or a bad code table")
    words = torch.empty((steps, lanes), dtype=torch.uint32, device=dev)
    emitted = torch.empty((steps, lanes), dtype=torch.bool, device=dev)
    acc = torch.empty(lanes, dtype=torch.uint32, device=dev)
    nbits = torch.empty(lanes, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _pack_fn()(
            blocks.data_ptr(), valid.data_ptr(), codes.data_ptr(),
            lengths.data_ptr(), words.data_ptr(), emitted.data_ptr(),
            acc.data_ptr(), nbits.data_ptr(), lanes, steps,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "et_pack_blocks")
    _build.count_launch(pack_blocks, words.device)
    return words.t(), emitted.t(), acc, nbits
