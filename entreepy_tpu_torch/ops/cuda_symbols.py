"""Stream-order symbol extraction: CUDA kernel on the card, plain PyTorch on the CPU.

Replaces no TPU kernel: the JAX package selects a decode's live symbol slots
on the host. The kernel is ``csrc/symbols.cu``, whose header says what bounds
it and how it is laid out. Caller: ``ops/decode8`` (:func:`decode8.packed_symbols`,
:func:`decode8.plane_symbols`) on every device decode route, the sharded
decode's among them. Two forms of one walk: the fused pass's MASKED packed
words int32[K, lanes] (m <= 3), and the compaction kernel's subgroup plane
uint8[Gs*cap, lanes] with its totals ``mini_tot`` int32[Gs, lanes]. Each
lane's symbols land at the lane's offset, lane after lane: the stream order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
NO_INVALID = 1 << 30  # w_inv of a lane without an invalid transition


@functools.cache
def _counts_fn():
    return _build.entry("et_symbol_counts", [_P, _I, _I, _I, _P, _P, _P])


@functools.cache
def _write_fn():
    return _build.entry("et_symbol_write", [_P, _P, _I, _I, _I, _I, _P, _P, _P])


def packed_counts_inv(words: torch.Tensor, m: int):
    """counts int32[K, lanes] and inv bool[K, lanes] straight off MASKED
    packed words (``word >> 8m`` is 0 on padding, 16 on an invalid
    transition, else the symbol count)."""
    raw = words >> (8 * m)  # words are < 2^29, so this shift is logical
    return raw & 15, raw >= 16


def _masked_meta(counts: torch.Tensor, inv: torch.Tensor):
    """Per-lane (lane_tot, w_inv) from per-byte counts/inv: w_inv = symbols
    emitted before the lane's first invalid byte, NO_INVALID when none."""
    cums = counts.cumsum(0, dtype=torch.int32) - counts
    w_inv = torch.where(inv, cums, NO_INVALID).amin(0)
    return counts.sum(0, dtype=torch.int32), w_inv


def compact_symbols_dense(words: torch.Tensor, m: int):
    """MASKED packed words -> the dense symbol plane: row ``k*m + j`` is byte
    ``m-1-j`` of word ``k`` verbatim; dead slots carry table leftovers and
    every consumer gates on the per-byte count. Returns (plane
    uint8[K*m, lanes], mini_tot int32[K, lanes], lane_tot int32[lanes],
    w_inv int32[lanes])."""
    k, lanes = words.shape
    counts, inv = packed_counts_inv(words, m)
    shifts = torch.arange(8 * (m - 1), -1, -8, dtype=torch.int32, device=words.device)
    plane = ((words[:, None, :] >> shifts[None, :, None]) & 255).to(torch.uint8)
    lane_tot, w_inv = _masked_meta(counts, inv)
    return plane.reshape(k * m, lanes), counts, lane_tot, w_inv


def _check_words(words: torch.Tensor, m: int) -> None:
    if words.dim() != 2 or words.shape[1] == 0 or not 1 <= m <= 3:
        raise ValueError(f"packed words {tuple(words.shape)} with m={m}: want int32[K, lanes>0], "
                         "1 <= m <= 3")


def symbol_counts_plain(words: torch.Tensor, m: int):
    """MASKED packed words int32[K, lanes] -> (lane_tot int32[lanes], each
    lane's symbols; w_inv int32[lanes], its symbols before its first invalid
    word, NO_INVALID when none)."""
    _check_words(words, m)
    return _masked_meta(*packed_counts_inv(words, m))


@_build.counted
def symbol_counts(words: torch.Tensor, m: int):
    """The symbols kernel's count launch (packed form; replaces no TPU
    kernel); see :func:`symbol_counts_plain`."""
    if words.device.type == "cpu":
        return symbol_counts_plain(words, m)
    _check_words(words, m)
    _build.require(words, torch.int32, "words")
    k, lanes = words.shape
    lane_tot = torch.empty(lanes, dtype=torch.int32, device=words.device)
    w_inv = torch.empty(lanes, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        rc = _counts_fn()(words.data_ptr(), k, lanes, m, lane_tot.data_ptr(), w_inv.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "et_symbol_counts")
    _build.count_launch(symbol_counts, words.device)
    return lane_tot, w_inv


def _check_write(items, ends, total, m, mini_tot, cap) -> None:
    lanes = items.shape[1] if items.dim() == 2 else 0
    if lanes == 0 or ends.shape != (lanes,) or total < 0:
        raise ValueError(f"write_symbols: items {tuple(items.shape)}, ends {tuple(ends.shape)}, "
                         f"total {total}")
    if mini_tot is None:
        _check_words(items, m)
    elif cap <= 0 or mini_tot.dim() != 2 or items.shape[0] != mini_tot.shape[0] * cap \
            or mini_tot.shape[1] != lanes:
        raise ValueError(f"write_symbols: plane {tuple(items.shape)}, mini_tot "
                         f"{tuple(mini_tot.shape)}, cap {cap}")


def write_symbols_plain(items: torch.Tensor, ends: torch.Tensor, total: int, m: int,
                        mini_tot: torch.Tensor | None = None, cap: int = 0) -> torch.Tensor:
    """Each lane's live symbols, lane after lane -> uint8[total]: of MASKED
    packed words int32[K, lanes] (``mini_tot`` None; slot j of a word is its
    byte ``m-1-j``, live while j < its count), or of a subgroup plane
    uint8[Gs*cap, lanes] (slot j of subgroup g live while j < ``mini_tot[g,
    lane]``). ``ends`` int64[lanes] is the inclusive scan of the lanes'
    symbol counts and ``total`` its last value, the kernel's output size;
    here a boolean selection, lane-major, gives the same order."""
    _check_write(items, ends, total, m, mini_tot, cap)
    lanes = items.shape[1]
    if mini_tot is None:
        plane, counts, _, _ = compact_symbols_dense(items, m)
        slots, n = plane.reshape(-1, m, lanes), counts
    else:
        slots, n = items.reshape(-1, cap, lanes), mini_tot
    live = torch.arange(slots.shape[1], device=items.device) < n.t()[:, :, None]
    out = slots.permute(2, 0, 1)[live]  # [lanes, rows, slot]: row-major is the stream order
    if out.numel() != total:
        raise ValueError(f"write_symbols: {out.numel()} live symbols, ends say {total}")
    return out


@_build.counted
def write_symbols(items: torch.Tensor, ends: torch.Tensor, total: int, m: int,
                  mini_tot: torch.Tensor | None = None, cap: int = 0) -> torch.Tensor:
    """The symbols kernel's write launch (both forms; replaces no TPU kernel);
    see :func:`write_symbols_plain`."""
    if items.device.type == "cpu":
        return write_symbols_plain(items, ends, total, m, mini_tot, cap)
    _check_write(items, ends, total, m, mini_tot, cap)
    _build.require(ends, torch.int64, "ends", items.device)
    if mini_tot is None:
        _build.require(items, torch.int32, "words")
    else:
        _build.require(items, torch.uint8, "plane")
        _build.require(mini_tot, torch.int32, "mini_tot", items.device)
    rows, lanes = items.shape
    out = torch.empty(total, dtype=torch.uint8, device=items.device)
    with torch.cuda.device(items.device):
        rc = _write_fn()(items.data_ptr(), None if mini_tot is None else mini_tot.data_ptr(),
                         rows, lanes, m, cap, ends.data_ptr(), out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "et_symbol_write")
    _build.count_launch(write_symbols, items.device)
    return out
