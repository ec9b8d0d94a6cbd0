"""The ``.et`` body: every byte's code, MSB first, zero-padded to a byte.

An exclusive prefix sum of the code lengths gives each code's first bit.
A code of at most 32 bits starting at bit ``o`` lies within the two
big-endian u32 words ``o >> 5`` and ``(o >> 5) + 1``; its two parts are
summed into those words with ``np.bincount``. Codes never share a bit, so
each word's sum is its OR, below 2**32 and exact in float64. The document
is packed in slices of ``SLICE`` bytes, a few at a time in threads (NumPy
lets go of the interpreter lock in these calls), each from the bit at which
the slices before it end; the slices' words are summed in order.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .huffman import ALPHABET, CodeTable

SLICE = 1 << 23
THREADS = min(8, os.cpu_count() or 1)


def slices(arr: np.ndarray) -> list[np.ndarray]:
    return [arr[lo:lo + SLICE] for lo in range(0, arr.size, SLICE)] or [arr]


def slice_counts(arr: np.ndarray) -> np.ndarray:
    """Byte counts of each slice of ``arr``: int64[slices, 256]."""
    with ThreadPoolExecutor(THREADS) as ex:
        return np.stack(list(ex.map(lambda p: np.bincount(p, minlength=ALPHABET), slices(arr))))


def _pack_slice(part: np.ndarray, base: int, lens_t: np.ndarray, codes_t: np.ndarray):
    """(first word, summed words) of the codes of ``part`` from bit ``base``."""
    lens = lens_t[part]
    ends = np.cumsum(lens, dtype=np.int64) + base
    offs = ends - lens
    word = offs >> 5
    window = codes_t[part] << (64 - (offs & 31) - lens).astype(np.uint64)
    first = int(word[0])
    rel = word - first
    span = int(rel[-1]) + 2
    return first, (np.bincount(rel, weights=(window >> np.uint64(32)).astype(np.float64),
                               minlength=span)
                   + np.bincount(rel + 1, minlength=span,
                                 weights=(window & np.uint64(0xFFFFFFFF)).astype(np.float64)))


def pack_body(arr: np.ndarray, table: CodeTable, counts: np.ndarray | None = None) -> bytes:
    """The packed body of ``arr`` (uint8) under ``table``; ``counts``: the
    slices' byte counts (:func:`slice_counts`), where the caller has them."""
    if arr.size == 0:
        return b""
    counts = slice_counts(arr) if counts is None else counts
    lens_t = table.lengths.astype(np.int64)
    if (lens_t[counts.sum(axis=0) > 0] == 0).any():
        raise ValueError("a byte of the document has no code")
    bits = counts @ lens_t
    bases = np.concatenate([[0], np.cumsum(bits)])
    total_bits = int(bases[-1])
    n_words = (total_bits + 31) // 32
    words = np.zeros(n_words + 2, dtype=np.uint64)
    codes_t = table.codes.astype(np.uint64)
    with ThreadPoolExecutor(THREADS) as ex:
        parts = ex.map(lambda a: _pack_slice(a[0], int(a[1]), lens_t, codes_t),
                       zip(slices(arr), bases[:-1]))
        for first, sums in parts:
            words[first:first + sums.size] += sums.astype(np.uint64)
    return words[:n_words].astype(">u4").tobytes()[:(total_bits + 7) // 8]
