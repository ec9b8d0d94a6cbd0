"""Deterministic Huffman code construction — bit-exact with the reference tool.

The reference (typio/entreepy, Zig) builds *non-canonical* Huffman codes whose
exact bit patterns depend on its tie-breaking rules. To write `.et` files that
are byte-identical to the reference's output, we replicate those rules exactly
(in exact integer arithmetic, on host — this is O(256 log 256) work and never
a bottleneck):

1. Histogram: 256-bin byte occurrence count
   (reference: ``encode.zig:43-47``).
2. Symbol order: ascending count, ties broken by ascending byte value;
   zero-count symbols excluded (reference's selection sort,
   ``encode.zig:54-74``).
3. Tree: two-queue O(n) merge over the pre-sorted leaves. Two lightest nodes
   are merged; when the lightest leaf and the lightest internal node ("sapling")
   have equal weight, the *leaf* wins ("more optimal for minimizing code length
   variance", ``encode.zig:107-117``). The first node dequeued becomes the
   left/0 child, the second the right/1 child (``encode.zig:120-126``).
4. Codes are exact root-to-leaf paths: left edge appends a 0 bit, right edge
   a 1 bit (``encode.zig:181-197``). NOT canonicalised.

Known reference limitations (out of its contract — see SURVEY.md §2):

* Empty input / single distinct symbol produce undecodable output
  (root-is-leaf gets a 0-length code). We raise ``DegenerateInputError``
  in strict mode and assign a 1-bit code in relaxed mode.
* All 256 symbols present: the reference's sort index saturates at 255
  (``encode.zig:69-71``) and silently drops the most frequent symbol from the
  tree. We do NOT replicate that data-loss bug; with 256 distinct symbols our
  output is correct but may differ from the reference's (which is broken).
* Code length > 32 (pathological skewed histograms, >2^32 span): the
  reference silently overflows its u32 code; we raise ``CodeOverflowError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.ringbuf import RingQueue

MAX_CODE_LEN = 32  # reference: Code.data is u32 (encode.zig:142-144)
ALPHABET = 256


class DegenerateInputError(ValueError):
    """Input has < 2 distinct symbols; the reference format cannot represent it."""


class CodeOverflowError(ValueError):
    """A Huffman code exceeded 32 bits; the reference format cannot store it."""


@dataclass(frozen=True)
class CodeTable:
    """Per-symbol prefix codes.

    ``codes[s]`` holds the code for byte ``s`` right-aligned in a uint32
    (the MSB of the code is bit ``lengths[s]-1``); ``lengths[s] == 0`` means
    byte ``s`` does not occur.
    """

    codes: np.ndarray  # uint32[256]
    lengths: np.ndarray  # uint8[256]

    @property
    def num_symbols(self) -> int:
        return int(np.count_nonzero(self.lengths))

    @property
    def max_len(self) -> int:
        return int(self.lengths.max())

    @property
    def min_len(self) -> int:
        nz = self.lengths[self.lengths > 0]
        return int(nz.min()) if nz.size else 0

    def encoded_body_bits(self, counts: np.ndarray) -> int:
        """Exact bit length of the packed body for a given histogram."""
        return int((counts.astype(np.uint64) * self.lengths.astype(np.uint64)).sum())


def histogram(data) -> np.ndarray:
    """256-bin byte histogram (int64). Accepts bytes or a uint8 ndarray."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    if arr.size >= 1 << 16:
        from .. import runtime

        native = runtime.histogram(arr)
        if native is not None:
            return native
    return np.bincount(arr, minlength=ALPHABET).astype(np.int64)


def sorted_symbols(counts: np.ndarray) -> np.ndarray:
    """Symbols with count > 0 ordered by (count asc, byte asc) — uint8 array.

    Equivalent to the reference's selection sort (``encode.zig:54-74``), which
    walks distinct count values in ascending order appending symbols in
    ascending byte order.
    """
    counts = np.asarray(counts)
    present = np.flatnonzero(counts > 0)
    # np.lexsort: last key is primary. Ties on count resolve by byte value
    # because `present` is already ascending and lexsort is stable.
    order = np.lexsort((present, counts[present]))
    return present[order].astype(np.uint8)


def build_code_table(counts: np.ndarray, *, strict: bool = True) -> CodeTable:
    """Build the reference-exact code table from a byte histogram.

    strict=True raises on inputs outside the reference's contract
    (``DegenerateInputError`` for <2 distinct symbols). strict=False assigns
    the single present symbol a 1-bit code ``0`` so round-trips still work
    (such files are NOT reference-compatible — the reference cannot decode
    its own output for them either).
    """
    counts = np.asarray(counts, dtype=np.int64)
    syms = sorted_symbols(counts)
    n = len(syms)

    codes = np.zeros(ALPHABET, dtype=np.uint32)
    lengths = np.zeros(ALPHABET, dtype=np.uint8)

    if n == 0:
        raise DegenerateInputError("empty input: no symbols to code")
    if n == 1:
        if strict:
            raise DegenerateInputError(
                "single distinct symbol: the reference emits a 0-length code "
                "and cannot decode its own output; use strict=False to assign "
                "a 1-bit code"
            )
        lengths[syms[0]] = 1
        return CodeTable(codes, lengths)

    # Two-queue merge. Node i < n is the leaf for byte syms[i]; nodes >= n are
    # internal, created in merge order (weights ascend, so plain FIFOs suffice).
    # Fixed-capacity ring queues mirror the reference's preallocated arena
    # discipline (queue.zig:9-42, [513]?Node arena encode.zig:82): <=256
    # leaves, <=255 internal nodes alive at once.
    weights = [int(counts[s]) for s in syms]
    children: list[tuple[int, int]] = [(-1, -1)] * n
    leaf_q: RingQueue[int] = RingQueue(ALPHABET)
    sap_q: RingQueue[int] = RingQueue(ALPHABET)
    for i in range(n):
        leaf_q.enqueue(i)

    while len(leaf_q) + len(sap_q) > 1:
        picked = []
        for _ in range(2):
            if not sap_q:
                picked.append(leaf_q.dequeue())
            elif not leaf_q:
                picked.append(sap_q.dequeue())
            elif weights[leaf_q.peek()] <= weights[sap_q.peek()]:  # tie -> leaf wins
                picked.append(leaf_q.dequeue())
            else:
                picked.append(sap_q.dequeue())
        weights.append(weights[picked[0]] + weights[picked[1]])
        children.append((picked[0], picked[1]))  # (left/0, right/1)
        sap_q.enqueue(len(weights) - 1)

    root = leaf_q.peek() if leaf_q else sap_q.peek()

    # Root-to-leaf paths, iteratively. Paths are a property of the tree shape,
    # so traversal order is irrelevant to the resulting codes.
    stack = [(root, 0, 0)]  # (node, path_bits, path_len)
    while stack:
        node, path, plen = stack.pop()
        left, right = children[node] if node >= n else (-1, -1)
        if left < 0:  # leaf
            if plen > MAX_CODE_LEN:
                raise CodeOverflowError(f"code length {plen} exceeds 32 bits")
            codes[syms[node]] = path
            lengths[syms[node]] = plen
        else:
            stack.append((left, path << 1, plen + 1))
            stack.append((right, (path << 1) | 1, plen + 1))

    return CodeTable(codes, lengths)


def code_table_from_entries(entries) -> CodeTable:
    """CodeTable from an iterable of (symbol, length, code) — e.g. a parsed dict."""
    codes = np.zeros(ALPHABET, dtype=np.uint32)
    lengths = np.zeros(ALPHABET, dtype=np.uint8)
    for sym, length, code in entries:
        if not (1 <= length <= MAX_CODE_LEN):
            raise ValueError(f"invalid code length {length} for symbol {sym}")
        codes[sym] = code
        lengths[sym] = length
    return CodeTable(codes, lengths)
