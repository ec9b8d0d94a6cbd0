"""Reference-exact Huffman code table (the upstream ``entreepy`` tool's rules).

1. Histogram of the 256 byte values.
2. Present symbols ordered by ascending count, ties by ascending byte value.
3. Two-queue merge over those leaves; on equal weight the leaf is taken
   before the merged node; the first node taken is the 0 child.
4. A code is the root-to-leaf path, not canonicalised.

Codes over 32 bits, and inputs of fewer than two distinct bytes, are outside
the format and raise.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

ALPHABET = 256
MAX_CODE_LEN = 32


@dataclass(frozen=True)
class CodeTable:
    """``codes[s]`` right-aligned in a uint32, ``lengths[s]`` its bits (0:
    byte ``s`` does not occur)."""

    codes: np.ndarray  # uint32[256]
    lengths: np.ndarray  # uint8[256]


def build_code_table(counts: np.ndarray) -> CodeTable:
    """The code table of a histogram, by the rules in the module docstring."""
    counts = np.asarray(counts, dtype=np.int64)
    present = np.flatnonzero(counts > 0)
    syms = present[np.lexsort((present, counts[present]))]
    n = len(syms)
    if n < 2:
        raise ValueError("fewer than two distinct bytes: outside the .et format")
    weights = [int(counts[s]) for s in syms]
    children: list[tuple[int, int]] = [(-1, -1)] * n
    leaves, merged = deque(range(n)), deque()
    while len(leaves) + len(merged) > 1:
        pair = []
        for _ in range(2):
            if not merged or (leaves and weights[leaves[0]] <= weights[merged[0]]):
                pair.append(leaves.popleft())
            else:
                pair.append(merged.popleft())
        weights.append(weights[pair[0]] + weights[pair[1]])
        children.append((pair[0], pair[1]))
        merged.append(len(weights) - 1)
    codes = np.zeros(ALPHABET, dtype=np.uint32)
    lengths = np.zeros(ALPHABET, dtype=np.uint8)
    stack = [(merged[0], 0, 0)]
    while stack:
        node, path, depth = stack.pop()
        if node < n:
            if depth > MAX_CODE_LEN:
                raise ValueError(f"code of {depth} bits: outside the .et format")
            codes[syms[node]], lengths[syms[node]] = path, depth
        else:
            left, right = children[node]
            stack.append((left, path << 1, depth + 1))
            stack.append((right, (path << 1) | 1, depth + 1))
    return CodeTable(codes, lengths)
