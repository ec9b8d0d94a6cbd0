"""The controls: the reference put in the program's place with one guarantee
of the configuration broken. The comparison that decides ``correct`` has to
fail each of them.

* ``et_file(doc, canonical=True)`` — the writer with canonical codes: the
  same code lengths, so the same sizes, but codes assigned in (length, byte)
  order (:func:`canonical_table`), as most Huffman coders do. It breaks
  "byte for byte the upstream tool's file".
* :func:`nosync_decode` — a chunk-parallel decode that starts every chunk of
  the body at the root of the code tree, skipping the self-synchronisation
  that the device decode's sync passes exist for. It breaks "every byte
  decoded back".
"""

from __future__ import annotations

import numpy as np

from .etformat import parse_table
from .huffman import ALPHABET, CodeTable

CHUNK_BYTES = 512  # the device decode's chunk (lane) width


def canonical_table(table: CodeTable) -> CodeTable:
    """The canonical code of ``table``'s lengths."""
    codes = np.zeros(ALPHABET, dtype=np.uint32)
    order = sorted((int(n), s) for s, n in enumerate(table.lengths) if n)
    code, prev = 0, order[0][0]
    for n, s in order:
        code <<= n - prev
        codes[s], prev = code, n
        code += 1
    return CodeTable(codes, table.lengths.copy())


def byte_fsm(table: CodeTable):
    """The decoder as an automaton over bytes: states are the code tree's
    inner nodes (0 the root) -> (next state int32[S, 256], symbols emitted
    uint8[S, 256], those symbols uint8[S, 256, 8])."""
    kids = [[-1, -1]]  # inner node -> its two children; a leaf is -(symbol + 1)
    for s in range(ALPHABET):
        n = int(table.lengths[s])
        node = 0
        for i in range(n - 1, -1, -1):
            bit = (int(table.codes[s]) >> i) & 1
            if i == 0:
                kids[node][bit] = -(s + 1)
            else:
                if kids[node][bit] < 0:
                    kids.append([-1, -1])
                    kids[node][bit] = len(kids) - 1
                node = kids[node][bit]
    states = len(kids)
    nxt = np.zeros((states, 256), dtype=np.int32)
    cnt = np.zeros((states, 256), dtype=np.uint8)
    syms = np.zeros((states, 256, 8), dtype=np.uint8)
    for st in range(states):
        for b in range(256):
            node, k = st, 0
            for i in range(7, -1, -1):
                node = kids[node][(b >> i) & 1]
                if node < 0:
                    syms[st, b, k] = -node - 1
                    k += 1
                    node = 0
            nxt[st, b], cnt[st, b] = node, k
    return nxt, cnt, syms


def nosync_decode(et: bytes, chunk_bytes: int = CHUNK_BYTES) -> bytes:
    """Every ``chunk_bytes`` chunk of the body decoded from the root, the
    chunks' symbols joined and cut to the original length."""
    table, n_orig, start = parse_table(et)
    body = np.frombuffer(et, dtype=np.uint8)[start:]
    nxt, cnt, syms = byte_fsm(table)
    lanes = -(-body.size // chunk_bytes)
    cols = np.zeros(lanes * chunk_bytes, dtype=np.uint8)
    cols[:body.size] = body
    cols = cols.reshape(lanes, chunk_bytes)
    state = np.zeros(lanes, dtype=np.int32)
    counts = np.empty((lanes, chunk_bytes), dtype=np.uint8)
    out = np.empty((lanes, chunk_bytes, 8), dtype=np.uint8)
    for k in range(chunk_bytes):
        b = cols[:, k]
        counts[:, k] = cnt[state, b]
        out[:, k] = syms[state, b]
        state = nxt[state, b]
    return out[np.arange(8)[None, None, :] < counts[..., None]][:n_orig].tobytes()
