"""Byte-granularity Huffman decode FSM: one table transition per compressed byte.

The port's own copy of ``entreepy_tpu/format/fsm8.py``: the same tables with
the same names and layouts, built in numpy. The state machine consumes a
whole byte per transition, so a stream of N compressed bytes costs N
sequential steps. The reference decoder probes a hash map per candidate code
length per symbol (``decode.zig:166-200``); here the entire per-byte
transition is

* state  = current trie node (a 256-leaf tree has <= 255 internal nodes)
* input  = next 8 stream bits (MSB first)
* output = (next_state, count, up to 8 emitted symbols)

The card's kernels (``csrc/fsm8.cu``, ``csrc/expand.cu``) read these tables
as uint8 from shared or device memory. Every table value is <= 255.

Corruption detection: a byte transition that walks an unreachable trie edge
is marked invalid (``counts < 0``); the decoders raise when such an entry is
consumed before the symbol count is met, matching the host LUT path's
"invalid bitstream" error.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..trace import count, phase
from .huffman import CodeTable

BYTE_BITS = 8
BYTE_FANOUT = 1 << BYTE_BITS  # 256
MAX_SYMS_PER_BYTE = 8  # min code length 1 bit -> <= 8 symbols per byte
N_STATES = 256


@dataclass(frozen=True)
class ByteFsm:
    """Byte-transition tables. S (the padded state width) is 128 when the
    tree has <= 128 internal nodes — the common case for text, halving the
    one-hot contraction — else 256.

    next_state[s, b]  state after consuming byte ``b`` in state ``s``
    counts[s, b]      symbols emitted by that transition, or -1 if the walk
                      crossed an unreachable trie edge (corrupt stream)
    syms[s, b, :]     the emitted symbols, left-justified
    """

    next_state: np.ndarray  # uint8[S, 256]
    counts: np.ndarray  # int8[S, 256], -1 = invalid transition
    syms: np.ndarray  # uint8[S, 256, 8]
    n_states: int  # actual internal node count (root = state 0)
    max_len: int
    min_len: int
    # The underlying trie (split_expand_tensors rebuilds per-byte walks from
    # it): children[s, b] = internal node on bit b or -1, leaf_sym[s, b] =
    # symbol when that edge lands on a leaf, else -1.
    children: np.ndarray  # int32[n_states, 2]
    leaf_sym: np.ndarray  # int32[n_states, 2]

    @property
    def width(self) -> int:
        return self.next_state.shape[0]


def _build_trie(table: CodeTable) -> tuple[np.ndarray, np.ndarray]:
    """Binary trie of the code table.

    Returns (children int32[n_int, 2], leaf_sym int32[n_int, 2]) where
    children[s, b] >= 0 is the internal node reached from s on bit b,
    or -1 when that edge lands on a leaf; leaf_sym[s, b] is that leaf's
    symbol (or -1). Node 0 is the root.
    """
    children = [[-1, -1]]
    leaf_sym = [[-1, -1]]
    present = np.flatnonzero(table.lengths > 0)
    for sym in present.tolist():
        length = int(table.lengths[sym])
        code = int(table.codes[sym])
        node = 0
        for i in range(length - 1):
            bit = (code >> (length - 1 - i)) & 1
            nxt = children[node][bit]
            if nxt < 0:
                children.append([-1, -1])
                leaf_sym.append([-1, -1])
                nxt = len(children) - 1
                children[node][bit] = nxt
            node = nxt
        leaf_sym[node][code & 1] = sym
    return np.asarray(children, np.int32), np.asarray(leaf_sym, np.int32)


_FSM_CACHE: dict[bytes, ByteFsm] = {}
_FSM_CACHE_MAX = 8


def build_byte_fsm(table: CodeTable) -> ByteFsm:
    """Code table -> byte-granularity FSM, memoized on the table content
    (the vectorized build takes ~10-20 ms with ``fused_decode_tensors``).
    A miss is the stage ``fsm_build`` and one ``fsm_builds`` count. The
    one-pass route on a CUDA device builds no ByteFsm: its tables are built
    on the card from the trie (``tables.card_decode_tables``), and a decode
    whose tables differ each call, as most do, never hits this cache."""
    key = table.lengths.tobytes() + table.codes.tobytes()
    hit = _FSM_CACHE.get(key)
    if hit is not None:
        return hit
    with phase("fsm_build"):
        fsm = _build_byte_fsm(table)
    count("fsm_builds", 1)
    if len(_FSM_CACHE) >= _FSM_CACHE_MAX:
        _FSM_CACHE.pop(next(iter(_FSM_CACHE)))
    _FSM_CACHE[key] = fsm
    return fsm


def _build_byte_fsm(table: CodeTable) -> ByteFsm:
    """Vectorized build: eight simultaneous single-bit trie steps on
    [S, 256] state arrays."""
    children, leaf_sym = _build_trie(table)
    n_int = children.shape[0]
    if n_int > N_STATES:
        raise ValueError(f"{n_int} internal nodes exceed {N_STATES} FSM states")
    width = 128 if n_int <= 128 else N_STATES

    # Walk all (state, byte) pairs in lockstep, one bit per round.
    byte_vals = np.arange(BYTE_FANOUT, dtype=np.int32)
    state0 = np.repeat(np.arange(width, dtype=np.int32), BYTE_FANOUT)  # [S*256]
    bits = (byte_vals[None, :] >> (BYTE_BITS - 1 - np.arange(BYTE_BITS)[:, None])) & 1
    bits = np.broadcast_to(bits[:, None, :], (BYTE_BITS, width, BYTE_FANOUT)).reshape(
        BYTE_BITS, -1
    )

    node = state0.copy()
    # States >= n_int are padding rows: mark every transition invalid.
    invalid = node >= n_int
    node = np.where(invalid, 0, node)
    counts = np.zeros(node.shape, dtype=np.int64)
    syms = np.zeros((node.size, MAX_SYMS_PER_BYTE), dtype=np.uint8)

    for i in range(BYTE_BITS):
        b = bits[i]
        ls = leaf_sym[node, b]  # symbol reached, or -1
        ch = children[node, b]  # internal child, or -1
        is_leaf = ls >= 0
        # leaf: emit symbol, restart at root; internal: descend; neither: invalid
        dead = ~is_leaf & (ch < 0)
        invalid |= dead
        take = is_leaf & ~invalid
        syms[np.arange(node.size), np.minimum(counts, MAX_SYMS_PER_BYTE - 1)] = np.where(
            take, ls, syms[np.arange(node.size), np.minimum(counts, MAX_SYMS_PER_BYTE - 1)]
        ).astype(np.uint8)
        counts = counts + take.astype(np.int64)
        node = np.where(is_leaf, 0, np.where(ch >= 0, ch, 0))

    next_state = np.where(invalid, 0, node).astype(np.uint8).reshape(width, BYTE_FANOUT)
    counts8 = np.where(invalid, -1, counts).astype(np.int8).reshape(width, BYTE_FANOUT)
    syms8 = syms.reshape(width, BYTE_FANOUT, MAX_SYMS_PER_BYTE)

    return ByteFsm(
        next_state=next_state,
        counts=counts8,
        syms=syms8,
        n_states=n_int,
        max_len=table.max_len,
        min_len=table.min_len,
        children=children,
        leaf_sym=leaf_sym,
    )


def expand_tensors(fsm: ByteFsm) -> tuple[np.ndarray, int]:
    """Expand-table for on-device symbol emission (ops/decode8.py
    ``expand_pass_device``): float32[256, (m+1)*S] where m = the table's
    max symbols-per-byte. S-wide column blocks, selected by the (known,
    precomputed) state after one ``onehot(byte) @ T`` matmul:

    * block 0 — symbol count with the invalid flag packed in bit 4
      (count + 16*invalid; count <= 8, so values <= 24 — one block serves
      both and saves a fifth of the contraction width)
    * block 1+j — symbol slot j (0 beyond the transition's count)

    Every value <= 255, so bf16 one-hot matmuls are exact.
    """
    m = max(1, int(fsm.counts.max(initial=1)))
    s = fsm.width
    t = np.zeros((BYTE_FANOUT, (m + 1) * s), np.float32)
    packed = np.maximum(fsm.counts, 0) + 16 * (fsm.counts < 0)
    t[:, 0:s] = packed.astype(np.float32).T
    for j in range(m):
        t[:, (1 + j) * s : (2 + j) * s] = fsm.syms[:, :, j].astype(np.float32).T
    return t, m


def _first_walk(fsm: ByteFsm, s: int):
    """Per-(state, byte) first-code walk shared by the split/fused tables.

    Returns (first_sym, pfx, inv_first, node) flat [s*256] arrays: the first
    symbol completed in the byte (0 if none), the bit position 1..8 where it
    completed (0 = none), whether the walk died on an unreachable edge
    before completing one, and the final walk node (for p = 0 rows this is
    the pure continuation state — no restart happened — i.e. exactly
    ``fsm.next_state``)."""
    children, leaf_sym = fsm.children, fsm.leaf_sym
    n_int = children.shape[0]
    byte_vals = np.arange(BYTE_FANOUT, dtype=np.int32)
    bits = (byte_vals[None, :] >> (BYTE_BITS - 1 - np.arange(BYTE_BITS)[:, None])) & 1

    node = np.repeat(np.arange(s, dtype=np.int32), BYTE_FANOUT)  # [S*256]
    bits_sb = np.broadcast_to(bits[:, None, :], (BYTE_BITS, s, BYTE_FANOUT)).reshape(
        BYTE_BITS, -1
    )
    inv_first = node >= n_int  # padding rows: every transition invalid
    node = np.where(inv_first, 0, node)
    done = inv_first.copy()
    first_sym = np.zeros(node.shape, np.int64)
    pfx = np.zeros(node.shape, np.int64)  # bit pos after first code; 0 = none
    for i in range(BYTE_BITS):
        b = bits_sb[i]
        ls = leaf_sym[node, b]
        ch = children[node, b]
        is_leaf = ls >= 0
        dead = ~is_leaf & (ch < 0)
        hit = ~done & is_leaf
        inv_first |= ~done & dead
        first_sym = np.where(hit, ls, first_sym)
        pfx = np.where(hit, i + 1, pfx)
        done |= is_leaf | dead
        node = np.where(is_leaf, 0, np.where(ch >= 0, ch, 0))
    return first_sym, pfx, inv_first, node


def _tail_walk(fsm: ByteFsm, mt: int):
    """Per-(p, byte) tail walk (bits p..7 from the root) shared by the
    split/fused tables. Returns (tcnt, tinv, tsyms, tnode): symbol count,
    death flag, symbol slots, and the walk's end node (= the FSM next state
    whenever a first code completed at bit p)."""
    children, leaf_sym = fsm.children, fsm.leaf_sym
    byte_vals = np.arange(BYTE_FANOUT, dtype=np.int32)
    bits = (byte_vals[None, :] >> (BYTE_BITS - 1 - np.arange(BYTE_BITS)[:, None])) & 1

    n_p = BYTE_BITS + 1  # p in 0..8; row 0 (no first code) stays all-zero
    tnode = np.zeros((n_p, BYTE_FANOUT), np.int32)
    tcnt = np.zeros((n_p, BYTE_FANOUT), np.int64)
    tinv = np.zeros((n_p, BYTE_FANOUT), bool)
    tsyms = np.zeros((n_p, BYTE_FANOUT, mt), np.uint8)
    p_col = np.arange(n_p)[:, None]
    flat = np.arange(n_p * BYTE_FANOUT)
    for i in range(BYTE_BITS):
        act = (p_col >= 1) & (p_col <= i)  # walk starts at bit p
        b = np.broadcast_to(bits[i], (n_p, BYTE_FANOUT))
        ls = leaf_sym[tnode, b]
        ch = children[tnode, b]
        is_leaf = ls >= 0
        dead = ~is_leaf & (ch < 0)
        take = act & is_leaf & ~tinv
        tinv |= act & dead
        idx = np.minimum(tcnt, mt - 1).ravel()
        fs = tsyms.reshape(-1, mt)
        fs[flat, idx] = np.where(take.ravel(), ls.ravel(), fs[flat, idx]).astype(
            np.uint8
        )
        tcnt += take
        step = np.where(is_leaf, 0, np.where(ch >= 0, ch, 0))
        tnode = np.where(act, step, tnode)
    # Unreachable (byte, p) combos can overshoot mt symbols; no real
    # (state, byte) pair ever selects them, clamp for cleanliness.
    tcnt = np.minimum(tcnt, mt)
    return tcnt, tinv, tsyms, tnode


def split_expand_tensors(fsm: ByteFsm) -> tuple[np.ndarray, int, int]:
    """Split expand table — the arithmetic-reduced form of
    :func:`expand_tensors`.

    Key decomposition: within one byte's 8-bit walk from state ``s``, only
    the FIRST completed code depends on ``s`` — after it, the walk restarts
    at the root, so every later symbol depends only on ``(byte, p)`` where
    ``p`` is the bit position (1..8) where the first code completed. That
    replaces the fused table's ``(m+1)·S``-wide contraction with
    ``2S + 9·(mt+1)`` (mt = m-1 tail slots; p has 9 values incl. "none"):
    for the common S=128/m=3 case, 512 -> 283 one-hot columns.

    Layout (single f32[256, 2S + 9*(mt+1)] so the kernel issues ONE matmul
    per byte; every value <= 255, exact in bf16):

    * cols ``0:S``        first symbol completed, by (byte, state); 0 if none
    * cols ``S:2S``       ``p + 16*invalid_first`` — p = bits consumed by the
                          first code (0 = none completed), flag = the walk
                          died on an unreachable edge before completing one
    * cols ``2S:2S+9``    tail ``count + 16*invalid``, by (byte, p)
    * 9-col blocks j      tail symbol slot j, by (byte, p)

    Device combine (``csrc/expand.cu`` ``expand_split_kernel``): read the
    first two blocks at the state, then the tail blocks at the just-read p;
    ``count = (p>0) + tail_count``, ``invalid = either flag`` — exactly
    :func:`expand_tensors`'s packed outputs.

    Returns (table, m, mt).
    """
    m = max(1, int(fsm.counts.max(initial=1)))
    mt = max(1, m - 1)
    s = fsm.width
    first_sym, pfx, inv_first, _ = _first_walk(fsm, s)
    tcnt, tinv, tsyms, _ = _tail_walk(fsm, mt)
    n_p = BYTE_BITS + 1

    t = np.zeros((BYTE_FANOUT, 2 * s + (BYTE_BITS + 1) * (mt + 1)), np.float32)
    t[:, 0:s] = first_sym.reshape(s, BYTE_FANOUT).T
    t[:, s : 2 * s] = (pfx + 16 * inv_first).reshape(s, BYTE_FANOUT).T
    t[:, 2 * s : 2 * s + n_p] = (tcnt + 16 * tinv).T
    for j in range(mt):
        off = 2 * s + (1 + j) * n_p
        t[:, off : off + n_p] = tsyms[:, :, j].T
    return t, m, mt


def fused_decode_tensors(fsm: ByteFsm) -> tuple[np.ndarray, int, int, int]:
    """ONE-PASS decode table: drives the state chain AND the symbol
    expansion from a single ``2s + 9*(mt+2)``-column one-hot contraction per
    byte — no separate emit pass, no state re-read, and narrower than the
    split expand table alone (``2s + 9(mt+1)`` at s = fsm.width) because
    ``s`` here is the ACTUAL internal-node count padded to 8 instead of the
    MXU-padded 128.

    Key identity: after the first code completes at bit p >= 1 the walk is
    at the root, so ``next_state(state, byte) = tail_end(byte, p)`` — a
    9-value table. Only the p = 0 case (no code completed) needs the full
    per-(state, byte) continuation, and in that case NO first symbol exists
    — so the continuation state and the first symbol share one S-block
    (``merged``), selected by p.

    Layout f32[256, 2s + 9*(mt+2)], every value <= 255 (exact in bf16):

    * cols ``0:s``        merged: first symbol if p >= 1, else the
                          continuation state ``next_state[s, b]``
    * cols ``s:2s``       ``p + 16*invalid_first``
    * cols ``2s:2s+9``    tail ``count + 16*invalid``, by (byte, p)
    * mt 9-col blocks     tail symbol slot j, by (byte, p)
    * last 9-col block    tail end state, by (byte, p) (row p=0 unused)

    Device combine (``csrc/fsm8.cu`` ``fused_kernel``): read the two S-blocks
    at the running state and the tail blocks at p; the next state is
    ``state' = p > 0 ? tail_end : merged``; emitted rows are identical to
    :func:`expand_tensors`'s packed layout (row 0 = count + 16*invalid,
    rows 1.. = symbol slots with the first symbol in slot 0).

    On chain divergence after an *invalid* transition: the packed row 0
    carries the invalid flag, and an invalid transition at-or-before the
    output's completion point always rejects the stream, so any post-
    invalid state divergence from the emit-pass chain is unobservable in
    accepted outputs (the JAX package's tests/test_decode8.py fused-vs-serial cases).

    Reference counterpart: the whole decode hot loop ``decode.zig:143-203``
    (shift-register + hash probes, one symbol at a time) — here one MXU
    contraction advances a full byte AND emits its symbols.

    Returns (table, m, mt, s).
    """
    m = max(1, int(fsm.counts.max(initial=1)))
    mt = max(1, m - 1)
    s = max(8, -(-fsm.n_states // 8) * 8)  # pad to sublane multiple, not 128
    first_sym, pfx, inv_first, _ = _first_walk(fsm, s)
    tcnt, tinv, tsyms, tnode = _tail_walk(fsm, mt)
    n_p = BYTE_BITS + 1

    # next_state for the p = 0 continuation; fsm.next_state is [width, 256],
    # s <= width always (both cover >= n_states).
    cont = fsm.next_state[:s, :].astype(np.int64).reshape(-1)
    merged = np.where(pfx >= 1, first_sym, cont)

    t = np.zeros((BYTE_FANOUT, 2 * s + n_p * (mt + 2)), np.float32)
    t[:, 0:s] = merged.reshape(s, BYTE_FANOUT).T
    t[:, s : 2 * s] = (pfx + 16 * inv_first).reshape(s, BYTE_FANOUT).T
    t[:, 2 * s : 2 * s + n_p] = (tcnt + 16 * tinv).T
    for j in range(mt):
        off = 2 * s + (1 + j) * n_p
        t[:, off : off + n_p] = tsyms[:, :, j].T
    t[:, 2 * s + (1 + mt) * n_p :] = tnode.T
    return t, m, mt, s
