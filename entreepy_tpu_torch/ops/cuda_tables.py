"""The one-pass decode tables: CUDA kernel on the card, plain PyTorch on the CPU.

Replaces no TPU kernel: the JAX package builds its decode tables in NumPy on
the host (``format/fsm8.py`` here: ``build_byte_fsm``, then
``fused_decode_tensors``), which stays the reference and the path of every
other route and device. The kernel is ``csrc/tables.cu``, whose header says
what bounds it (the launch: ~90 KB written, nothing read from device memory)
and how it is laid out. Caller: ``tables.card_decode_tables``, the one-pass
route's tables on a CUDA device (``decode8.route_tables``), one launch a
decode call (a mesh: one a rank).

The host keeps the code trie (``fsm8._build_trie``), packed by
:func:`pack_trie` as one 16-bit entry per edge, and the layout
(:func:`trie_layout`), whose ``m`` a DP over the trie gives before the
launch; the kernel writes every byte of ``next_state`` uint8[S, 256] and
``fused`` uint8[256, 2s + 9(mt + 2)], as ``ByteFsm.next_state`` and
``fused_decode_tensors(...).astype(np.uint8)`` lay them out.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..format.fsm8 import BYTE_BITS, BYTE_FANOUT, N_STATES

_P = ctypes.c_void_p
_I = ctypes.c_int
LEAF = 0x100  # edge entry of a leaf: LEAF | symbol
CHILD = 0x200  # edge entry of an internal child: CHILD | node; 0 is a dead edge
N_TAIL = BYTE_BITS + 1  # tail rows p = 0..8


@functools.cache
def _tables_fn():
    return _build.entry("et_fsm_tables", [_P, _I, _I, _I, _I, _P, _P, _P])


def pack_trie(children: np.ndarray, leaf_sym: np.ndarray) -> np.ndarray:
    """The trie (``fsm8._build_trie``: children, leaf_sym int32[n_int, 2])
    -> uint16[2 * n_int], edge ``2 * node + bit``: LEAF | symbol, CHILD |
    node, or 0 for a dead edge."""
    return np.where(leaf_sym >= 0, LEAF | leaf_sym,
                    np.where(children >= 0, CHILD | children, 0)).astype(np.uint16).reshape(-1)


def trie_layout(children: np.ndarray, leaf_sym: np.ndarray) -> tuple[int, int, int, int]:
    """(S, m, mt, s) of the trie's tables, as ``build_byte_fsm`` and
    ``fused_decode_tensors`` give them: S = 128 up to 128 internal nodes,
    else 256; s the nodes padded to 8; mt = max(1, m - 1). ``m``, the most
    symbols a valid byte emits from any state, is a DP over the trie:
    f_r(node) = max over its two edges of 1 + f_{r-1}(root) (a leaf),
    f_{r-1}(child) (a child) or none (a dead edge); m = max(1, max f_8).
    Raises ValueError past N_STATES nodes, as the host build does."""
    n_int = children.shape[0]
    if n_int > N_STATES:
        raise ValueError(f"{n_int} internal nodes exceed {N_STATES} FSM states")
    dead = -(1 << 20)
    f = np.zeros(n_int, np.int64)
    for _ in range(BYTE_BITS):
        f = np.where(leaf_sym >= 0, 1 + f[0],
                     np.where(children >= 0, f[np.maximum(children, 0)], dead)).max(1)
        f = np.maximum(f, dead)
    m = max(1, int(f.max()))
    return 128 if n_int <= 128 else N_STATES, m, max(1, m - 1), max(8, -(-n_int // 8) * 8)


def _check(edges: np.ndarray, width: int, s: int, mt: int) -> int:
    n_int = edges.size // 2
    if edges.ndim != 1 or edges.size % 2 or not 1 <= n_int <= width <= N_STATES \
            or not n_int <= s <= width or not 1 <= mt < BYTE_BITS:
        raise ValueError(f"fsm_tables: edges {edges.shape}, S {width}, s {s}, mt {mt}")
    return n_int


def fsm_tables_plain(edges: np.ndarray, width: int, s: int, mt: int, device):
    """The packed trie uint16[2 * n_int] -> (next_state uint8[S, 256],
    fused uint8[256, 2s + 9(mt + 2)]) on ``device``: every (state, byte)
    walk of 8 bits in lockstep, then every (p, byte) tail walk from the
    root, as ``_build_byte_fsm``, ``_first_walk`` and ``_tail_walk`` walk
    them."""
    n_int = _check(edges, width, s, mt)
    e = torch.as_tensor(edges.astype(np.int64), device=device)
    byte = torch.arange(BYTE_FANOUT, device=device)
    bits = (byte[None, :] >> (BYTE_BITS - 1 - torch.arange(BYTE_BITS, device=device))[:, None]) & 1

    def step(node, bit):
        ed = e[2 * node + bit]
        return ed, (ed & LEAF) != 0, (ed & (LEAF | CHILD)) == 0, \
            torch.where((ed & CHILD) != 0, ed & 255, 0)

    state = torch.arange(width, device=device)[:, None].expand(width, BYTE_FANOUT)
    invalid = state >= n_int
    done, inv_first = invalid.clone(), invalid.clone()
    node = torch.where(invalid, 0, state)
    first = p = torch.zeros_like(node)
    for i in range(BYTE_BITS):
        ed, leaf, dead, node = step(node, bits[i])
        hit = ~done & leaf
        first, p = torch.where(hit, ed & 255, first), torch.where(hit, i + 1, p)
        inv_first = inv_first | (~done & dead)
        done, invalid = done | leaf | dead, invalid | dead
    next_state = torch.where(invalid, 0, node)

    p_col = torch.arange(N_TAIL, device=device)[:, None]
    tnode = tcnt = torch.zeros(N_TAIL, BYTE_FANOUT, dtype=torch.int64, device=device)
    tinv = torch.zeros(N_TAIL, BYTE_FANOUT, dtype=torch.bool, device=device)
    syms = torch.zeros(N_TAIL, BYTE_FANOUT, mt, dtype=torch.int64, device=device)
    for i in range(BYTE_BITS):
        act = (p_col >= 1) & (p_col <= i)  # the walk starts at bit p
        ed, leaf, dead, nxt = step(tnode, bits[i].expand(N_TAIL, BYTE_FANOUT))
        take = act & leaf & ~tinv
        slot = tcnt.clamp(max=mt - 1)[..., None]
        syms.scatter_(2, slot, torch.where(take, ed & 255, syms.gather(2, slot)[..., 0])[..., None])
        tcnt, tinv = tcnt + take, tinv | (act & dead)
        tnode = torch.where(act, nxt, tnode)

    fused = torch.cat([
        torch.where(p > 0, first, next_state)[:s].t(),
        (p + 16 * inv_first)[:s].t(),
        (tcnt.clamp(max=mt) + 16 * tinv).t(),
        *(syms[:, :, j].t() for j in range(mt)),
        tnode.t(),
    ], dim=1)
    return next_state.to(torch.uint8), fused.to(torch.uint8).contiguous()


@_build.counted
def fsm_tables(edges: np.ndarray, width: int, s: int, mt: int, device):
    """The tables kernel's launch (replaces no TPU kernel); see
    :func:`fsm_tables_plain`. ``edges`` stays on the host: the kernel takes
    it in its launch parameters, so nothing is uploaded."""
    device = torch.device(device)
    if device.type == "cpu":
        return fsm_tables_plain(edges, width, s, mt, device)
    n_int = _check(edges, width, s, mt)
    if device.type != "cuda":
        raise ValueError(f"fsm_tables: want a CUDA or CPU device, got {device}")
    edges = np.ascontiguousarray(edges, dtype=np.uint16)
    next_state = torch.empty((width, BYTE_FANOUT), dtype=torch.uint8, device=device)
    fused = torch.empty((BYTE_FANOUT, 2 * s + N_TAIL * (mt + 2)), dtype=torch.uint8,
                        device=device)
    with torch.cuda.device(next_state.device):
        rc = _tables_fn()(edges.ctypes.data, n_int, width, s, mt, next_state.data_ptr(),
                          fused.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "et_fsm_tables")
    _build.count_launch(fsm_tables, next_state.device)
    return next_state, fused
