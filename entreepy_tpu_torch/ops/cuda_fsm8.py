"""Byte-FSM decode passes: CUDA kernels on the card, plain PyTorch on the CPU.

Counterpart of ``entreepy_tpu/ops/pallas_fsm8.py``. The kernels live in
``csrc/fsm8.cu`` (sync, emit and fused passes) and ``csrc/expand.cu`` (the
two-pass expansions), whose headers say what bounds them and how they are
laid out. Each public function dispatches on the device of its byte tensor:
a CPU tensor runs the plain version beside it, a CUDA tensor launches the
kernel or raises. A wrapper counts its kernel launches in its ``launches``
attribute, and by CUDA device index in ``launches_on`` (``_build.count_launch``). The expansions' states must be below the table's S, as the emit
pass's are: the kernels index the tables with them unchecked.

Layouts are the JAX package's: byte rows ``xs`` are ``[K, lanes]`` (one lane
per chunk), tables are the uint8 forms of ``entreepy_tpu_torch.tables``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
N_P = 9  # first-code end positions: 1..8 plus 0 = "no code completed"


@functools.cache
def _sync_fn():
    return _build.entry("et_sync_pass", [_P, _P, _I, _P, _P, _I, _I, _P])


@functools.cache
def _emit_fn():
    return _build.entry("et_emit_pass", [_P, _P, _I, _P, _P, _P, _I, _I, _P])


@functools.cache
def _expand_split_fn():
    return _build.entry("et_expand_split_pass",
                        [_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _P])


@functools.cache
def _expand_fn():
    return _build.entry("et_expand_pass", [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P])


@functools.cache
def _fused_fn():
    return _build.entry(
        "et_fused_pass",
        [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_longlong, _I, _P],
    )


def _require_walk(xs, next_state, entries, name: str) -> None:
    _build.require(xs, torch.uint8, "xs")
    _build.require(next_state, torch.uint8, "next_state", xs.device)
    _build.require(entries, torch.int32, "entries", xs.device)
    lanes = xs.shape[1]
    if lanes == 0 or entries.shape != (lanes,) or next_state.shape[1] != 256 \
            or next_state.data_ptr() % 16:
        raise ValueError(f"{name}: empty lanes, {lanes} lanes but entries "
                         f"{tuple(entries.shape)}, or a bad next_state table")


def sync_pass_plain(xs: torch.Tensor, next_state: torch.Tensor,
                    entries: torch.Tensor) -> torch.Tensor:
    """State-only walk: xs uint8[W, lanes], next_state uint8[S, 256],
    entries int32[lanes] -> exits int32[lanes]."""
    tbl = next_state.reshape(-1).long()
    state = entries.long()
    for row in xs.long():
        state = tbl[state * 256 + row]
    return state.int()


@_build.counted
def sync_pass(xs: torch.Tensor, next_state: torch.Tensor,
              entries: torch.Tensor) -> torch.Tensor:
    """Kernel 1 (replaces ``sync_pass_pallas8``); see :func:`sync_pass_plain`."""
    if xs.device.type == "cpu":
        return sync_pass_plain(xs, next_state, entries)
    w, lanes = xs.shape
    _require_walk(xs, next_state, entries, "sync_pass")
    exits = torch.empty(lanes, dtype=torch.int32, device=xs.device)
    with torch.cuda.device(xs.device):
        rc = _sync_fn()(
            xs.data_ptr(), next_state.data_ptr(), next_state.shape[0],
            entries.data_ptr(), exits.data_ptr(), w, lanes,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "et_sync_pass")
    _build.count_launch(sync_pass, exits.device)
    return exits


def emit_pass_plain(xs: torch.Tensor, next_state: torch.Tensor,
                    entries: torch.Tensor):
    """Full state walk that keeps every byte's state BEFORE its transition:
    xs uint8[K, lanes], next_state uint8[S, 256], entries int32[lanes] ->
    (states uint8[K, lanes], exits int32[lanes])."""
    tbl = next_state.reshape(-1).long()
    state = entries.long()
    states = torch.empty(xs.shape, dtype=torch.uint8, device=xs.device)
    for k, row in enumerate(xs.long()):
        states[k] = state
        state = tbl[state * 256 + row]
    return states, state.int()


@_build.counted
def emit_pass(xs: torch.Tensor, next_state: torch.Tensor, entries: torch.Tensor):
    """Kernel 5 (replaces ``emit_pass_pallas8``, whose four-states-per-word
    packing does not come across); see :func:`emit_pass_plain`."""
    if xs.device.type == "cpu":
        return emit_pass_plain(xs, next_state, entries)
    k, lanes = xs.shape
    _require_walk(xs, next_state, entries, "emit_pass")
    states = torch.empty((k, lanes), dtype=torch.uint8, device=xs.device)
    exits = torch.empty(lanes, dtype=torch.int32, device=xs.device)
    with torch.cuda.device(xs.device):
        rc = _emit_fn()(
            xs.data_ptr(), next_state.data_ptr(), next_state.shape[0],
            entries.data_ptr(), states.data_ptr(), exits.data_ptr(), k, lanes,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "et_emit_pass")
    _build.count_launch(emit_pass, states.device)
    return states, exits


def _split_width(t_split: torch.Tensor, mt: int) -> int:
    """S of a split table uint8[256, 2S + 9(mt+1)], from its shape."""
    return (t_split.shape[1] - N_P * (mt + 1)) // 2


def expand_pass_split_plain(xs: torch.Tensor, states: torch.Tensor,
                            t_split: torch.Tensor, m: int, mt: int) -> torch.Tensor:
    """Split-table expansion (the combine rule of
    ``pallas_fsm8._expand_split_kernel``): xs uint8[K, lanes], states
    [K, lanes] each byte's pre-transition state, t_split uint8[256,
    2S+9(mt+1)] -> uint8[K, m+1, lanes]: row 0 = count | 16*invalid, rows
    1.. = symbol slots. Dead slots hold table values. The values are the
    TPU kernel's int32 rows; every one is below 256."""
    cols = t_split.shape[1]
    s = _split_width(t_split, mt)
    tbl = t_split.reshape(-1).long()
    base = xs.long() * cols
    st = states.long()
    fs = tbl[base + st]
    pv = tbl[base + s + st]
    p = pv & 15
    tc = tbl[base + 2 * s + p]
    inv = (pv >= 16) | (tc >= 16)
    row0 = torch.where(inv, 16, (p > 0).long() + (tc & 15))
    tail = [tbl[base + 2 * s + N_P * (1 + j) + p] for j in range(min(mt, m - 1))]
    return torch.stack([row0, fs, *tail], dim=1).to(torch.uint8)


def _require_expand(xs, states, table, name: str) -> None:
    _build.require(xs, torch.uint8, "xs")
    _build.require(states, torch.uint8, "states", xs.device)
    _build.require(table, torch.uint8, "table", xs.device)
    if states.shape != xs.shape or xs.numel() == 0 or table.shape[0] != 256:
        raise ValueError(f"{name}: xs {tuple(xs.shape)}, states {tuple(states.shape)}, "
                         f"table {tuple(table.shape)}")


@_build.counted
def expand_pass_split(xs: torch.Tensor, states: torch.Tensor, t_split: torch.Tensor,
                      m: int, mt: int) -> torch.Tensor:
    """Kernel 6 (replaces ``expand_pass_split_pallas8``); see
    :func:`expand_pass_split_plain`. The kernel writes rows of ``lanes``
    rounded up to 8 bytes (aligned 8-byte stores); the result is the
    ``[K, m+1, lanes]`` view, contiguous when ``lanes`` is a multiple of 8."""
    if xs.device.type == "cpu":
        return expand_pass_split_plain(xs, states, t_split, m, mt)
    k, lanes = xs.shape
    _require_expand(xs, states, t_split, "expand_pass_split")
    cols, s = t_split.shape[1], _split_width(t_split, mt)
    if s not in (128, 256) or cols != 2 * s + N_P * (mt + 1) or t_split.data_ptr() % 16:
        raise ValueError(f"expand_pass_split: bad split table {tuple(t_split.shape)}, mt={mt}")
    pitch = -(-lanes // 8) * 8
    out = torch.empty((k, m + 1, pitch), dtype=torch.uint8, device=xs.device)
    with torch.cuda.device(xs.device):
        rc = _expand_split_fn()(
            xs.data_ptr(), states.data_ptr(), t_split.data_ptr(), cols, s, m, mt,
            out.data_ptr(), k, lanes, pitch, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "et_expand_split_pass")
    _build.count_launch(expand_pass_split, out.device)
    return out[:, :, :lanes]


def expand_pass_plain(xs: torch.Tensor, states: torch.Tensor, t_exp: torch.Tensor,
                      m: int) -> torch.Tensor:
    """Full-table expansion (``pallas_fsm8._expand_kernel``): xs uint8[K,
    lanes], states [K, lanes], t_exp uint8[256, (m+1)S] ->
    uint8[K, m+1, lanes] with ``vals[k, j, lane] = t_exp[byte, j*S + state]``
    (the values of :func:`expand_pass_split_plain`'s rows). The values are
    the TPU kernel's int32 rows; every one is below 256."""
    s = t_exp.shape[1] // (m + 1)
    idx = xs.long() * t_exp.shape[1] + states.long()
    j = torch.arange(m + 1, device=xs.device) * s
    return t_exp.reshape(-1)[idx[:, None, :] + j[None, :, None]]


def expand_vector_table(t_exp: torch.Tensor, m: int) -> torch.Tensor:
    """The full table as the expansion kernel reads it: uint8[256, S, P],
    ``vec[x, st, j] = t_exp[x, j*S + st]`` for j <= m, P = m + 1 rounded up
    to 4, 8 or 16, so a byte's values are one aligned vector load. The pad
    bytes ``j > m`` are 0: the kernel loads them with the entry (and writes
    no row from them), so none may be left unwritten. One copy on
    ``t_exp``'s device, after a memset where there is a pad; the decode
    builds it once per table (``tables.ExpandTables.vec``)."""
    m1 = m + 1
    s = t_exp.shape[1] // m1
    p = 4 if m1 <= 4 else 8 if m1 <= 8 else 16
    alloc = torch.zeros if p > m1 else torch.empty
    vec = alloc((256, s, p), dtype=torch.uint8, device=t_exp.device)
    vec[:, :, :m1] = t_exp.view(256, m1, s).transpose(1, 2)
    return vec


@_build.counted
def expand_pass(xs: torch.Tensor, states: torch.Tensor, t_exp: torch.Tensor,
                m: int, vec: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 7 (replaces ``expand_pass_pallas8``); see
    :func:`expand_pass_plain`. The kernel reads ``vec``, the
    :func:`expand_vector_table` of ``t_exp`` (built here when None): staged
    in shared memory where it fits a block (128 KB at S = 128, m <= 3),
    else read through L2 (up to 1 MB at S = 256, m = 8). It writes rows of ``lanes`` rounded up to 8 bytes (aligned
    8-byte stores); the result is the ``[K, m+1, lanes]`` view, contiguous
    when ``lanes`` is a multiple of 8."""
    if xs.device.type == "cpu":
        return expand_pass_plain(xs, states, t_exp, m)
    k, lanes = xs.shape
    _require_expand(xs, states, t_exp, "expand_pass")
    s = t_exp.shape[1] // (m + 1)
    if not 1 <= m <= 8 or s not in (128, 256) or t_exp.shape[1] != (m + 1) * s:
        raise ValueError(f"expand_pass: bad expand table {tuple(t_exp.shape)}, m={m}")
    if vec is None:
        vec = expand_vector_table(t_exp, m)
    p = 4 if m < 4 else 8 if m < 8 else 16
    if vec.dtype != torch.uint8 or vec.device != xs.device or not vec.is_contiguous() \
            or tuple(vec.shape) != (256, s, p):
        raise ValueError(f"expand_pass: bad vector table {tuple(vec.shape)}, m={m}")
    pitch = -(-lanes // 8) * 8
    out = torch.empty((k, m + 1, pitch), dtype=torch.uint8, device=xs.device)
    with torch.cuda.device(xs.device):
        rc = _expand_fn()(
            xs.data_ptr(), states.data_ptr(), vec.data_ptr(), s, m, out.data_ptr(),
            k, lanes, pitch, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "et_expand_pass")
    _build.count_launch(expand_pass, out.device)
    return out[:, :, :lanes]


def fused_pass_plain(xs: torch.Tensor, t_fused: torch.Tensor,
                     entries: torch.Tensor, m: int, mt: int, s: int,
                     packed: bool = False, n_valid: int | None = None):
    """One one-pass decode sweep (the combine rule of
    ``pallas_fsm8._fused_kernel``): xs uint8[K, lanes], t_fused
    uint8[256, 2s+9(mt+2)], entries int32[lanes]. Returns (vals, exits
    int32[lanes]); vals is int32[K, m+1, lanes] (row 0 = count | 16*invalid,
    rows 1.. = symbol slots), or with ``packed`` (m <= 3) one int32 word per
    byte ``row0 << 8m | slot_j << 8(m-1-j)`` with row0 zeroed at lane-linear
    positions >= ``n_valid``. Dead slots hold table leftovers."""
    k, lanes = xs.shape
    cols = t_fused.shape[1]
    tbl = t_fused.reshape(-1).long()
    off_tc, off_end = 2 * s, 2 * s + N_P * (1 + mt)
    n_tail = min(mt, m - 1)
    dev = xs.device
    if packed:
        real = n_valid - torch.arange(lanes, device=dev, dtype=torch.int64) * k
        out = torch.empty((k, lanes), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((k, m + 1, lanes), dtype=torch.int32, device=dev)
    state = entries.long()
    for i, row in enumerate(xs.long()):
        base = row * cols
        mg = tbl[base + state]
        pv = tbl[base + s + state]
        p = pv & 15
        tcv = tbl[base + off_tc + p]
        inv = (pv >= 16) | ((p > 0) & (tcv >= 16))
        row0 = torch.where(inv, 16, (p > 0).long() + (tcv & 15))
        tail = [tbl[base + off_tc + N_P * (1 + j) + p] for j in range(n_tail)]
        if packed:
            word = torch.where(i < real, row0, 0) << (8 * m) | mg << (8 * (m - 1))
            for j, t in enumerate(tail):
                word = word | t << (8 * (m - 2 - j))
            out[i] = word.int()
        else:
            out[i] = torch.stack([row0, mg, *tail]).int()
        state = torch.where(p > 0, tbl[base + off_end + p], mg)
    return out, state.int()


def fused_chain_table(t_fused: torch.Tensor, s: int, mt: int) -> torch.Tensor:
    """The next state of the one-pass decode as a table of (byte, state)
    alone, as the fused kernel derives it in shared memory: uint8[256, s]
    with ``chain[x, state] = tail_end[x, p] if p > 0 else merged[x, state]``,
    ``p = pv[x, state] & 15`` (the columns of ``t_fused`` uint8[256,
    2s+9(mt+2)]). :func:`fused_pass_plain` computes the same state at each
    step, valid transition or not."""
    cols = t_fused.shape[1]
    tbl = t_fused.reshape(-1).long()
    base = torch.arange(256, device=t_fused.device)[:, None] * cols
    st = torch.arange(s, device=t_fused.device)[None, :]
    p = tbl[base + s + st] & 15
    nxt = torch.where(p > 0, tbl[base + 2 * s + N_P * (1 + mt) + p], tbl[base + st])
    return nxt.to(torch.uint8)


@_build.counted
def fused_pass(xs: torch.Tensor, t_fused: torch.Tensor, entries: torch.Tensor,
               m: int, mt: int, s: int, packed: bool = False,
               n_valid: int | None = None):
    """Kernel 2 (replaces ``fused_pass_pallas8``); see
    :func:`fused_pass_plain`. The kernel steps the state through
    :func:`fused_chain_table`, derived per block from ``t_fused``."""
    if packed and m > 3:
        raise ValueError(f"packed fused rows need 5 + 8m <= 29 bits (m={m})")
    if packed and n_valid is None:
        raise ValueError("packed fused rows are masked: pass n_valid")
    if xs.device.type == "cpu":
        return fused_pass_plain(xs, t_fused, entries, m, mt, s, packed, n_valid)
    k, lanes = xs.shape
    _build.require(xs, torch.uint8, "xs")
    _build.require(t_fused, torch.uint8, "t_fused", xs.device)
    _build.require(entries, torch.int32, "entries", xs.device)
    cols = t_fused.shape[1]
    if lanes == 0 or t_fused.shape[0] != 256 or cols != 2 * s + N_P * (mt + 2) \
            or s % 8 or not 8 <= s <= 256 or not 1 <= mt <= 7 or t_fused.data_ptr() % 16:
        raise ValueError("fused_pass: empty lanes or a bad fused table")
    shape = (k, lanes) if packed else (k, m + 1, lanes)
    out = torch.empty(shape, dtype=torch.int32, device=xs.device)
    exits = torch.empty(lanes, dtype=torch.int32, device=xs.device)
    with torch.cuda.device(xs.device):
        rc = _fused_fn()(
            xs.data_ptr(), t_fused.data_ptr(), cols, entries.data_ptr(),
            out.data_ptr(), exits.data_ptr(), k, lanes, m, mt, s,
            0 if n_valid is None else int(n_valid), int(packed),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "et_fused_pass")
    _build.count_launch(fused_pass, out.device)
    return out, exits
