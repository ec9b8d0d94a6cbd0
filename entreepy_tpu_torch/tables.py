"""The codec's lookup tables as device tensors.

The port builds its tables in numpy (``format``, its copy of the JAX
package's ``entreepy_tpu.format``), except the one-pass decode's tables on a
CUDA device, which the tables kernel builds there from the code trie
(:func:`card_decode_tables`). This module carries the rest onto a
device, as plain integers, through :func:`to_device`, which every upload of
the pipelines goes through, as every fetch but the decode plane's
asynchronous one goes through :func:`fetch`, or :func:`fetch_into` where the
host buffer is given: they count the bytes they move (``trace.count``). Two JAX forms do
not come across: the bf16 cast (an MXU one-hot contraction is exact only for
values <= 255 in bf16) and the int8 value-128 form (the v5e int8 MXU rate).
Likewise the 5-column limb table ``code_table_cols`` existed only to keep bf16
matmuls exact; the pack kernel takes ``codes`` and ``lengths`` directly.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from .format.etformat import parse_header
from .format.fsm8 import (
    ByteFsm,
    _build_trie,
    build_byte_fsm,
    expand_tensors,
    fused_decode_tensors,
    split_expand_tensors,
)
from .format.huffman import CodeTable
from .ops.cuda_fsm8 import expand_vector_table
from .ops.cuda_tables import fsm_tables, pack_trie, trie_layout
from .trace import count, phase


@dataclass(frozen=True)
class DecodeTables:
    """Tables of the one-pass decode (see ``format.fsm8``).

    next_state  uint8[S, 256]           state after a byte (``ByteFsm.next_state``)
    fused       uint8[256, 2s+9(mt+2)]  ``fused_decode_tensors``, one row per byte
    m, mt, s    max symbols per byte, tail slots, padded live-state count
    """

    next_state: torch.Tensor
    fused: torch.Tensor
    m: int
    mt: int
    s: int


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device``, its bytes counted as
    ``h2d_bytes``: every upload of the pipelines, tables, bodies and
    documents alike. A read-only source (bytes) is fine: the tensor is only
    read."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        t = torch.from_numpy(arr)
    count("h2d_bytes", arr.nbytes)
    return t.to(device)


def fetch(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Device tensors -> numpy arrays on the host, their bytes counted as
    ``d2h_bytes``."""
    out = [t.cpu().numpy() for t in tensors]
    count("d2h_bytes", sum(a.nbytes for a in out))
    return out


def fetch_into(host: torch.Tensor, t: torch.Tensor) -> None:
    """Copy device tensor ``t`` into ``host``, a host tensor of its size
    (the encode's slice of its output buffer), its bytes counted as
    ``d2h_bytes``."""
    host.copy_(t)
    count("d2h_bytes", t.numel() * t.element_size())


def next_state_tensor(fsm: ByteFsm, device) -> torch.Tensor:
    """``fsm.next_state`` uint8[S, 256] on ``device``."""
    return to_device(np.ascontiguousarray(fsm.next_state), device)


def decode_tables(fsm: ByteFsm, device) -> DecodeTables:
    t, m, mt, s = fused_decode_tensors(fsm)
    return DecodeTables(
        next_state=next_state_tensor(fsm, device),
        fused=to_device(t.astype(np.uint8), device),
        m=m,
        mt=mt,
        s=s,
    )


def builds_on_card(device, expand: str) -> bool:
    """Whether the ``expand`` route's tables on ``device`` are built there
    by the tables kernel (:func:`card_decode_tables`): the one-pass route on
    a CUDA device. Every other route and device builds a ``ByteFsm`` on the
    host."""
    return expand == "onepass" and torch.device(device).type == "cuda"


@dataclass(frozen=True)
class CodeTrie:
    """What the host builds of the one-pass tables that the card builds:
    the code trie packed as the tables kernel takes it (``edges``
    uint16[2 * nodes], ``ops/cuda_tables.pack_trie``) and the tables' layout
    (``trie_layout``: S, m, mt, s)."""

    edges: np.ndarray
    width: int
    m: int
    mt: int
    s: int


def code_trie(table: CodeTable) -> CodeTrie:
    """``table``'s :class:`CodeTrie` (stage ``fsm_build``): its trie
    (``fsm8._build_trie``), packed, and the layout DP; well under a
    millisecond of host time."""
    with phase("fsm_build"):
        children, leaf_sym = _build_trie(table)
        return CodeTrie(pack_trie(children, leaf_sym), *trie_layout(children, leaf_sym))


def card_decode_tables(trie: CodeTrie, device) -> DecodeTables:
    """:func:`decode_tables` of ``build_byte_fsm(table)``, built on the CUDA
    ``device`` from ``code_trie(table)`` by one launch of the tables kernel
    (``ops/cuda_tables``): no ``ByteFsm``, no upload, no cache. The stage
    ``fsm_build``, one ``fsm_builds`` and one ``fsm_device_builds`` count."""
    with phase("fsm_build"):
        next_state, fused = fsm_tables(trie.edges, trie.width, trie.s, trie.mt, device)
    count("fsm_builds", 1)
    count("fsm_device_builds", 1)
    return DecodeTables(next_state=next_state, fused=fused, m=trie.m, mt=trie.mt, s=trie.s)


@dataclass(frozen=True)
class ExpandTables:
    """Tables of the two-pass decode (see ``format.fsm8``): the state pass
    needs ``next_state``, the expansion one expand table.

    next_state  uint8[S, 256]                 state after a byte
    table       uint8[256, 2S + 9(mt+1)]      ``split_expand_tensors``, or
                uint8[256, (m+1)S]            ``expand_tensors`` (mt is None)
    m, mt, s    max symbols per byte, tail slots, S = ``fsm.width`` (128 or
                256) — not the one-pass table's padded live-state count
    vec         uint8[256, S, P]              the full table as the CUDA
                expansion reads it (``cuda_fsm8.expand_vector_table``),
                built once here; None for the split table or off the card
    """

    next_state: torch.Tensor
    table: torch.Tensor
    m: int
    mt: int | None
    s: int
    vec: torch.Tensor | None = None


def expand_tables(fsm: ByteFsm, device, split: bool) -> ExpandTables:
    """The two-pass tables, with the split expand table or the full one
    (``build_expand`` of the JAX package, the mode passed explicitly). The
    one-pass fused table is not built."""
    if split:
        t, m, mt = split_expand_tensors(fsm)
    else:
        (t, m), mt = expand_tensors(fsm), None
    table = to_device(t.astype(np.uint8), device)
    vec = None
    if not split and table.device.type == "cuda":
        vec = expand_vector_table(table, m)
    return ExpandTables(
        next_state=next_state_tensor(fsm, device),
        table=table,
        m=m,
        mt=mt,
        s=fsm.width,
        vec=vec,
    )


def code_tensors(table: CodeTable, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes uint32[256] right-aligned, lengths uint8[256]) on ``device``."""
    codes = to_device(table.codes.astype(np.uint32), device)
    lengths = to_device(table.lengths.astype(np.uint8), device)
    return codes, lengths


def body_for(et: bytes) -> tuple[CodeTable, int, np.ndarray]:
    """(code table, symbol count, packed body uint8[n_body] on the host) of a
    complete .et file: the arguments of the decode drivers."""
    hdr = parse_header(et)
    return hdr.table, hdr.body_len, np.frombuffer(et, dtype=np.uint8)[hdr.body_start:]


def _fsm_and_body(et: bytes) -> tuple[ByteFsm, np.ndarray]:
    table, _, body = body_for(et)
    return build_byte_fsm(table), body


def decode_tables_for(et: bytes, device) -> tuple[DecodeTables, np.ndarray]:
    """(decode tables on ``device``, packed body uint8[n_body] on the host)
    of a complete .et file."""
    fsm, body = _fsm_and_body(et)
    return decode_tables(fsm, device), body


def expand_tables_for(et: bytes, device, split: bool) -> tuple[ExpandTables, np.ndarray]:
    """(two-pass tables on ``device``, packed body uint8[n_body] on the
    host) of a complete .et file."""
    fsm, body = _fsm_and_body(et)
    return expand_tables(fsm, device, split), body


def code_tensors_for(et: bytes, device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`code_tensors` of a complete .et file's code table."""
    return code_tensors(parse_header(et).table, device)
