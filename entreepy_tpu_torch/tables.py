"""The codec's lookup tables as device tensors.

The JAX package builds every table in numpy (``entreepy_tpu.format``); this
module only carries them onto a device, as plain integers. Two JAX forms do
not come across: the bf16 cast (an MXU one-hot contraction is exact only for
values <= 255 in bf16) and the int8 value-128 form (the v5e int8 MXU rate).
Likewise the 5-column limb table ``code_table_cols`` existed only to keep bf16
matmuls exact; the pack kernel takes ``codes`` and ``lengths`` directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from entreepy_tpu.format.etformat import parse_header
from entreepy_tpu.format.fsm8 import ByteFsm, build_byte_fsm, fused_decode_tensors
from entreepy_tpu.format.huffman import CodeTable


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


def decode_tables(fsm: ByteFsm, device) -> DecodeTables:
    t, m, mt, s = fused_decode_tensors(fsm)
    return DecodeTables(
        next_state=torch.from_numpy(np.ascontiguousarray(fsm.next_state)).to(device),
        fused=torch.from_numpy(t.astype(np.uint8)).to(device),
        m=m,
        mt=mt,
        s=s,
    )


def code_tensors(table: CodeTable, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes uint32[256] right-aligned, lengths uint8[256]) on ``device``."""
    codes = torch.from_numpy(table.codes.astype(np.uint32)).to(device)
    lengths = torch.from_numpy(table.lengths.astype(np.uint8)).to(device)
    return codes, lengths


def decode_tables_for(et: bytes, device) -> tuple[DecodeTables, np.ndarray]:
    """(decode tables on ``device``, packed body uint8[n_body] on the host)
    of a complete .et file."""
    hdr = parse_header(et)
    body = np.frombuffer(et, dtype=np.uint8)[hdr.body_start:]
    return decode_tables(build_byte_fsm(hdr.table), device), body


def code_tensors_for(et: bytes, device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`code_tensors` of a complete .et file's code table."""
    return code_tensors(parse_header(et).table, device)
