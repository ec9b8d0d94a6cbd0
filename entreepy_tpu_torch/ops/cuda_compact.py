"""Stable row compaction: CUDA kernel on the card, plain PyTorch on the CPU.

Counterpart of ``entreepy_tpu/ops/pallas_compact.py``; the kernel is in
``csrc/compact.cu``. Callers: the encode plane compaction
(``ops/bitpack.compact_payload_plane``) and the m > 3 decode route
(``ops/decode8.compact_symbols_device``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _compact_fn():
    return _build.entry("et_compact_rows", [_P, _P, _P, _P, _I, _I, _I, _I, _P])


def _groups(wk: torch.Tensor, ek: torch.Tensor, sub: int, cap: int) -> int:
    k, lanes = wk.shape
    if ek.shape != wk.shape or sub <= 0 or k % sub or cap <= 0 or lanes == 0:
        raise ValueError(
            f"compact_rows: shapes {tuple(wk.shape)}/{tuple(ek.shape)}, "
            f"sub={sub}, cap={cap}"
        )
    return k // sub


def compact_rows_plain(wk: torch.Tensor, ek: torch.Tensor, sub: int, cap: int):
    """wk int32[k, lanes] values (k-major), ek bool[k, lanes] live flags ->
    (plane int32[(k//sub)*cap, lanes] — each subgroup's live values packed
    to its front in order, zeros after, the first ``cap`` kept — counts
    int32[k//sub, lanes] live values per subgroup, also beyond cap)."""
    g = _groups(wk, ek, sub, cap)
    lanes = wk.shape[1]
    e = ek.reshape(g, sub, lanes)
    pos = e.long().cumsum(1) - 1
    keep = e & (pos < cap)
    out = torch.zeros((g, cap + 1, lanes), dtype=wk.dtype, device=wk.device)
    # every dropped value lands in the extra slot `cap`, which is cut off
    out.scatter_(1, torch.where(keep, pos, cap),
                 torch.where(keep, wk.reshape(g, sub, lanes), 0))
    return out[:, :cap].reshape(g * cap, lanes), e.sum(1, dtype=torch.int32)


@_build.counted
def compact_rows(wk: torch.Tensor, ek: torch.Tensor, sub: int, cap: int):
    """Kernel 4 (replaces ``compact_rows_pallas``); see
    :func:`compact_rows_plain`."""
    if wk.device.type == "cpu":
        return compact_rows_plain(wk, ek, sub, cap)
    g = _groups(wk, ek, sub, cap)
    lanes = wk.shape[1]
    _build.require(wk, torch.int32, "wk")
    _build.require(ek, torch.bool, "ek", wk.device)
    plane = torch.empty((g * cap, lanes), dtype=torch.int32, device=wk.device)
    counts = torch.empty((g, lanes), dtype=torch.int32, device=wk.device)
    with torch.cuda.device(wk.device):
        rc = _compact_fn()(
            wk.data_ptr(), ek.data_ptr(), plane.data_ptr(), counts.data_ptr(),
            lanes, g, sub, cap, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(rc, "et_compact_rows")
    _build.count_launch(compact_rows, plane.device)
    return plane, counts
