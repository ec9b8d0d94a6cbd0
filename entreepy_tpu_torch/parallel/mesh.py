"""The ranks of a process group as the sharded codec's one parallel axis.

A Huffman codec has one meaningful parallel axis: independent input blocks
on encode, independent chunks (lanes) on decode. The JAX package lays it
over a 1-D device mesh; here it is the ranks of a ``torch.distributed``
process group, in rank order, one device per rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..api import resolve_device


@dataclass(frozen=True)
class Mesh:
    """``world`` ranks of ``group`` (None: one rank, no group), this
    process being ``rank``, which drives ``device``."""

    group: dist.ProcessGroup | None
    rank: int
    world: int
    device: torch.device


def make_mesh(*, group: dist.ProcessGroup | None = None, device=None) -> Mesh:
    """The mesh of this process.

    ``group``: the given process group, else the default group once
    ``torch.distributed`` is initialized, else one rank and no group. A mesh
    over a subset of the ranks is a group the caller makes with
    ``torch.distributed.new_group``.

    ``device``: the given one (``"cpu"`` runs the kernels' plain versions),
    else ``cuda:<rank % torch.cuda.device_count()>``, one card per rank as
    ``torchrun --nproc-per-node`` lays them out. Without a CUDA device that
    raises :class:`~entreepy_tpu_torch.api.NoCudaDeviceError`."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    rank, world = (0, 1) if group is None else (dist.get_rank(group),
                                                 dist.get_world_size(group))
    if device is None and torch.cuda.is_available():
        device = f"cuda:{rank % torch.cuda.device_count()}"
    return Mesh(group, rank, world, resolve_device(device, backend="sharded"))
