"""The sharded codec's one parallel axis: the ranks of a mesh.

A Huffman codec has one meaningful parallel axis: independent input blocks
on encode, independent chunks (lanes) on decode. The JAX package lays it
over a 1-D device mesh (``make_mesh(n_devices)`` over ``jax.devices()``).
Here a mesh is one of two kinds, in rank order, one device per rank:

* a **local mesh**: one process, one rank per device it is given (all the
  cards it sees by default), each rank run in a host thread of its own by
  ``dist``; the counterpart of the JAX package's single-process mesh;
* a **process group's** mesh: the ranks of a ``torch.distributed`` group,
  this process being one of them, on one device.

A mesh of one rank is the second kind, with or without a group. Several
processes each driving several cards (the JAX package's multi-host mesh
over every process's devices) is not ported: :func:`make_mesh` raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..api import resolve_device


@dataclass(frozen=True)
class Mesh:
    """``world`` ranks, this view being ``rank``, which drives ``device``.

    ``group``: the process group of a group's mesh (None: one rank, or a
    local mesh). ``devices``: a local mesh's devices in rank order, ``()``
    for the other kind. ``meet``: set only on the per-rank views that
    ``dist`` makes of a local mesh, where their collectives meet."""

    group: dist.ProcessGroup | None
    rank: int
    world: int
    device: torch.device
    devices: tuple[torch.device, ...] = ()
    meet: object = field(default=None, compare=False, repr=False)

    @property
    def local(self) -> bool:
        """A local mesh: several ranks in this one process."""
        return bool(self.devices)


def make_mesh(n_devices: int | None = None, *, devices=None,
              group: dist.ProcessGroup | None = None, device=None) -> Mesh:
    """The mesh of this process.

    ``group``: the given process group, else the default group once
    ``torch.distributed`` is initialized, else none. A mesh over a subset of
    the ranks is a group the caller makes with ``torch.distributed.new_group``.

    In a group of more than one rank, one card per rank: ``device`` or
    ``cuda:<rank % torch.cuda.device_count()>``, as ``torchrun
    --nproc-per-node`` lays them out. Asking such a process for more than
    one device (``n_devices`` or ``devices``) raises ValueError: several
    processes of several cards each are not ported.

    Otherwise a local mesh: ``devices`` (in rank order; one device may
    repeat, so ``["cuda:0", "cuda:0"]`` is two ranks on one card, and
    ``["cpu"] * n`` runs the kernels' plain versions), else the first
    ``n_devices`` cards of the process, all of them by default. ``device``
    alone is one rank on that device. A local mesh of one device is a mesh
    of one rank. Without a CUDA device, a mesh on cards raises
    :class:`~entreepy_tpu_torch.api.NoCudaDeviceError`."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    rank, world = (0, 1) if group is None else (dist.get_rank(group),
                                                 dist.get_world_size(group))
    if device is not None and (devices is not None or n_devices is not None):
        raise ValueError("make_mesh: pass device (one rank), or n_devices or devices")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"make_mesh: n_devices={n_devices}, want at least 1")
    if device is None and devices is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > 1:
            if n_devices not in (None, 1):
                _hybrid(world, n_devices)
            device = f"cuda:{rank % cards}" if cards else None
        elif cards:
            n = cards if n_devices is None else n_devices
            if n > cards:
                raise ValueError(f"asked for {n} devices, have {cards}")
            devices = [f"cuda:{i}" for i in range(n)]
    if devices is not None:
        devs = tuple(resolve_device(d, backend="sharded") for d in devices)
        if not devs:
            raise ValueError("make_mesh: an empty device list")
        if world > 1 and len(devs) > 1:
            _hybrid(world, len(devs))
        if len(devs) > 1:
            return Mesh(None, 0, len(devs), devs[0], devs)
        device = devs[0]
    return Mesh(group, rank, world, resolve_device(device, backend="sharded"))


def _hybrid(world: int, n: int) -> None:
    raise ValueError(
        f"make_mesh: a process group of {world} ranks, and {n} devices asked of this "
        "process: a mesh of several processes with several devices each is not ported "
        "(one card per rank in a group; a local mesh in one process)")
