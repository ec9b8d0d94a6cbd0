"""Multi-process execution over ``torch.distributed``.

Counterpart of ``entreepy_tpu/parallel/multihost.py``. The same sharded
codec (``dist``) runs over the ranks of the default process group, one
device per rank: NCCL between cards (``cuda:<rank % cards>``, the card
:func:`init` binds the process to), gloo between processes on the host.
One process that drives several cards needs no group: it is a local mesh
(``make_mesh()``, ``compress_sharded(data)``).

Communication per file:

* encode: one all-reduce of the 256-bin histogram (2 KB); each rank
  compacts its blocks' words on its device, so only each rank's
  ~compressed-size flat payload and per-block word counts and bit lengths
  are gathered, never the dense per-input-byte slots;
* decode: one all-gather of the exit states (4 B per chunk) per sync pass;
  each rank expands only its own chunks and the output is joined from one
  gather of per-chunk metadata and one of the ranks' symbols (on the
  ``host`` route each rank fetches only its own states, 1/world of the
  body).

Usage (one process per card, e.g. ``torchrun --nproc-per-node 8``)::

    import entreepy_tpu_torch.parallel.multihost as mh
    mh.init()                       # torch.distributed.init_process_group()
    et = mh.compress(data)          # every rank passes the same bytes
    out = mh.decompress(et)         # the same result on every rank
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .dist import compress_sharded, decompress_sharded
from .mesh import Mesh, make_mesh

# torchrun's variables: with none of them and no arguments, init() is a
# single-process run
TORCHRUN_VARS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def init(**kwargs) -> None:
    """Bring up the default process group, once per process. ``kwargs`` pass
    to ``torch.distributed.init_process_group`` (backend, init_method,
    world_size, rank, ...); the default backend is torch's own
    (``cpu:gloo,cuda:nccl``).

    Once the group runs NCCL for CUDA tensors, the process is bound to its
    card, ``cuda:<rank % cards>`` (``torch.cuda.set_device``), before any
    collective: NCCL's communicator and ``barrier`` take the current card.
    Nothing runs gloo in NCCL's place: where NCCL cannot start, its error
    propagates.

    Failure semantics: with explicit arguments every error propagates. With
    none, torchrun's variables bring the group up (and their errors
    propagate); with none of them set the run is a single process: no
    group, no error."""
    if dist.is_initialized():
        return
    if not kwargs and not any(v in os.environ for v in TORCHRUN_VARS):
        return
    dist.init_process_group(**kwargs)
    config = dict(item.split(":") for item in dist.get_backend_config().split(","))
    if config.get("cuda") == "nccl" and torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def global_mesh(device=None) -> Mesh:
    """The mesh of every rank of the default group (one rank without one)."""
    return make_mesh(device=device)


def compress(data: bytes, *, device=None, **kwargs) -> bytes:
    """Compress over the global mesh. Every rank must pass identical
    ``data`` and receives the identical .et result."""
    return compress_sharded(data, global_mesh(device), **kwargs)


def decompress(et: bytes, *, device=None, **kwargs) -> bytes:
    """Decompress over the global mesh; the same SPMD contract as compress."""
    return decompress_sharded(et, global_mesh(device), **kwargs)
