"""Stage timing of the port's compress and decompress pipelines.

Every stage of ``ops.encode.compress_device`` and
``ops.decode8.decompress_device`` runs inside :func:`phase`. Normally that is
``utils.trace.phase``: one stderr line per stage when
``ENTREEPY_TRACE=1``, otherwise nothing. Inside :func:`record_stages` each
stage instead starts and ends with a device synchronize and adds its
host-clock time to a dict, so asynchronous device work is charged to the
stage that queued it, also where one stage runs inside another (the
sharded decode's ``allgather_exits`` inside ``device_fsm8_decode``; the
outer stage's time includes the inner one's). That costs two
``torch.cuda.synchronize()`` per stage, a few dozen per call, and is off
unless a caller asks for it. A recording belongs to the thread that asked
for it, and a stage synchronizes only that thread's current card: the
ranks of a local mesh each run in a thread of their own, on their own card
(``parallel.dist`` records each rank's stages where its caller records,
and hands its caller each stage's slowest rank and each count summed over
the ranks).

While ``torch.profiler`` records, each stage is also a range
``entreepy.<stage>`` on the profiler's clock, and :func:`call` a range
``entreepy.compress`` / ``entreepy.decompress`` around a whole API call, so a
trace names the stage the host was in at any instant; nested stages nest
their ranges, in whatever thread runs them (a local mesh's rank threads show
in a profiler of every thread, ``_ExperimentalConfig(profile_all_threads=
True)``). Inside a record a stage's range
holds its two synchronizes. With the profiler off, a stage or a call costs
one flag check more than it would without ranges.

A record also counts (:func:`count`, ``.counts`` of the dict
:func:`record_stages` yields), at the boundary where the work happens:

* ``h2d_bytes``: host arrays moved to the device (bodies, documents, tables);
* ``d2h_bytes``: device tensors moved back (a decode's symbols and their
  per-lane metadata, states, payloads, the encode's stitched body bytes,
  histograms). Scalar readbacks of a
  few bytes (``int()``, ``bool()``: a sizing maximum or total, the fixed
  point's test) are left out, and so are a process group's staging copies
  inside its collectives;
* ``plane_slots`` / ``symbols``: the slots a device decode route's symbols
  come from (K·m·lanes of packed words, or the compacted plane's slots),
  and the symbols the symbols kernel wrote and the host fetched;
* ``plane_compactions``: planes compacted by the plane route
  (``ops.decode8.plane_symbols``: the one-pass route at m > 3, one a tile,
  and the two-pass routes); 0 on the packed one-pass route (m <= 3);
* ``fsm_builds``: decode tables built from a code table (the stage
  ``fsm_build``): a byte automaton on the host, each a miss of
  ``build_byte_fsm``'s cache, or the one-pass tables on a CUDA device;
* ``fsm_device_builds``: those of ``fsm_builds`` built on the device, one
  launch of ``ops/cuda_tables``' kernel each (the one-pass route on a CUDA
  device, ``tables.card_decode_tables``; a local mesh counts one a rank), so
  ``fsm_device_builds / fsm_builds`` is the share of builds on the card;
* ``device_stitches``: the single-device encode's tiles stitched on the
  device (the stage ``device_stitch``, one launch of ``ops/cuda_stitch``'s
  kernel a tile);
* ``mesh_exchanges`` / ``p2p_bytes``: a sharded rank's exchanges with the
  other ranks, and the bytes of their tensors it took in them (counted only
  where something is exchanged; ``parallel.dist``).

The plane route's compaction is the stage ``plane_compact``: the real-byte
mask, the cap's readback and the compaction kernel with its int32 copy of
the slots, nested in ``device_expand`` (the symbols kernel's write launch
stays outside it), so that no other stage changes its definition.

The sharded backend's exchanges are also stages, ``mesh_wait`` (a rank
waiting for the others) and ``mesh_copy`` (taking their tensors onto its
device), nested in the stage that calls the collective (``allgather_exits``
once per pass, the encode's ``device_histogram``), so that no other stage
changes its definition; ``parallel.dist``'s docstring has their bounds.

The sites count whatever the device, so a CPU run counts the bytes the
pipeline hands across as the card's would; outside a record a count does
nothing.

:func:`maybe_profile` is the ``torch.profiler`` twin of the JAX package's:
with ``ENTREEPY_PROFILE=<dir>`` it traces the block (host, and the card's
kernels and copies when there is one) and writes a Chrome/TensorBoard
trace into ``<dir>``; otherwise it does nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from .utils.trace import phase as _env_phase

_local = threading.local()  # .stages: this thread's Record, or absent


class Record(dict):
    """What :func:`record_stages` yields: ``{stage: ms}`` items, and
    ``counts``, ``{name: number}`` of :func:`count`."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}


def _sync() -> None:
    """Wait for this thread's current card (set by ``torch.cuda.set_device``
    in a rank's thread)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def current() -> Record | None:
    """This thread's record (the dict :func:`record_stages` yielded), or
    None outside one."""
    return getattr(_local, "stages", None)


def _stage(name: str, nbytes: int | None, stages: Record | None):
    """The body of :func:`phase`: outside a record the stderr line, else the
    stage timed between two synchronizes into ``stages``."""
    if stages is None:
        with _env_phase(name, nbytes):
            yield
        return
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def phase(name: str, nbytes: int | None = None):
    """One pipeline stage (see the module docstring)."""
    if _autograd_profiler._is_profiler_enabled:
        with torch.profiler.record_function(f"entreepy.{name}"):
            yield from _stage(name, nbytes, current())
    else:
        yield from _stage(name, nbytes, current())


@contextlib.contextmanager
def call(name: str):
    """A whole API call: the range ``entreepy.<name>`` while the profiler
    records, else nothing. It adds no stage to a record."""
    if _autograd_profiler._is_profiler_enabled:
        with torch.profiler.record_function(f"entreepy.{name}"):
            yield
    else:
        yield


def count(name: str, n: int) -> None:
    """Add ``n`` to the count ``name`` of this thread's record; nothing
    outside one."""
    rec = current()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


@contextlib.contextmanager
def record_stages():
    """Yield a :class:`Record` that collects ``{stage: ms}`` and the counts
    over the calls this thread makes inside the block, each stage
    synchronized with the device at its end."""
    _sync()
    _local.stages = Record()
    try:
        yield _local.stages
    finally:
        _local.stages = None


@contextlib.contextmanager
def maybe_profile():
    """torch.profiler trace around the block when ENTREEPY_PROFILE=<dir> is
    set (one ``*.pt.trace.json`` per block). Yields the profiler, whose
    ``key_averages()`` hold the block's events once it ends, or None."""
    out = os.environ.get("ENTREEPY_PROFILE")
    if not out:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(out)) as prof:
        yield prof
