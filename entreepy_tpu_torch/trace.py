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
(``parallel.dist`` records each rank's stages where its caller records).

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

from .utils.trace import phase as _env_phase

_local = threading.local()  # .stages: this thread's {stage: ms}, or absent


def _sync() -> None:
    """Wait for this thread's current card (set by ``torch.cuda.set_device``
    in a rank's thread)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def current() -> dict[str, float] | None:
    """This thread's record (the dict :func:`record_stages` yielded), or
    None outside one."""
    return getattr(_local, "stages", None)


@contextlib.contextmanager
def phase(name: str, nbytes: int | None = None):
    """One pipeline stage (see the module docstring)."""
    stages = current()
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
def record_stages():
    """Yield a dict that collects ``{stage: ms}`` over the calls this thread
    makes inside the block, each stage synchronized with the device at its
    end."""
    _sync()
    _local.stages = {}
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
