"""Per-phase timing lines of the host codec.

``ENTREEPY_TRACE=1`` makes every :func:`phase` print one structured line to
stderr, ``[entreepy-tpu] phase=<name> ms=<t> [MBps=<rate>]`` (the JAX
package's format, so one log reader serves both). Overhead is a single flag
check when disabled. The device pipelines time their stages through
``entreepy_tpu_torch.trace``, which falls back to this.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

_ENABLED = os.environ.get("ENTREEPY_TRACE", "") not in ("", "0")


@contextlib.contextmanager
def phase(name: str, nbytes: int | None = None):
    """Time a pipeline phase; emits a structured line when tracing is on."""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        rate = f" MBps={nbytes / dt / 1e6:.1f}" if nbytes and dt > 0 else ""
        print(f"[entreepy-tpu] phase={name} ms={dt * 1e3:.2f}{rate}", file=sys.stderr)
