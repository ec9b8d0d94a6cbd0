"""Top-level bytes-in/bytes-out API of the PyTorch port.

Backends with byte-identical output:

* ``device`` — the port's kernels on a CUDA device (``device="cuda"``
  unless one is passed). ``device="cpu"`` runs the kernels' plain PyTorch
  versions instead. Passing ``device`` selects this backend when
  ``backend`` is None, and is a ValueError with ``host``. Without a CUDA device and without an explicit
  ``device``, the call raises :class:`NoCudaDeviceError`: nothing falls back
  to the CPU. ``decompress``'s ``expand`` picks the decode route on the
  device (see ``ops.decode8``): "onepass" (default), the two-pass "split"
  and "fused", or "host" (device state passes, host expansion).
* ``sharded`` — the same kernels over the ranks of a mesh, one device per
  rank (``entreepy_tpu_torch.parallel``): blocks and chunks split over the
  ranks, whose collectives join them. In a ``torch.distributed`` process
  group of more than one rank, this process is one rank on one card, and
  every rank makes the same call and gets the same result. Otherwise one
  process drives every card it sees, one rank per card, each in a thread
  of its own (a local mesh; one card is one rank). ``device`` makes it one
  rank on that device; ``expand`` as for ``device``. Without a CUDA device
  and without ``device="cpu"`` it raises :class:`NoCudaDeviceError`.
* ``host`` — the host codec (``format.compress_host`` /
  ``decompress_host``, the port's copy of the JAX package's, with its C++
  runtime in ``runtime``).
* ``None`` (the default) — auto, the JAX package's rule: the native host
  runtime below ``POD_DEVICE_MIN`` bytes; at or above it the device backend
  when a one-shot host-to-device probe (cached per process, 60 s deadline)
  beats ``H2D_MIN_BYTES_PER_S``, else host. Without a CUDA device the probe
  is False, so auto runs on the host. ``ENTREEPY_DEVICE_MIN=<bytes>``
  replaces the threshold at call time. At or above it, where the JAX
  package picks ``sharded`` (more than one device), so does the port: in
  an initialized process group of more than one rank, or in a process
  that sees more than one card (``torch.cuda.device_count() > 1``).
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from pathlib import Path

import torch
import torch.distributed as dist

from . import runtime, trace
from .format import compress_host, decompress_host, parse_header

DEVICE_MIN_BYTES = 1 << 16
# Auto-routing floor when the native host runtime exists: calls below it are
# dominated by transfer and launch overhead the host codec does not pay.
POD_DEVICE_MIN = 8 << 20
# A host-to-device link must beat this for auto to route to the device.
H2D_MIN_BYTES_PER_S = 100e6

_h2d_fast_cache: list = []  # [bool], measured once per process


class NoCudaDeviceError(RuntimeError):
    """The device backend was asked for ``cuda`` and no CUDA device exists."""


def _h2d_probe() -> bool:
    """Time a 1 MiB host-to-device copy with a value-dependent readback,
    the fastest of three: a stall of the host's thread is not the link's.
    True only on a CUDA device whose link beats H2D_MIN_BYTES_PER_S."""
    if not torch.cuda.is_available():
        return False
    arr = torch.ones(1 << 18, dtype=torch.float32)  # 1 MiB
    int(arr.to("cuda").sum())  # warm the context and the copy path
    dt = float("inf")
    for i in range(1, 4):
        t0 = time.perf_counter()
        int((arr + i).to("cuda").sum())
        dt = min(dt, time.perf_counter() - t0)
    return arr.numel() * arr.element_size() / max(dt, 1e-9) >= H2D_MIN_BYTES_PER_S


def _h2d_fast(deadline_s: float = 60.0) -> bool:
    """One-shot host-to-device bandwidth probe, cached per process, run in
    a daemon thread with a deadline: a device that hangs at initialization
    must leave auto routing on the host, not block the call."""
    if not _h2d_fast_cache:
        result = [False]

        def probe():
            try:
                result[0] = _h2d_probe()
            except Exception as e:  # a broken device link routes to host
                warnings.warn(f"host-to-device probe failed ({e!r}); auto routes to host",
                              stacklevel=2)

        t = threading.Thread(target=probe, daemon=True)
        t.start()
        t.join(timeout=deadline_s)
        _h2d_fast_cache.append(result[0])
    return _h2d_fast_cache[0]


def _device_min(n_bytes: int = 0) -> int:
    env = os.environ.get("ENTREEPY_DEVICE_MIN")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            warnings.warn(
                f"ignoring non-integer ENTREEPY_DEVICE_MIN={env!r} (want bytes)",
                stacklevel=2,
            )
    if not runtime.available():
        return DEVICE_MIN_BYTES
    if n_bytes < POD_DEVICE_MIN:
        return 1 << 62  # the host wins below it: no probe for small calls
    return POD_DEVICE_MIN if _h2d_fast() else 1 << 62


def _pick_backend(backend: str | None, n_bytes: int) -> str:
    """"host", "device" or "sharded" for a call of ``n_bytes`` (see the
    module docstring). Auto picks a device backend only when a CUDA device
    exists, and ``sharded`` where there is more than one device: the ranks
    of a group, or the cards of this process."""
    if backend in ("device", "host", "sharded"):
        return backend
    if backend is not None:
        raise ValueError(
            f"unknown backend {backend!r} (want None, 'host', 'device', 'sharded')"
        )
    if n_bytes < _device_min(n_bytes) or not torch.cuda.is_available():
        return "host"
    group = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    return "sharded" if group or torch.cuda.device_count() > 1 else "device"


def _call_backend(backend: str | None, device, n_bytes: int) -> str:
    """The backend of a call: an explicit ``device`` is the device
    backend's device, so under auto it selects that backend, and with
    ``backend="host"`` it is an error (never silently dropped)."""
    if device is not None:
        if backend == "host":
            raise ValueError(f"device={device!r} is for backend='device'; "
                             "backend='host' runs no device")
        backend = backend or "device"
    return _pick_backend(backend, n_bytes)


def resolve_device(device=None, backend: str = "device") -> torch.device:
    """The device ``backend`` runs on: ``cuda`` by default, or the one
    given. Raises when it is a CUDA device and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            f"backend={backend!r} needs a CUDA device and torch.cuda.is_available() "
            "is False; pass device='cpu' to run the kernels' plain PyTorch "
            "versions, or backend='host'"
        )
    return dev


def compress(data: bytes, *, strict: bool = True, backend: str | None = None,
             device=None, progress=None) -> bytes:
    """Compress ``data`` into a complete .et file (magic, dict, packed body).

    backend: None (auto), "device", "sharded" or "host"; device: the torch
    device of a device backend (default ``cuda``; for ``sharded``, one rank
    on it, else every card of this process or, in a group, this rank's
    card; passing one alone selects ``device``). progress: optional
    ``(pct, msg)`` callback.
    """
    with trace.call("compress"):
        choice = _call_backend(backend, device, len(data))
        if choice == "host":
            return compress_host(data, strict=strict, progress=progress)
        tick = progress or (lambda pct, msg: None)
        if choice == "sharded":
            from .parallel import compress_sharded, make_mesh

            mesh = make_mesh(device=device)
            tick(20, "Counting characters...")
            out = compress_sharded(data, mesh, strict=strict)
        else:
            from .ops.encode import compress_device

            dev = resolve_device(device)
            tick(20, "Counting characters...")
            out = compress_device(data, device=dev, strict=strict)
        tick(90, "Writing compressed text...")
        return out


def decompress(et: bytes, *, backend: str | None = None, device=None,
               expand: str = "onepass", progress=None) -> bytes:
    """Decompress a complete .et file back to the original bytes.

    backend: None (auto), "device", "sharded" or "host"; device: as in
    :func:`compress`. expand: the device backends' decode route —
    "onepass" (default), "split" or "fused" (two-pass, split or full expand
    table; the JAX package's ENTREEPY_EXPAND), or "host" (two-pass, states
    expanded on the host; its ENTREEPY_DEVICE_E2E=0). Any other value
    raises ValueError.
    """
    from .ops.decode8 import check_expand, decompress_device

    with trace.call("decompress"):
        check_expand(expand)
        choice = _call_backend(backend, device, len(et))
        if choice == "host":
            return decompress_host(et, progress=progress)
        tick = progress or (lambda pct, msg: None)
        if choice == "sharded":
            from .parallel import decompress_sharded, make_mesh

            mesh = make_mesh(device=device)
            tick(20, "Decoding text...")
            out = decompress_sharded(et, mesh, expand=expand)
        else:
            dev = resolve_device(device)
            tick(20, "Decoding text...")
            out = decompress_device(et, device=dev, expand=expand)
        tick(90, "Writing decoded text...")
        return out


def compress_file(src, dst=None, **kwargs) -> str:
    """Compress file ``src`` to ``dst`` (default: ``src + '.et'``, the
    reference CLI's naming). Returns the output path."""
    from .cli import default_output_name  # lazy: cli imports api

    src = Path(src)
    dst = Path(dst) if dst is not None else Path(default_output_name("compress", str(src)))
    dst.write_bytes(compress(src.read_bytes(), **kwargs))
    return str(dst)


def decompress_file(src, dst=None, **kwargs) -> str:
    """Decompress .et file ``src`` to ``dst`` (default: ``decoded_<name>``
    minus the .et suffix, the reference CLI's naming). Returns the path."""
    from .cli import default_output_name  # lazy: cli imports api

    src = Path(src)
    dst = Path(dst) if dst is not None else Path(default_output_name("decompress", str(src)))
    dst.write_bytes(decompress(src.read_bytes(), **kwargs))
    return str(dst)


def inspect(et: bytes) -> dict:
    """Parsed .et header as a dict: validates magic/version and returns
    sizes plus the symbol dictionary (symbol -> (length, code bits))."""
    hdr = parse_header(et)
    table = hdr.table
    dictionary = {
        int(s): (int(table.lengths[s]), format(int(table.codes[s]), f"0{int(table.lengths[s])}b"))
        for s in range(256)
        if table.lengths[s] > 0
    }
    return {
        "version": hdr.version,
        "num_symbols": table.num_symbols,
        "original_bytes": hdr.body_len,
        "compressed_bytes": len(et),
        "body_offset": hdr.body_start,
        "max_code_len": table.max_len,
        "min_code_len": table.min_len,
        "dictionary": dictionary,
    }
