"""Top-level bytes-in/bytes-out API of the PyTorch port.

Two backends with byte-identical output:

* ``device`` (the default) — the port's kernels on a CUDA device
  (``device="cuda"`` unless one is passed). ``device="cpu"`` runs the
  kernels' plain PyTorch versions instead. Without a CUDA device and without
  an explicit ``device``, the call raises: nothing falls back to the CPU.
  ``decompress``'s ``expand`` picks the decode route on the device (see
  ``ops.decode8``): "onepass" (default), the two-pass "split" and "fused",
  or "host" (device state passes, host expansion).
* ``host`` — the JAX package's framework-free host codec
  (``entreepy_tpu.format``), which never imports JAX.

Auto-routing (``backend=None``) and the ``sharded`` backend are not ported.
"""

from __future__ import annotations

from pathlib import Path

import torch

from entreepy_tpu.api import inspect  # noqa: F401  (format-only, re-exported)
from entreepy_tpu.format import compress_host, decompress_host


def _pick_backend(backend: str) -> str:
    if backend in ("device", "host"):
        return backend
    if backend in (None, "sharded"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet; pass 'device' or 'host'"
        )
    raise ValueError(f"unknown backend {backend!r} (want 'device' or 'host')")


def resolve_device(device=None) -> torch.device:
    """The device the ``device`` backend runs on: ``cuda`` by default, or the
    one given. Raises when it is a CUDA device and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend='device' needs a CUDA device and torch.cuda.is_available() "
            "is False; pass device='cpu' to run the kernels' plain PyTorch "
            "versions, or backend='host'"
        )
    return dev


def compress(data: bytes, *, strict: bool = True, backend: str = "device",
             device=None, progress=None) -> bytes:
    """Compress ``data`` into a complete .et file (magic, dict, packed body).

    backend: "device" or "host"; device: the torch device of the device
    backend (default ``cuda``). progress: optional ``(pct, msg)`` callback.
    """
    if _pick_backend(backend) == "host":
        return compress_host(data, strict=strict, progress=progress)
    from .ops.encode import compress_device

    dev = resolve_device(device)
    tick = progress or (lambda pct, msg: None)
    tick(20, "Counting characters...")
    out = compress_device(data, device=dev, strict=strict)
    tick(90, "Writing compressed text...")
    return out


def decompress(et: bytes, *, backend: str = "device", device=None,
               expand: str = "onepass", progress=None) -> bytes:
    """Decompress a complete .et file back to the original bytes.

    expand: the device backend's decode route — "onepass" (default), "split"
    or "fused" (two-pass, split or full expand table; the JAX package's
    ENTREEPY_EXPAND), or "host" (two-pass, states expanded on the host; its
    ENTREEPY_DEVICE_E2E=0). Any other value raises ValueError.
    """
    from .ops.decode8 import check_expand, decompress_device

    check_expand(expand)
    if _pick_backend(backend) == "host":
        return decompress_host(et, progress=progress)
    dev = resolve_device(device)
    tick = progress or (lambda pct, msg: None)
    tick(20, "Decoding text...")
    out = decompress_device(et, device=dev, expand=expand)
    tick(90, "Writing decoded text...")
    return out


def compress_file(src, dst=None, **kwargs) -> str:
    """Compress file ``src`` to ``dst`` (default: ``src + '.et'``, the
    reference CLI's naming). Returns the output path."""
    from entreepy_tpu.cli import default_output_name

    src = Path(src)
    dst = Path(dst) if dst is not None else Path(default_output_name("compress", str(src)))
    dst.write_bytes(compress(src.read_bytes(), **kwargs))
    return str(dst)


def decompress_file(src, dst=None, **kwargs) -> str:
    """Decompress .et file ``src`` to ``dst`` (default: ``decoded_<name>``
    minus the .et suffix, the reference CLI's naming). Returns the path."""
    from entreepy_tpu.cli import default_output_name

    src = Path(src)
    dst = Path(dst) if dst is not None else Path(default_output_name("decompress", str(src)))
    dst.write_bytes(decompress(src.read_bytes(), **kwargs))
    return str(dst)
