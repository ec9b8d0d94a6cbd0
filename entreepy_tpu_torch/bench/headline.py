"""The headline: decode throughput of the 5.2 MB text through the public API.

Counterpart of ``bench.py``'s ``main``. The headline value is bench.py's:
``decompress`` through auto (``backend=None``), the best of 13 host-clock
calls after one warm call, in MB/s, with ``vs_baseline`` against the
reference's 0.44 MB/s (its M2 figure, README.md:53 of the reference: 5.2 MB
in 11.8 s). At 5.2 MB auto runs the host codec on any machine
(``api.POD_DEVICE_MIN`` is 8 MiB), as the JAX bench's auto does on its host.

Beside it, in the same line, the rows of the same corpus through the
``device`` backend (compress, and decompress through every ``expand``
route) and the ``host`` backend, each the median, min and max of
``timing.timed_calls`` warm calls, with the device's peak memory, the
kernels' launches over those rows, and, on the card, the probe's ``cuda_*``
figures (``probe.run``). bench.py's random and run-heavy extras go to
stderr, each with its round trip checked. Every ``.et`` must equal the host
backend's and every round trip must be exact: a failure prints bench.py's
zero line and exits 1.

With ``device`` the CPU, the device rows run the kernels' plain versions
and the line says ``"platform": "cpu"`` and holds no ``cuda_*`` field.
"""

from __future__ import annotations

import json
import sys

from .. import api
from ..api import compress, decompress
from ..ops import (cuda_compact, cuda_fsm8, cuda_pack, cuda_stitch, cuda_symbols, cuda_tables,
                   decode8)
from . import probe
from .corpus import TEXT_BYTES, build_corpus, extras
from .timing import device_info, measure, wall

BASELINE_DECODE_MBPS = 0.44  # the reference's M2 figure (bench.py:35), not a TPU number
HEADLINE_CALLS = 13  # bench.py's best of 13
EXTRA_CALLS = 3
METRIC = "decode_throughput_5MB"
KERNELS = (cuda_fsm8.sync_pass, cuda_fsm8.fused_pass, cuda_fsm8.emit_pass,
           cuda_fsm8.expand_pass_split, cuda_fsm8.expand_pass, cuda_pack.pack_blocks,
           cuda_compact.compact_rows, cuda_symbols.symbol_counts, cuda_symbols.write_symbols,
           cuda_stitch.stitch_tile, cuda_tables.fsm_tables)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since :func:`reset_launches`."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def timed_row(fn, want: bytes, n_bytes: int, device, **keys) -> dict:
    """``keys`` plus ``timing.measure``'s stats of ``fn()``, MB/s of
    ``n_bytes`` at the median and ``ok``: the result equals ``want``."""
    got, stats = measure(fn, n_bytes, device)
    return {**keys, **stats, "MBps": n_bytes / stats["median_ms"] / 1e3, "ok": got == want}


def device_rows(data: bytes, host_et: bytes, device) -> list[dict]:
    """The corpus through the device backend (compress, then decompress on
    every route) and the host backend, one row each."""
    n = len(data)
    dev = {"backend": "device", "device": device}
    rows = [timed_row(lambda: compress(data, **dev), host_et, n, device,
                      backend="device", op="compress", expand=None)]
    for route in decode8.EXPAND_MODES:
        rows.append(timed_row(lambda: decompress(host_et, expand=route, **dev), data, n,
                              device, backend="device", op="decompress", expand=route))
    rows.append(timed_row(lambda: compress(data, backend="host"), host_et, n, device,
                          backend="host", op="compress", expand=None))
    rows.append(timed_row(lambda: decompress(host_et, backend="host"), data, n, device,
                          backend="host", op="decompress", expand=None))
    return rows


def main(device, n_bytes: int = TEXT_BYTES, text=None) -> int:
    data = build_corpus(n_bytes, text)
    mb = len(data) / 1e6
    host_et = compress(data, backend="host")
    picked = api._pick_backend(None, len(data))
    blob, enc = wall(lambda: compress(data), iters=HEADLINE_CALLS)
    out, dec = wall(lambda: decompress(blob), iters=HEADLINE_CALLS)
    checks = {"auto .et == host": blob == host_et, "auto round trip": out == data}

    reset_launches()
    rows = device_rows(data, host_et, device)
    launches = launch_counts()
    for r in rows:
        checks[f"{r['backend']} {r['op']} {r['expand'] or ''}".strip()] = r["ok"]

    notes = []
    for name, cdata in extras(len(data)):
        cet = compress(cdata)
        cout, stats = wall(lambda: decompress(cet), iters=EXTRA_CALLS)
        checks[f"{name} extra round trip"] = cout == cdata
        notes.append(f"{name}_decode={len(cdata) / stats['min_ms'] / 1e3:.0f}MB/s "
                     f"(best of {EXTRA_CALLS})")
    cuda = probe.run(blob, device) if device.type == "cuda" else {}

    enc_mbps, dec_mbps = mb / (enc["min_ms"] / 1e3), mb / (dec["min_ms"] / 1e3)
    failed = [k for k, ok in checks.items() if not ok]
    print(f"corpus={len(data)}B compressed={len(blob)}B ratio={len(data) / len(blob):.4f} "
          f"auto={picked} (api.POD_DEVICE_MIN={api.POD_DEVICE_MIN} B: below it auto runs "
          f"the host codec) encode={enc['min_ms']:.3f}ms ({enc_mbps:.1f} MB/s) "
          f"decode={dec['min_ms']:.3f}ms ({dec_mbps:.1f} MB/s) "
          f"roundtrip={'FAIL ' + ', '.join(failed) if failed else 'OK'} " + " ".join(notes)
          + "".join(f" {k}={v:.6g}" for k, v in cuda.items()), file=sys.stderr)
    if failed:
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": "MB/s", "vs_baseline": 0.0}))
        return 1
    print(json.dumps({
        "metric": METRIC, "value": dec_mbps, "unit": "MB/s",
        "vs_baseline": dec_mbps / BASELINE_DECODE_MBPS,
        "corpus_bytes": len(data), "compressed_bytes": len(blob),
        "ratio": len(data) / len(blob), "encode_MBps": enc_mbps, "auto_backend": picked,
        "headline_calls": {"compress": enc, "decompress": dec},
        "rows": rows, "launches": launches, **cuda, "device": device_info(device),
    }))
    return 0
