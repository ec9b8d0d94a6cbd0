"""The corpus-size sweep: one JSON row per size, corpus, backend and route.

Counterpart of ``benchmarks/scale.py``: its sizes (5, 20 and 100 MB by
default; 100 MB of text is the enwik8-scale body, which the device decode
streams in 2 tiles and the encode in 3) and its four corpus families
(``corpus.make_corpus``), through the backends ``auto``, ``host``,
``device`` and ``sharded`` (the device and sharded decompress through each
``--routes`` route). The ``sharded`` row is the local mesh over every card
of the process (one rank per card; one rank with ``--device cpu``), its
``ranks`` the mesh's, its peak device memory the first card's. Each row
carries scale.py's keys (``corpus``, ``corpus_MB``, ``ratio``,
``encode_MBps``, ``decode_MBps``, the rates of the medians) and the median,
min, max and count of the compress and the decompress calls
(``timing.timed_calls``: 5 warm calls, 2 at 100 MB), their peak device
memory, the kernels' launches over the row, what auto picked, the device
(``timing.device_info``), and whether
the ``.et`` equals the host backend's and the round trip is exact. With
``--stages`` the row adds the stages (``trace.record_stages``) of one more
compress and decompress, run after the timed calls, so those run untraced.
A row that fails a check makes the exit code 1.
"""

from __future__ import annotations

import json

from .. import api, trace
from ..api import compress, decompress
from ..parallel import make_mesh
from .corpus import KINDS, make_corpus
from .headline import launch_counts, reset_launches
from .timing import device_info, measure

SIZES_MB = (5.0, 20.0, 100.0)
BACKENDS = ("auto", "host", "device", "sharded")


def _call_kwargs(backend: str, device) -> dict:
    """The API's keyword arguments of a row's ``backend`` on ``device``."""
    if backend == "device":
        return {"backend": "device", "device": device}
    if backend == "sharded":  # every card; on the CPU one rank of plain versions
        return {"backend": "sharded", **({} if device.type == "cuda" else {"device": device})}
    return {"backend": None if backend == "auto" else backend}


def rows(kind: str, mb: float, backends, routes, stages: bool, device, text=None):
    """The rows of one corpus at one size (see the module docstring)."""
    data = make_corpus(kind, int(mb * 1e6), text)
    host_et = compress(data, backend="host")
    n = len(data)
    for backend in backends:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (want one of {BACKENDS})")
        kw = _call_kwargs(backend, device)
        for route in routes if backend in ("device", "sharded") else (None,):
            dkw = {**kw, "expand": route} if route else kw
            reset_launches()
            blob, enc = measure(lambda: compress(data, **kw), n, device)
            out, dec = measure(lambda: decompress(blob, **dkw), n, device)
            row = {"corpus": kind, "corpus_MB": mb, "bytes": n, "backend": backend,
                   "route": route, "ratio": n / len(blob),
                   "encode_MBps": n / enc["median_ms"] / 1e3,
                   "decode_MBps": n / dec["median_ms"] / 1e3,
                   "encode": enc, "decode": dec, "launches": launch_counts(),
                   "et_equals_host": blob == host_et, "round_trip": out == data}
            if backend == "sharded":
                row["ranks"] = make_mesh(device=kw.get("device")).world
            if backend == "auto":
                row["picked"] = {"compress": api._pick_backend(None, n),
                                 "decompress": api._pick_backend(None, len(blob))}
            if stages:
                with trace.record_stages() as enc_stages:
                    compress(data, **kw)
                with trace.record_stages() as dec_stages:
                    decompress(blob, **dkw)
                row["stages"] = {"compress": enc_stages, "decompress": dec_stages}
            yield row


def main(device, sizes=SIZES_MB, corpora=KINDS, backends=BACKENDS, routes=("onepass",),
         stages: bool = False, text=None) -> int:
    ok, info = True, device_info(device)
    for mb in sizes:
        for kind in corpora:
            for row in rows(kind, mb, backends, routes, stages, device, text):
                row["device"] = info
                print(json.dumps(row), flush=True)
                ok = ok and row["et_equals_host"] and row["round_trip"]
    return 0 if ok else 1
