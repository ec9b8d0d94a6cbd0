"""The one-pass decode's plane route against its plain reference, at the size
of the cell ``skewed-100MB.decode``.

    python3 tools/plane_lanes_check.py [--seed N] [--calls K] [--doc-bytes N] [--device cpu]
                                       [--out FILE]

From the root of a checkout. Makes the cell's document from the seed and
its traffic as a run does (``etbench.traffic.Feed``: the reference writer's
``.et``, each call under a code table of its own), and decompresses the
first ``--calls`` calls' files through the public API
(``decompress(et, backend="device", expand="onepass")``; ``--device cpu``
runs the kernels' plain versions). Each tile's per-lane metadata is kept
as ``ops.decode8.fetch_symbols`` returns it, and three things are held to
the reference, exactly (the codec is lossless):

* every lane's ``lane_tot``, the tiles' in stream order, to
  ``etbench/reference/lanes.py``'s serial decode of the call's file;
* every lane's ``w_inv`` to "no invalid edge";
* the output to the document under the call's labels, byte for byte.

Prints one JSON line: the device, the document's lanes and m, and per call
the tiles' lanes, the counts ``plane_compactions`` and ``symbols``, the
stage ``plane_compact`` (ms, synchronized: ``trace.record_stages``), the
results of the three comparisons, the peak device memory and the times.
Exits with 1 where a comparison fails. The reference takes ~40 s of host
time and tens of GB of RAM per call at 10^8 B: on the card's machine only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELL = "skewed-100MB.decode"


def tile_metas(et: bytes, **kwargs) -> tuple[bytes, list, dict]:
    """``entreepy_tpu_torch.decompress(et, backend="device", **kwargs)`` inside
    a stage record -> (its output, each tile's (lane_tot, w_inv) in stream
    order, the record)."""
    import entreepy_tpu_torch
    from entreepy_tpu_torch import trace
    from entreepy_tpu_torch.ops import decode8

    metas, real = [], decode8.fetch_symbols

    def spy(pending):
        syms, lane_tot, w_inv = real(pending)
        metas.append((np.array(lane_tot), np.array(w_inv)))
        return syms, lane_tot, w_inv

    decode8.fetch_symbols = spy
    try:
        with trace.record_stages() as rec:
            out = entreepy_tpu_torch.decompress(et, backend="device", **kwargs)
    finally:
        decode8.fetch_symbols = real
    return out, metas, rec


def compare(metas: list, ref) -> dict:
    """The tiles' metadata against the reference's lanes."""
    from entreepy_tpu_torch.ops.cuda_symbols import NO_INVALID

    tot = np.concatenate([t for t, _ in metas]).astype(np.int64)
    w_inv = np.concatenate([w for _, w in metas]).astype(np.int64)
    return {"tile_lanes": [int(t.size) for t, _ in metas],
            "lane_tot_equal": bool(np.array_equal(tot, ref.lane_tot)),
            "no_invalid_edge": bool((w_inv >= NO_INVALID).all())}


def check(feed, calls: int, device=None) -> dict:
    """The comparisons of the module docstring over the first ``calls``
    calls of ``feed`` (an ``etbench.traffic.Feed`` of a relabelled decode
    mix)."""
    import torch

    from entreepy_tpu_torch.tables import decode_tables_for
    from etbench.reference.lanes import decode_lanes

    extra = {} if device is None else {"device": device}
    on_card = device is None and torch.cuda.is_available()
    first = feed.call(0)[1]
    tables, body = decode_tables_for(first, "cpu")
    rows = []
    for i in range(calls):
        key, et = feed.call(i)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, metas, rec = tile_metas(et, expand="onepass", **extra)
        t1 = time.perf_counter()
        ref = decode_lanes(et)
        t2 = time.perf_counter()
        rows.append({"call": i, **compare(metas, ref), "output_equal": out == feed[key],
                     "plane_compactions": rec.counts.get("plane_compactions", 0),
                     "symbols": rec.counts.get("symbols", 0),
                     "plane_compact_ms": rec.get("plane_compact"),
                     "peak_device_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                     "decode_s": t1 - t0, "reference_s": t2 - t1})
        del out, ref
    ok = bool(rows) and all(r["lane_tot_equal"] and r["no_invalid_edge"] and r["output_equal"]
                            for r in rows)
    return {"device": torch.cuda.get_device_name(0) if on_card else str(device),
            "doc_bytes": len(feed.docs[0]), "body_bytes": int(body.size),
            "lanes": -(-int(body.size) // 512), "m": int(tables.m), "calls": rows, "ok": ok}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 tools/plane_lanes_check.py")
    p.add_argument("--seed", type=int, default=2**31 + 24)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--doc-bytes", type=int, default=None)
    p.add_argument("--device", default=None, help="cpu: the kernels' plain versions")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    from etbench.cells import load_cell
    from etbench.traffic import Feed

    cell = load_cell(CELL)
    if a.doc_bytes:
        cell.config["doc_bytes"] = a.doc_bytes
    res = check(Feed(cell, a.seed), a.calls, a.device)
    line = json.dumps(res)
    print(line, flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
