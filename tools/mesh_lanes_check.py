"""The sharded decode's partition against its plain reference, at the size of
the four-card cell ``text-100MB-4card.decode``.

    python3 tools/mesh_lanes_check.py [--seed N] [--doc-bytes N] [--out FILE]

From the root of a checkout. Makes the cell's document from the seed
(``etbench.traffic.documents``) and its ``.et`` with the benchmark's
reference writer, decodes it once through the public API
(``decompress(et, backend="sharded", expand="onepass")``, whose mesh is
every card the process sees), keeps each rank's part as
``parallel.dist._decompress_rank`` returns it, and compares each rank's
``lane_tot`` and symbols with ``etbench/reference/lanes.py``'s serial decode.
Prints one JSON line: the cards seen, ``make_mesh().world``, each rank's
lanes and symbols, whether they match, and the times. Exits with 1 where a
rank differs or the output is not the document.
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

CELL = "text-100MB-4card.decode"


def rank_parts(et: bytes, **kwargs) -> tuple[bytes, list]:
    """``entreepy_tpu_torch.decompress(et, backend="sharded", **kwargs)`` ->
    (its output, each rank's (lane_tot, symbols) in rank order)."""
    import entreepy_tpu_torch
    from entreepy_tpu_torch.parallel import dist

    got, real = {}, dist._decompress_rank

    def spy(mesh, *a, **k):
        part, stats = real(mesh, *a, **k)
        if part is not None:
            (meta,), (syms,) = part
            got[mesh.rank] = (meta.reshape(2, -1)[0], syms)
        return part, stats

    dist._decompress_rank = spy
    try:
        out = entreepy_tpu_torch.decompress(et, backend="sharded", **kwargs)
    finally:
        dist._decompress_rank = real
    return out, [got[r] for r in sorted(got)]


def compare(parts: list, ref) -> list[dict]:
    """Each rank's part against the reference's share of that rank."""
    rows = []
    for r, ((tot, syms), (lanes, ref_tot, ref_syms)) in enumerate(zip(parts, ref.ranks(len(parts)))):
        rows.append({"rank": r, "lanes": [lanes.start, lanes.stop], "symbols": int(syms.size),
                     "lane_tot_equal": bool(np.array_equal(tot, ref_tot)),
                     "symbols_equal": bool(np.array_equal(syms, ref_syms))})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 tools/mesh_lanes_check.py")
    p.add_argument("--seed", type=int, default=2**31 + 20)
    p.add_argument("--doc-bytes", type=int, default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch

    from entreepy_tpu_torch.parallel import make_mesh
    from etbench.cells import load_cell
    from etbench.reference import et_file
    from etbench.reference.lanes import decode_lanes
    from etbench.traffic import documents

    cell = load_cell(CELL)
    if a.doc_bytes:
        cell.config["doc_bytes"] = a.doc_bytes
    doc = documents(cell, a.seed)[0]
    et = et_file(doc)
    t0 = time.perf_counter()
    out, parts = rank_parts(et, expand="onepass")
    t1 = time.perf_counter()
    ref = decode_lanes(et)
    t2 = time.perf_counter()
    rows = compare(parts, ref)
    res = {"cards": torch.cuda.device_count() if torch.cuda.is_available() else 0,
           "mesh_world": make_mesh().world, "doc_bytes": len(doc), "ranks": rows,
           "output_equal": out == doc, "decode_s": t1 - t0, "reference_s": t2 - t1,
           "ok": out == doc and bool(rows) and all(x["lane_tot_equal"] and x["symbols_equal"]
                                                 for x in rows)}
    line = json.dumps(res)
    print(line, flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(line + "\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
