"""The controls of a cell at its own size, on the seeds given: the readings
that set the upper end of each limit in ``judge``.

    python3 -m etbench.control --workload text-100MB.decode --seeds 1,2,3

For each seed it makes the cell's documents as a run does, puts the control
of ``reference.control`` in the program's place on the inputs of the
window's first pass through the pool (a ``decompress`` mix: the
chunk-parallel decode without self-synchronisation; a ``compress`` mix: the
writer with canonical codes), judges its outputs with the run's own
comparison and prints one JSON line per seed.
The benchmark's runs never run it; it uses no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import judge
from .cells import Cell, load_cell
from .reference import et_file
from .reference.control import nosync_decode
from .traffic import Feed


def control_checks(cell: Cell, seed: int) -> dict:
    """The judged numbers of the control of ``cell`` on ``seed``."""
    feed = Feed(cell, seed)
    outs = []
    for i in range(len(feed.docs)):  # the window's first pass through the pool
        key, x = feed.call(i)
        outs.append((key, nosync_decode(x) if cell.op == "decompress"
                     else et_file(x, canonical=True)))
    checks = judge.judge(outs, feed, failed=0)
    return {"checks": checks, "correct": judge.is_correct(checks, len(outs))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m etbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    for w in a.workload.split(","):
        cell = load_cell(w)
        for seed in (int(x) for x in a.seeds.split(",")):
            t0 = time.perf_counter()
            got = control_checks(cell, seed)
            print(json.dumps({"workload": w, "seed": seed, **got,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
