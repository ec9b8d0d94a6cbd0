"""The program's own spans and counts over a traced window:
``python3 -m etbench.stages --workload <cell> --seed <n> --calls <k>`` from
the root of a checkout.

While ``torch.profiler`` records, the port opens a range ``entreepy.<stage>``
around each stage of ``trace.phase`` and ``entreepy.compress`` /
``entreepy.decompress`` around each API call, on the profiler's clock, and
its ``trace.record_stages`` record carries ``.counts``: bytes over the link
each way, plane slots scanned, symbols found, automata built. The traced run
of ``run`` reads neither. This tool reads both: it warms the cell up as a run
does, then runs ``--calls`` calls, each inside the benchmark's call span and
a stage record, under the profiler, then checks each output against the
reference, and prints one JSON line with, per call, the stages' ms, the
counts, and these readings:

* ``<op>_api_self_ms``: ``entreepy.<op>`` less the union of the ``entreepy.*``
  stage ranges inside it on its thread (the API's untraced time);
* ``<op>_link_MB``: (``h2d_bytes`` + ``d2h_bytes``) ÷ 10^6;
* ``decode_plane_fill``: 100 × ``symbols`` ÷ ``plane_slots``, %;
* ``decode_fsm_builds``: ``fsm_builds``;

(``<op>`` is ``decode`` or ``encode``; each is None where its input is
absent, as on a program without these ranges and counts), and the window's
longest idle gaps as ``reduce.breakdown`` names them, each followed by
`` at <stage>``: the innermost program range on the calling thread over the
gap's midpoint. It exits with 1 where an output differs from the reference,
and with 2 where the cards or the program are missing.
"""

from __future__ import annotations

import argparse
import heapq
import json
import statistics
import sys
from collections import Counter

from . import devices, reduce
from .cells import load_cell
from .run import Port
from .traffic import Feed

PREFIX = "entreepy."
CALLS = {"compress": "encode", "decompress": "decode"}


def program_spans(events) -> list:
    """(name, start, end, thread) of the program's host-side ``entreepy.*``
    ranges in ``prof.events()``, seconds on the profiler's clock, by start."""
    return sorted(((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.thread)
                   for e in events
                   if e.name.startswith(PREFIX) and not str(e.device_type).endswith("CUDA")),
                  key=lambda s: s[1])


def self_ms(spans, op: str) -> list[float]:
    """Each ``entreepy.<op>`` range's duration less the union of the other
    program ranges inside it on its thread, ms."""
    out = []
    for name, s, e, t in spans:
        if name == PREFIX + op:
            inner = reduce.union((max(a, s), min(b, e)) for n, a, b, u in spans
                                 if u == t and n != name and b > s and a < e)
            out.append((e - s - sum(b - a for a, b in inner)) * 1e3)
    return out


def stage_at(spans, thread, t: float) -> str | None:
    """The innermost program range on ``thread`` that covers ``t`` (the one
    that starts last), without its prefix; None where none covers it."""
    covering = [(s, name) for name, s, e, u in spans if u == thread and s <= t <= e]
    return max(covering)[1].removeprefix(PREFIX) if covering else None


def named_gaps(r: reduce.Reading, spans, top: int = 10) -> list:
    """The ``top`` longest idle gaps of the cell's cards, named as
    ``reduce.breakdown`` names them, plus `` at <stage>`` where a program
    range on the calling thread covers the gap's midpoint."""
    if not r.events or r.stretch is None:
        return []
    thread = next((u for n, _, _, u in spans if n.removeprefix(PREFIX) in CALLS), None)
    lo, hi = r.stretch
    gaps = []
    for d in r.devices:
        edges = [lo] + [x for iv in reduce.busy(r, d) for x in iv] + [hi]
        gaps += [(e - s, d, s) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    out = []
    for length, d, s in heapq.nlargest(top, gaps):
        mid = s + length / 2
        k = next((i for i, (a, b) in enumerate(r.spans) if a <= mid <= b), None)
        label = f"cuda:{d} idle " + (f"in {r.op} call {k}" if k is not None else "between calls")
        stage = stage_at(spans, thread, mid)
        out.append([label + (f" at {stage}" if stage else ""), length])
    return out


def readings(op: str, calls: int, counts: dict, spans) -> dict:
    """The readings of the module docstring, per call."""
    side = CALLS[op]
    own = self_ms(spans, op)
    link = [counts[k] for k in ("h2d_bytes", "d2h_bytes") if k in counts]
    out = {f"{side}_api_self_ms": statistics.fmean(own) if own else None,
           f"{side}_link_MB": sum(link) / calls / 1e6 if link else None}
    if side == "decode":
        slots = counts.get("plane_slots")
        out["decode_plane_fill"] = 100.0 * counts.get("symbols", 0) / slots if slots else None
        # a record that counts anything counts every build; none counted is none built
        out["decode_fsm_builds"] = counts.get("fsm_builds", 0) / calls if counts else None
    return out


def window(cell, seed: int, calls: int, program) -> dict:
    """Warm-up, then ``calls`` traced calls of ``cell`` -> the result line."""
    op, feed = cell.op, Feed(cell, seed)
    for x in feed.warm():
        program(op, x)
    devices.synchronize(cell.chips)
    import torch.profiler as tp

    acts = [tp.ProfilerActivity.CPU]
    if devices.peak_bytes(1) is not None:
        acts.append(tp.ProfilerActivity.CUDA)
    stages, counts, outs = Counter(), Counter(), []
    with tp.profile(activities=acts) as prof:
        for i in range(calls):
            key, x = feed.call(i)
            with tp.record_function(reduce.CALL_SPAN), program.stages() as rec:
                outs.append((key, program(op, x)))
            stages.update(rec)
            counts.update(getattr(rec, "counts", {}))
    events = prof.events()
    wrong = sum(out != feed[key] for key, out in outs)  # the reference runs outside the window
    ev, call_spans = reduce.timeline(events)
    r = reduce.Reading(op=op, calls=calls, stages=dict(stages), work={},
                       devices=list(range(cell.chips)), events=ev, spans=call_spans)
    spans = program_spans(events)
    call_ms = [(e - s) * 1e3 for n, s, e, _ in spans if n == PREFIX + op]
    on_card = sum(1 for e in events
                  if e.name.startswith(PREFIX) and str(e.device_type).endswith("CUDA"))
    return {"workload": cell.name, "seed": seed, "calls": calls, "wrong_outputs": wrong,
            "call_ms": statistics.fmean(call_ms) if call_ms else None,
            "readings": readings(op, calls, counts, spans),
            "stages_ms": {k: v / calls for k, v in stages.items()},
            "counts": {k: v / calls for k, v in counts.items()},
            "device_idle_pct": reduce.idle_pct(r),
            "program_ranges_on_card": on_card,
            "program_ranges_in_device_work": sum(e.name.startswith(PREFIX) for e in ev),
            "idle_gaps": named_gaps(r, spans),
            "device": devices.device_info(cell.chips)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m etbench.stages",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=8)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    try:
        devices.require_cards(cell.chips)
        program = Port(cell)
    except (devices.MissingCardsError, ImportError) as e:
        print(f"[etbench] no run: {e}", file=sys.stderr)
        return 2
    res = window(cell, args.seed, args.calls, program)
    print(json.dumps(res), flush=True)
    return 1 if res["wrong_outputs"] else 0


if __name__ == "__main__":
    sys.exit(main())
