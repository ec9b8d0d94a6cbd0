"""One run of one cell: ``python3 -m etbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

1. Loads the cell (``cells``), checks that the machine has the cards it asks
   for, and imports the system under test, ``entreepy_tpu_torch``.
2. Makes the cell's documents from the seed (its corpus family), and for a
   ``decompress`` mix their ``.et`` files with the plain reference
   (``traffic.Feed``). The seconds this takes are printed apart as
   ``setup_data_s``; they are part of ``setup_s``.
3. Warms up: one call per document of the pool (the first run in a checkout
   also builds the kernels into ``build/entreepy_tpu_torch/``). ``setup_s``
   ends here.
4. The window: one caller, closed loop, the pool cycled (each call of a
   ``"relabel"`` mix under a code table of its own, ``traffic``); a call
   starts only while time remains, and every call runs to its end.
5. Reads the peak device memory, then judges a sample of the window's
   outputs against the reference (``judge``).
6. Prints the result as one JSON line: with ``--trace 0`` the cell's
   end-to-end metrics, with ``--trace 1`` its per-layer metrics, read under
   ``torch.profiler`` and the program's stage record, and a ``breakdown``.

It prints no result and exits with 2 where the cards or the program are
missing, and with 3 where a module of JAX or of the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from types import SimpleNamespace

from . import devices, judge, reduce
from .cells import Cell, load_cell, reader
from .traffic import Feed

FORBIDDEN = ("jax", "jaxlib", "flax", "entreepy_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in list(modules) if m.split(".", 1)[0] in FORBIDDEN})


class Port:
    """The system under test: ``entreepy_tpu_torch.compress`` /
    ``decompress`` with the cell's backend and decode route. ``device``
    (tests only) runs the kernels' plain versions on the CPU."""

    def __init__(self, cell: Cell, device=None):
        import entreepy_tpu_torch
        from entreepy_tpu_torch import trace

        self.api, self.trace = entreepy_tpu_torch, trace
        self.backend = cell.config["backend"]
        self.route = cell.mix.get("route", "onepass")
        self.extra = {} if device is None else {"device": device}

    def __call__(self, op: str, x: bytes) -> bytes:
        if op == "compress":
            return self.api.compress(x, backend=self.backend, **self.extra)
        return self.api.decompress(x, backend=self.backend, expand=self.route, **self.extra)

    def stages(self):
        return self.trace.record_stages()


def execute(cell: Cell, seed: int, seconds: float, trace: bool, program, t0: float,
            log=sys.stderr) -> dict:
    """Steps 2-6 of the module docstring with ``program`` as the system
    under test -> the result (a dict)."""
    op = cell.op
    d0 = time.perf_counter()
    feed = Feed(cell, seed)
    docs = feed.docs
    data_s = time.perf_counter() - d0  # the harness's own share of set-up
    errors = []
    for x in feed.warm():
        try:
            program(op, x)
        except Exception as e:  # judged with the window's failures
            errors.append(f"warm-up: {e!r}"[:300])
    warm_failed = len(errors)
    devices.synchronize(cell.chips)
    setup_s = time.perf_counter() - t0

    sample, calls, failed = judge.Sample(seed), [], 0
    stage_sums: dict = {}
    if trace:
        import torch.profiler as tp

        acts = [tp.ProfilerActivity.CPU]
        if devices.peak_bytes(1) is not None:
            acts.append(tp.ProfilerActivity.CUDA)
        prof = tp.profile(activities=acts)
    else:
        prof = contextlib.nullcontext()
    with prof:
        cpu0 = devices.host_cpu_s()
        start = time.perf_counter()
        deadline = start + seconds
        while not calls or time.perf_counter() < deadline:
            key, x = feed.call(len(calls))
            k = key[0]
            with contextlib.ExitStack() as st:
                if trace:
                    import torch.profiler as tp

                    st.enter_context(tp.record_function(reduce.CALL_SPAN))
                    rec = st.enter_context(program.stages())
                c0 = time.perf_counter()
                try:
                    out = program(op, x)
                except Exception as e:  # a failed call is counted and reported, not fatal
                    out, failed = None, failed + 1
                    errors.append(repr(e)[:300])
                c1 = time.perf_counter()
            if trace:
                for name, ms in rec.items():
                    stage_sums[name] = stage_sums.get(name, 0.0) + ms
            calls.append(SimpleNamespace(start=c0, end=c1, op=op, doc=k, ok=out is not None,
                                         orig_bytes=len(docs[k])))
            if out is not None:
                sample.offer((key, out))
            out = x = None
    window = SimpleNamespace(start=start, calls=calls, setup_s=setup_s,
                             peak_bytes=devices.peak_bytes(cell.chips),
                             cpu_s=devices.host_cpu_s() - cpu0)
    events = prof.events() if trace else None
    prof = None
    gc.collect()
    devices.release_cache()  # the peak is read: the reference runs after the program's state goes

    checks = judge.judge(sample.items, feed, failed + warm_failed)
    correct = judge.is_correct(checks, len(sample.items))

    dev = devices.device_info(cell.chips)
    dev["memory_peak_bytes"] = window.peak_bytes
    dev["host_peak_bytes"] = devices.host_peak_bytes()
    dev["host_cpu_s"] = window.cpu_s  # the process's CPU seconds in the window, all threads
    metrics, extra = {}, {}
    if trace:
        body = [feed.body_bytes(k) for k in range(len(docs))]
        ev, spans = reduce.timeline(events)
        r = reduce.Reading(op=op, calls=len(calls), stages=stage_sums, devices=list(range(cell.chips)),
                           work={"orig_bytes": sum(c.orig_bytes for c in calls),
                                 "body_bytes": sum(body[c.doc] for c in calls)},
                           events=ev, spans=spans)
        for m in cell.per_layer:
            v = reader("metrics", m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = reduce.busy_s(r), r.window_s
        bd = reduce.breakdown(r)
        if bd is not None:
            extra["breakdown"] = bd
    else:
        for m in cell.end_to_end:
            v = reader("e2e", m["name"])(window)
            if v is None:  # peak_device_MB off the card (the tests' plain versions)
                print(f"[etbench] {m['name']} read nothing", file=log)
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    wall = calls[-1].end - start
    print(f"[etbench] {cell.name} seed {seed}: setup {setup_s:.3f} s (documents and their "
          f"reference files {data_s:.3f} s), {len(calls)} calls "
          f"({failed} failed) in {wall:.3f} s, {len(sample.items)} compared; "
          f"{dev.get('nvidia_smi', dev['kind'])}", file=log)
    for e in errors[:5]:
        print(f"[etbench] failed call: {e}", file=log)
    for name, c in checks.items():
        print(f"[etbench] check {name} {c['value']} limit {c['limit']}", file=log)
    return {"correct": correct, "attempted": len(calls), "failed": failed, "metrics": metrics,
            "device": dev, **extra, "setup_data_s": data_s, "checks": checks}


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m etbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    try:
        devices.require_cards(cell.chips)
        program = Port(cell)
    except (devices.MissingCardsError, ImportError) as e:
        print(f"[etbench] no run: {e}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), program, t0)
    found = forbidden_modules()
    if found:
        print(f"[etbench] no result: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
