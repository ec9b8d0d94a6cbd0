"""From the traced run to per-layer numbers.

A ``--trace 1`` run wraps each call of its window in the program's
``trace.record_stages`` (the stages' summed milliseconds) and in a
``torch.profiler.record_function`` span of the benchmark's own
(:data:`CALL_SPAN`), and runs ``torch.profiler`` over the whole window.
``run.execute`` turns that into a :class:`Reading`; the readers under
``metrics/`` take their numbers from it with the helpers here. The profiled
stretch runs from the start of the window's first call to the end of its
last, in the profiler's clock.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field

CALL_SPAN = "etbench.call"
NAME_CHARS = 160


@dataclass
class DeviceEvent:
    device: int
    kind: str  # "kernel", "memcpy" or "memset"
    name: str
    start: float  # seconds, profiler clock
    end: float


@dataclass
class Reading:
    """What one traced window collected."""

    op: str  # "compress" or "decompress"
    calls: int
    stages: dict  # stage -> ms summed over the window's calls
    work: dict  # "orig_bytes", "body_bytes": summed over the window's calls
    devices: list  # the card indices the cell uses
    events: list = field(default_factory=list)  # DeviceEvent
    spans: list = field(default_factory=list)  # (start, end) of each call, seconds

    @property
    def stretch(self) -> tuple[float, float] | None:
        return (self.spans[0][0], self.spans[-1][1]) if self.spans else None

    @property
    def window_s(self) -> float:
        s = self.stretch
        return s[1] - s[0] if s else 0.0


def _kind(name: str) -> str:
    low = name.lower()
    return "memcpy" if low.startswith("memcpy") else "memset" if low.startswith("memset") else "kernel"


def timeline(events) -> tuple[list, list]:
    """(device events, the benchmark's call spans) of ``prof.events()``."""
    dev, spans = [], []
    for e in events:
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        on_card = str(e.device_type).endswith("CUDA")
        if e.name == CALL_SPAN:
            if not on_card:  # its copy on the card's timeline is no device work
                spans.append((start, end))
        elif on_card and not getattr(e, "is_user_annotation", False):
            dev.append(DeviceEvent(int(e.device_index), _kind(e.name), e.name, start, end))
    spans.sort()
    return dev, spans


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(r: Reading, device: int) -> list:
    """The intervals in which ``device`` ran a kernel, a copy or a set,
    clipped to the profiled stretch."""
    lo, hi = r.stretch
    return union((max(e.start, lo), min(e.end, hi)) for e in r.events
                 if e.device == device and e.end > lo and e.start < hi)


def busy_s(r: Reading) -> float | None:
    """Seconds of device work in the stretch, the mean over the cell's cards;
    None where the trace holds no device work."""
    if not r.events or r.stretch is None:
        return None
    return sum(sum(e - s for s, e in busy(r, d)) for d in r.devices) / len(r.devices)


def idle_pct(r: Reading) -> float | None:
    """The share of the stretch in which a card ran nothing, in %, the mean
    over the cell's cards."""
    b = busy_s(r)
    if b is None or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - b / r.window_s)


def kernel_s(r: Reading) -> float:
    """Summed device time of every CUDA kernel in the stretch."""
    lo, hi = r.stretch or (0.0, 0.0)
    return sum(e.end - e.start for e in r.events if e.kind == "kernel" and lo <= e.start < hi)


def roofline_pct(r: Reading, bytes_moved: float) -> float | None:
    """``bytes_moved`` at the card's published memory rate over the summed
    kernel time, in %; None where no kernel ran."""
    from .devices import HBM_BYTES_PER_S

    t = kernel_s(r)
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / t if t > 0 else None


def stage_ms(r: Reading, names) -> float | None:
    """The stages ``names`` summed, per call; None where none was recorded."""
    if r.calls == 0 or not any(n in r.stages for n in names):
        return None
    return sum(r.stages.get(n, 0.0) for n in names) / r.calls


def breakdown(r: Reading, top: int = 10) -> dict | None:
    """The device operations that took most time (seconds summed by name)
    and the longest idle gaps, each named by the benchmark span it fell in."""
    if not r.events or r.stretch is None:
        return None
    by_name = defaultdict(float)
    for e in r.events:
        by_name[e.name[:NAME_CHARS]] += e.end - e.start
    ops = heapq.nlargest(top, by_name.items(), key=lambda kv: kv[1])
    lo, hi = r.stretch
    gaps = []
    for d in r.devices:
        edges = [lo] + [x for iv in busy(r, d) for x in iv] + [hi]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                gaps.append((e - s, d, s))
    named = []
    for length, d, s in heapq.nlargest(top, gaps):
        mid = s + length / 2
        k = next((i for i, (a, b) in enumerate(r.spans) if a <= mid <= b), None)
        where = f"in {r.op} call {k}" if k is not None else "between calls"
        named.append([f"cuda:{d} idle {where}", length])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}
