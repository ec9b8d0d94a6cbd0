"""The bench's clocks, bounds and memory readings.

* :func:`wall` — host clock around calls that end in the returned ``bytes``
  (every call of the public API fetches its result to the host, so the
  clock stops after the device's work): median, min, max and count of the
  timed calls after the warm ones;
* :func:`kernel_ms` — CUDA events around back-to-back launches, for work
  already on the card;
* :func:`bound_ms` — the least time to move a function's tensors through
  the card's memory once;
* :func:`peak_bytes` — the most device memory a block allocated above what
  was held when it began;
* :func:`rss_peak` — the largest resident set of the process during a
  block, sampled.

This module imports the standard library only (torch where a function
needs it): ``tools/torch_kernel_ab.py`` loads it by its path.
"""

from __future__ import annotations

import contextlib
import statistics
import time

HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s (NVIDIA's data sheet)
WARM_CALLS = 1
TIMED_CALLS = 5  # PERF.md §2: the median of 5 warm calls ...
BIG_BYTES = 100_000_000
BIG_TIMED_CALLS = 2  # ... and of 2 at 100 MB or more


def timed_calls(n_bytes: int) -> int:
    """Timed calls for an input of ``n_bytes`` (PERF.md §2)."""
    return BIG_TIMED_CALLS if n_bytes >= BIG_BYTES else TIMED_CALLS


def wall(fn, warm: int = WARM_CALLS, iters: int = TIMED_CALLS):
    """(last result, {"median_ms", "min_ms", "max_ms", "n"}) of ``iters``
    host-clock timed calls of ``fn()`` after ``warm`` untimed ones."""
    out = None
    for _ in range(warm):
        out = fn()
    ms = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, {"median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms),
                 "n": iters}


def measure(fn, n_bytes: int, device):
    """(last result, stats) of ``fn()`` on an input of ``n_bytes``:
    :func:`wall` over :func:`timed_calls` calls, and ``"peak_bytes"``, the
    calls' peak device memory (:func:`peak_bytes`; None off the card)."""
    with peak_bytes(device) as peak:
        out, stats = wall(fn, iters=timed_calls(n_bytes))
    return out, {**stats, "peak_bytes": peak["bytes"]}


def kernel_ms(fn, launches: int = 50, runs: int = 5) -> float:
    """Device time of one launch of ``fn()`` in ms: ``launches``
    back-to-back launches between one CUDA-event pair, divided by the count;
    median of ``runs`` such runs after one warm-up call. A device-side sleep
    queued first keeps the queue full while the host enqueues them, so the
    host's per-launch cost (checks, ctypes) opens no gaps between kernels.
    Where ``fn`` itself waits for the device (a fixed point's convergence
    check), the gaps it opens count."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def tensor_bytes(*tensors) -> int:
    """Bytes of ``tensors``: each element counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(*tensors) -> float:
    """Least time to move ``tensors`` through device memory once (the inputs
    read, the outputs written), at the card's published rate. Integer work
    per byte is a few table reads, so bytes, not operations, bound these
    kernels."""
    return tensor_bytes(*tensors) / HBM_BYTES_PER_MS


@contextlib.contextmanager
def peak_bytes(device):
    """Yield a dict whose ``"bytes"`` is, once the block ends, the most
    device memory allocated during it above what was held when it began
    (``torch.cuda.max_memory_allocated``); None off the card."""
    import torch

    got = {"bytes": None}
    if device.type != "cuda":
        yield got
        return
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    yield got
    torch.cuda.synchronize(device)
    got["bytes"] = torch.cuda.max_memory_allocated(device) - base


def rss_now() -> int:
    """The process's resident set now, bytes (/proc/self/statm)."""
    import resource

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


@contextlib.contextmanager
def rss_peak(every_s: float = 0.01):
    """Yield a dict whose ``"bytes"`` is, once the block ends, the largest
    resident set of this process sampled every ``every_s`` seconds during
    it (a daemon thread reads :func:`rss_now`). For a spawned worker:
    ``ru_maxrss`` carries its parent's peak over fork and exec, and not
    every kernel's /proc/self/status has ``VmHWM``."""
    import threading

    got, stop = {"bytes": rss_now()}, threading.Event()

    def sample():
        while not stop.wait(every_s):
            got["bytes"] = max(got["bytes"], rss_now())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield got
    finally:
        stop.set()
        t.join()
        got["bytes"] = max(got["bytes"], rss_now())


# --- what a reading ran on ---

class NoCardError(RuntimeError):
    """A card's reading was asked for and there is no CUDA device."""


def bench_device(name: str | None):
    """The torch device the bench measures on: ``cuda`` unless ``name``
    says otherwise. Without a card, a CUDA device is an error that names
    ``--device cpu``; nothing falls back to the CPU."""
    import torch

    dev = torch.device(name or "cuda")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCardError(
            "no CUDA device (torch.cuda.is_available() is False): run on a card, or pass "
            "--device cpu to run the kernels' plain PyTorch versions on the CPU")
    return dev


def nvidia_smi() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_info(dev) -> dict:
    """{"platform", "kind", "power_limit_w", "count"} of the device a run
    measured on: the card's name and power limit (``nvidia-smi``), or the
    CPU's machine name, with no power limit."""
    import platform

    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": platform.processor() or platform.machine(),
                "power_limit_w": None, "count": 1}
    card = nvidia_smi()
    limit = card.rsplit(",", 1)[-1].strip().removesuffix("W").strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "power_limit_w": float(limit), "count": torch.cuda.device_count(),
            "nvidia_smi": card}
