"""What a run ran on, and the most memory it took.

Copies of the port's bench readings (``entreepy_tpu_torch/bench/timing.py``:
``device_info``, ``nvidia_smi``, ``peak_bytes``), kept here so that a change
to the program cannot change how it is measured. The peak is read over the
whole run, on every card the cell uses. ``HBM_BYTES_PER_S`` is the card's
published memory rate.
"""

from __future__ import annotations

import resource
import subprocess

# NVIDIA H100 SXM5 data sheet: 80 GB HBM3 at 3.35 TB/s. The card's power
# limit (nvidia-smi) is printed beside every run, since a card set below 700 W
# runs slower under load.
HBM_BYTES_PER_S = 3.35e12


class MissingCardsError(RuntimeError):
    """The cell asks for more CUDA devices than the machine has."""


def require_cards(n: int) -> None:
    """Raise unless ``n`` CUDA devices are visible."""
    import torch

    if not torch.cuda.is_available():
        raise MissingCardsError("no CUDA device: torch.cuda.is_available() is False")
    have = torch.cuda.device_count()
    if have < n:
        raise MissingCardsError(f"the cell needs {n} CUDA devices and {have} are visible")


def nvidia_smi() -> str:
    """The first card's ``name, power.limit`` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def synchronize(cards: int) -> None:
    import torch

    for d in range(cards if torch.cuda.is_available() else 0):
        torch.cuda.synchronize(d)


def release_cache() -> None:
    """Return the blocks PyTorch caches for the program to the card."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def peak_bytes(cards: int) -> int | None:
    """The most device memory allocated on any of the first ``cards`` cards
    since the process began; None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return max(torch.cuda.max_memory_allocated(d) for d in range(cards))


def device_info(cards: int) -> dict:
    """The result's ``device`` entry: platform, the card's name, the cards
    used, and the card's power limit beside them."""
    import torch

    if not torch.cuda.is_available():
        import platform

        return {"platform": "cpu", "kind": platform.machine(), "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cards,
            "nvidia_smi": nvidia_smi()}


def host_cpu_s() -> float:
    """User and system CPU seconds of this process so far, all threads."""
    u = resource.getrusage(resource.RUSAGE_SELF)
    return u.ru_utime + u.ru_stime


def host_peak_bytes() -> int:
    """The process's peak resident set (``ru_maxrss``; a run is a fresh
    process, so it carries no parent's peak)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
