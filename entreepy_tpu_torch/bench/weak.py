"""Weak scaling over process boundaries: fixed text per rank, efficiency
t(first world)/t(N).

Counterpart of ``benchmarks/multihost_bench.py`` with its worker
(``_weak_worker``). For each world size N it starts N processes
(``python -m entreepy_tpu_torch.bench._weak_worker``) that join one group
through a TCP store on 127.0.0.1; each runs
``parallel.multihost.compress`` and ``decompress`` on ``per_rank_mb`` MB x N
of text, so each rank holds the same work at every N. In the port one rank
is one device, so the source's two virtual CPU devices per process
(``mb_per_dev`` x 2 x N bytes) become one device per rank. Where the
machine has N cards, rank r runs on ``cuda:r`` in an NCCL group. Otherwise
every rank runs on ``cuda:0`` (NCCL refuses two ranks on one GPU, so the
group is gloo and its collectives copy through the host), or on the CPU
with ``--device cpu``, and the run prints ``CAVEAT``. Each rank is
pinned to a core of its own where the process may use enough cores
(``os.sched_setaffinity``, in place of the source's ``taskset``), with one
torch thread.

``benchmarks/weak_scaling.py``'s in-process virtual mesh (N virtual CPU
devices in one process) has no counterpart: one rank drives one device, so
its sweep over 1, 2, 4 and 8 devices becomes these process worlds.

Rank 0's times are the row's (the codec's calls inside the workers, not
their start-up), with the group's backend, each rank's device and each
rank's peak RSS; a world that fails a check or outlives ``WORLD_TIMEOUT_S``
makes the exit code non-zero.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WORLD_TIMEOUT_S = 500  # multihost_bench.py:60
CAVEAT = ("[weak] caveat: the ranks share one device and the host's cores, so this "
          "efficiency mixes the collectives' cost with contention for both: a functional "
          "figure, not a cross-card measurement (benchmarks/weak_scaling.py:11-14)")
PKG_PARENT = Path(__file__).resolve().parents[2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def placement(n: int, device) -> tuple[str, list[str]]:
    """(the group's backend, each rank's device) of a world of ``n`` ranks:
    one card per rank under NCCL where the machine has ``n`` cards, else
    every rank on ``cuda:0`` (or the CPU) under gloo."""
    import torch

    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl", [f"cuda:{r}" for r in range(n)]
    return "gloo", ["cuda:0" if device.type == "cuda" else "cpu"] * n


def run_world(n: int, per_rank_mb: float, device, text=None) -> tuple[list[dict], bool]:
    """The results of each rank of one world of ``n`` processes on
    ``device``, placed by :func:`placement`, and whether they were pinned.
    Raises when a rank fails or the world outlives WORLD_TIMEOUT_S; no rank
    outlives the call."""
    cores = sorted(os.sched_getaffinity(0))
    pinned = len(cores) >= n
    backend, rank_devices = placement(n, device)
    port = _free_port()
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, (str(PKG_PARENT),
                                                       os.environ.get("PYTHONPATH"))))}
    with tempfile.TemporaryDirectory() as tmp:
        logs = [Path(tmp) / f"rank{rank}" for rank in range(n)]
        procs = []
        try:
            for rank, log in enumerate(logs):
                argv = [str(port), str(n), str(rank), str(per_rank_mb), rank_devices[rank],
                        backend, str(cores[rank] if pinned else -1),
                        *([str(text)] if text else [])]
                with open(f"{log}.out", "w") as out, open(f"{log}.err", "w") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "entreepy_tpu_torch.bench._weak_worker", *argv],
                        stdout=out, stderr=err, env=env))
            deadline = time.monotonic() + WORLD_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise TimeoutError(f"world {n}: ranks still running after {WORLD_TIMEOUT_S} s") \
                from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [f"rank {rank} exit {p.returncode}: {Path(f'{log}.err').read_text()[-4000:]}"
                  for rank, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
        if failed:
            raise RuntimeError(f"world {n}: " + " | ".join(failed))
        results = [json.loads(Path(f"{log}.out").read_text().strip().splitlines()[-1])
                   for log in logs]
    return results, pinned


def main(device, worlds=(1, 2, 4), per_rank_mb: float = 3.0, text=None) -> int:
    from .timing import device_info

    if any(placement(n, device)[0] == "gloo" for n in worlds):
        print(CAVEAT, file=sys.stderr)
    info, base, ok = device_info(device), None, True
    for n in worlds:
        backend, rank_devices = placement(n, device)
        ranks, pinned = run_world(n, per_rank_mb, device, text)
        r0 = ranks[0]
        enc_s, dec_s = r0["encode"]["median_ms"] / 1e3, r0["decode"]["median_ms"] / 1e3
        base = base or (enc_s, dec_s)
        row = {"processes": n, "corpus_MB": r0["bytes"] / 1e6, "encode_s": enc_s,
               "decode_s": dec_s, "weak_eff_encode": base[0] / enc_s,
               "weak_eff_decode": base[1] / dec_s, "base_processes": worlds[0],
               "encode": r0["encode"], "decode": r0["decode"],
               "et_equals_host": all(r["et_equals_host"] for r in ranks),
               "round_trip": all(r["round_trip"] for r in ranks),
               "pinned": pinned, "launches": r0["launches"], "group": backend,
               "rank_devices": rank_devices, "peak_rss": [r["peak_rss"] for r in ranks],
               "device": info}
        print(json.dumps(row), flush=True)
        ok = ok and row["et_equals_host"] and row["round_trip"]
    return 0 if ok else 1
