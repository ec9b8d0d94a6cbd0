"""Sets of runs of cells, and their spreads: the measurements that set the
bounds in ``BENCHMARK.json``.

    python3 -m etbench.sets --workload text-100MB.decode --seeds 11,12,13,14,15,16 \\
        --sets 2 --seconds 40 [--trace 0] --out build/etbench/decode.jsonl

Runs ``python3 -m etbench`` once per seed, as a process of its own, in each of
``--sets`` sets (the same seeds in every set), one after another. Each run's
result line, exit code, seconds and the end of its standard error go to
``--out``, one JSON object per line. Then it prints, per cell and metric, each
set's values, median and spread (the distance between the first and third
quartile, ``statistics.quantiles(n=4)``, over the median), the widest spread,
and five times it, the bound it would set. ``--workload`` takes several
cells, comma-separated.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def run_one(workload: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    cmd = [sys.executable, "-m", "etbench", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    lines = [x for x in out.strip().splitlines() if x.startswith("{")]
    result = json.loads(lines[-1]) if lines else None
    return {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace, "rc": rc,
            "wall_s": time.perf_counter() - t0, "result": result, "stderr_tail": err[-3000:]}


def summary(rows: list) -> None:
    for w in dict.fromkeys(r["workload"] for r in rows):
        mine = [r for r in rows if r["workload"] == w and r["result"]]
        print(f"== {w}: {len(mine)} results, correct "
              f"{sum(bool(r['result']['correct']) for r in mine)}")
        names = dict.fromkeys(n for r in mine for n in r["result"]["metrics"])
        for n in names:
            spreads = []
            for s in sorted({r["set"] for r in mine}):
                vals = [r["result"]["metrics"][n]["value"] for r in mine
                        if r["set"] == s and n in r["result"]["metrics"]]
                sp = spread(vals)
                spreads.append(sp or 0.0)
                print(f"  {n} set {s}: median {statistics.median(vals)!r} spread {sp!r} "
                      f"values {vals!r}")
            print(f"  {n}: widest spread {max(spreads)!r}, 5x {5 * max(spreads)!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m etbench.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--timeout", type=float, default=1300)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
           if shutil.which("nvidia-smi") else "no nvidia-smi")
    print(f"[sets] {smi}", flush=True)
    rows = []
    with out.open("a") as f:
        for w in a.workload.split(","):
            for s in range(1, a.sets + 1):
                for seed in (int(x) for x in a.seeds.split(",")):
                    row = {**run_one(w, seed, a.seconds, a.trace, a.timeout), "set": s,
                           "card": smi}
                    rows.append(row)
                    f.write(json.dumps(row) + "\n")
                    f.flush()
                    res = row["result"] or {}
                    print(f"[sets] {w} set {s} seed {seed} rc {row['rc']} "
                          f"{row['wall_s']:.1f} s correct {res.get('correct')} "
                          f"{json.dumps(res.get('metrics'))}", flush=True)
                    if row["rc"] != 0 or not res.get("correct"):
                        print(row["stderr_tail"][-1500:], flush=True)
    summary(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
