#!/usr/bin/env python3
"""Build entreepy_tpu_torch's wheel, install it, and drive the installed
package from outside any checkout, with no compiler on ``PATH``.

For a caller in a checkout (``chip_smoke.py``'s ``[install]`` phase,
``tests/test_torch_install.py``):

* :func:`build_wheel` copies the packaging files and both packages into a
  directory and runs ``pip wheel --no-deps --no-build-isolation --no-index``
  there, so no ``build/`` or ``*.egg-info`` lands in the checkout;
* :func:`install` runs ``pip install --no-deps --no-index --target <site>``;
* :func:`bare_env` is the environment of an installed run: ``<site>`` alone on
  ``PYTHONPATH``, a given ``XDG_CACHE_HOME``, ``CUDA_HOME`` at nothing, and
  ``PATH`` holding ``<site>/bin`` (no nvcc, no g++) and the directories given;
* :func:`drive` runs this file as a script in that environment.

As a script, from the working directory it is given:

    python tools/installed_check.py <input> <out_dir> [--device cuda|cpu]

it compresses ``<input>`` with the host codec and with the device backend,
decompresses the device's ``.et`` through every ``expand=`` route and the
host's through the host codec, times the host codec (median of 5 warm
calls), and writes ``host.et``, ``device.et`` and ``report.json`` (the
libraries it loaded, each kernel's launches, which round trips were exact,
the host codec's ms, any module of ``entreepy_tpu`` or JAX it loaded) into
``<out_dir>``. It imports only what ``PYTHONPATH`` and the interpreter give.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

PACKAGING = ("setup.py", "pyproject.toml", "LICENSE", "entreepy_tpu", "entreepy_tpu_torch")
ROUTES = ("onepass", "split", "fused")
PIP_TIMEOUT_S = 900


def _pip(*args: str) -> None:
    # --no-index on every call: pip then reads no index and checks no version
    r = subprocess.run([sys.executable, "-m", "pip", *args, "--no-cache-dir",
                        "--disable-pip-version-check"], capture_output=True, text=True,
                       timeout=PIP_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"pip {args[0]} failed (exit {r.returncode}):\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")


def build_wheel(root: Path, work: Path) -> Path:
    """The wheel of the checkout at ``root``, built in ``work/src`` (a copy
    without bytecode or built libraries) into ``work/wheel``."""
    src, out = work / "src", work / "wheel"
    src.mkdir(parents=True)
    for name in PACKAGING:
        if (root / name).is_dir():
            shutil.copytree(root / name, src / name,
                            ignore=shutil.ignore_patterns("__pycache__", "*.so"))
        else:
            shutil.copy2(root / name, src / name)
    _pip("wheel", "--no-deps", "--no-build-isolation", "--no-index", "-w", str(out), str(src))
    (wheel,) = out.glob("*.whl")
    return wheel


def install(wheel: Path, site: Path) -> None:
    _pip("install", "--no-deps", "--no-index", "--target", str(site), str(wheel))


def bare_env(site: Path, cache: Path, *path: str) -> dict:
    """The environment of an installed run (no ``ENTREEPY_*`` variable)."""
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("ENTREEPY_")}
    env.update(PYTHONPATH=str(site), XDG_CACHE_HOME=str(cache), CUDA_HOME=os.devnull,
               PATH=os.pathsep.join((str(site / "bin"), *path)))
    return env


def drive(site: Path, cache: Path, cwd: Path, data: Path, out: Path,
          device: str = "cuda") -> dict:
    """Run this file as a script in :func:`bare_env` from ``cwd``; returns
    its report. Raises with its output if it fails."""
    out.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(data), str(out),
                        "--device", device], cwd=cwd, env=bare_env(site, cache),
                       capture_output=True, text=True, timeout=PIP_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"installed run failed (exit {r.returncode}):\n{r.stdout}\n{r.stderr}")
    return json.loads((out / "report.json").read_text())


def _wall_ms(fn, iters: int = 5) -> float:
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input")
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import entreepy_tpu_torch as et
    from entreepy_tpu_torch import _build, runtime
    from entreepy_tpu_torch.ops import (cuda_compact, cuda_fsm8, cuda_pack, cuda_stitch,
                                        cuda_symbols, cuda_tables)

    kernels = (cuda_fsm8.sync_pass, cuda_fsm8.fused_pass, cuda_fsm8.emit_pass,
               cuda_fsm8.expand_pass_split, cuda_fsm8.expand_pass, cuda_pack.pack_blocks,
               cuda_compact.compact_rows, cuda_symbols.symbol_counts, cuda_symbols.write_symbols,
               cuda_stitch.stitch_tile, cuda_tables.fsm_tables)
    data, out = Path(args.input).read_bytes(), Path(args.out)
    host = et.compress(data, backend="host")
    device = et.compress(data, backend="device", device=args.device)
    (out / "host.et").write_bytes(host)
    (out / "device.et").write_bytes(device)
    decoded = {"host": et.decompress(host, backend="host") == data}
    for route in ROUTES:
        decoded[route] = et.decompress(device, backend="device", device=args.device,
                                       expand=route) == data
    runtime_lib = runtime._load()
    report = {
        "package": et.__file__,
        "runtime": runtime_lib and runtime_lib._name,
        "kernels": _build._lib and _build._lib._name,
        "launches": {fn.__name__: fn.launches for fn in kernels},
        "decoded": decoded,
        "host_ms": {"compress": _wall_ms(lambda: et.compress(data, backend="host")),
                    "decompress": _wall_ms(lambda: et.decompress(host, backend="host"))},
        "modules": sorted(n for n in sys.modules if n.split(".")[0] in ("entreepy_tpu", "jax")),
    }
    (out / "report.json").write_text(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
