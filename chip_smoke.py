#!/usr/bin/env python3
"""Smoke test of the PyTorch port (entreepy_tpu_torch) on one CUDA card.

Run from the root of a checkout, on a machine with an H100:

    python3 chip_smoke.py [--profile]

Phases, one or more lines each; any failure raises and the exit code is not 0:

1. device  — the card's name and power limit (nvidia-smi), CUDA version,
             capability (must be 9.0), nvcc;
2. build   — compile the kernels of entreepy_tpu_torch/csrc with nvcc;
3. kernels — each of the four kernels against its plain PyTorch version at
             the shapes of the 5.2 MB text corpus (and the skewed corpus for
             the unpacked fused pass), bit-identical on every live value,
             with median CUDA-event times;
4. e2e     — compress + decompress with backend="device" on 5.2 MB text,
             5 MB skewed / run-heavy / random and 100 MB text: .et bytes equal
             the host backend's, round trips exact, the 374-B golden file
             matches, every kernel launched, no self-sync host fallback;
             warm times of the device and the host backends side by side;
5. stages  — each corpus's compress and decompress split into the
             pipeline's stages (``entreepy_tpu_torch.trace.record_stages``:
             host clock, the device synchronized at each stage's end);
   --profile adds one torch.profiler trace of a warm 5.2 MB round trip:
             the device's self time and its busy share of the call.

Then one JSON line of kernel results, the nvidia-smi line again, and last
``{"ok": true, "device": {...}}``. Imports only entreepy_tpu_torch, numpy
and torch; never JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
if not (ROOT / "entreepy_tpu_torch" / "csrc").is_dir():
    sys.exit("chip_smoke: run from the root of a checkout (entreepy_tpu_torch/csrc missing)")
sys.path.insert(0, str(ROOT))

import entreepy_tpu_torch as et  # noqa: E402
from entreepy_tpu_torch import _build, trace  # noqa: E402
from entreepy_tpu_torch.ops import cuda_compact, cuda_fsm8, cuda_pack, decode8  # noqa: E402
from entreepy_tpu_torch.ops.bitpack import (  # noqa: E402
    grouped_counts_plane, plane_cap_g, plane_sub_for,
)
from entreepy_tpu_torch.ops.encode import DEFAULT_BLOCK_BYTES  # noqa: E402
from entreepy_tpu_torch.tables import code_tensors_for, decode_tables_for  # noqa: E402

DATA = ROOT / "tests" / "data"
MB = 1_000_000
DEV = torch.device("cuda")
KERNELS = {  # wrapper -> (name, source, TPU kernel it replaces)
    cuda_fsm8.sync_pass: ("sync_pass", "entreepy_tpu_torch/csrc/fsm8.cu",
                          "entreepy_tpu/ops/pallas_fsm8.py:183"),
    cuda_fsm8.fused_pass: ("fused_pass", "entreepy_tpu_torch/csrc/fsm8.cu",
                           "entreepy_tpu/ops/pallas_fsm8.py:539"),
    cuda_pack.pack_blocks: ("pack_blocks", "entreepy_tpu_torch/csrc/pack.cu",
                            "entreepy_tpu/ops/pallas_pack.py:117"),
    cuda_compact.compact_rows: ("compact_rows", "entreepy_tpu_torch/csrc/compact.cu",
                                "entreepy_tpu/ops/pallas_compact.py:121"),
}


def corpus(kind: str, n_bytes: int) -> bytes:
    """The corpus families of benchmarks/scale.py (same generators, seed 1234)."""
    rng = np.random.default_rng(1234)
    if kind == "text":
        src = (DATA / "a_midsummer_nights_dream.txt").read_bytes()
        return (src * (-(-n_bytes // len(src))))[:n_bytes]
    if kind == "random":
        return rng.integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    if kind == "skewed":
        p = 1.0 / np.arange(1, 257) ** 1.3
        p /= p.sum()
        return rng.choice(256, size=n_bytes, p=p).astype(np.uint8).tobytes()
    if kind == "runheavy":
        unit = b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        return (unit * (-(-n_bytes // len(unit))))[:n_bytes]
    raise ValueError(kind)


def cuda_ms(fn, iters: int) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(fn, iters: int) -> float:
    """Median host-clock time of ``fn()`` in ms (it ends in a host fetch)."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor, live: torch.Tensor | None = None) -> int:
    """Largest |a - b| over the live elements; raises if any differs."""
    d = (a.long() - b.long()).abs()
    if live is not None:
        d = torch.where(live, d, 0)
    err = int(d.max()) if d.numel() else 0
    require(err == 0, f"kernel and plain version differ (max |err| {err})")
    return err


def body_cols(data: bytes, chunk: int = decode8.DEFAULT_CHUNK_BYTES):
    """(xs uint8[K, lanes] on the card, decode tables, n_valid, n_real_lanes)
    of a corpus's compressed body, as the decode's main path builds them."""
    tables, buf = decode_tables_for(et.compress(data, backend="host"), DEV)
    lanes = -(-buf.size // chunk)
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: buf.size] = buf
    cols = decode8.bytes_to_cols(padded, lanes, chunk, DEV)
    return cols.t().contiguous(), tables, buf.size, lanes


def fused_check(xs, tables, n_valid, lanes, packed: bool):
    """Fused kernel vs plain at converged entry states: row0/count bytes and
    exits exact, symbol slots compared where live (j < count)."""
    m, mt, s = tables.m, tables.mt, tables.s
    _, exits, unconverged = decode8.fsm8_decode_fused(
        xs.t().contiguous(), tables.next_state, tables.fused, lanes, m, mt, s,
        packed=packed, n_valid=n_valid,
    )
    require(not unconverged, "self-sync did not converge")
    entries = torch.cat([exits.new_zeros(1), exits[:-1]])
    args = (xs, tables.fused, entries, m, mt, s, packed, n_valid)
    vk, xk = cuda_fsm8.fused_pass(*args)
    vp, xp = cuda_fsm8.fused_pass_plain(*args)
    j = torch.arange(m, device=DEV)[None, :, None]
    if packed:
        row0k, row0p = vk >> (8 * m), vp >> (8 * m)
        shifts = (8 * (m - 1 - j)).int()
        slots_k = (vk[:, None, :] >> shifts) & 255
        slots_p = (vp[:, None, :] >> shifts) & 255
    else:
        row0k, row0p = vk[:, 0], vp[:, 0]
        slots_k, slots_p = vk[:, 1:], vp[:, 1:]
    err = max(max_err(row0k, row0p), max_err(xk, xp),
              max_err(slots_k, slots_p, j < (row0p & 15)[:, None, :]))
    ms = cuda_ms(lambda: cuda_fsm8.fused_pass(*args), 20)
    plain_ms = cuda_ms(lambda: cuda_fsm8.fused_pass_plain(*args), 3)
    return err, ms, plain_ms


def _self_device_us(event) -> float:
    value = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if value is None else value


def profile_round_trip(data: bytes, card: str) -> None:
    """torch.profiler over one warm compress and one warm decompress: the
    device's self time (kernels and copies), its share of the profiled call,
    the top device entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    blob = et.compress(data)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        et.decompress(blob)  # the profiler's first session pays its own start-up
    for direction, fn in (("compress", lambda: et.compress(data)),
                          ("decompress", lambda: et.decompress(blob))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        # device-side entries only: a host op's self device time repeats its kernels'
        events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=_self_device_us, reverse=True)
        dev_ms = sum(_self_device_us(e) for e in events) / 1e3
        print(f"[profile] {len(data)} B text {direction}: {wall:.3f} ms under the profiler, "
              f"device self time {dev_ms:.3f} ms, busy share {dev_ms / wall:.4f} | {card}")
        for e in events[:8]:
            print(f"[profile]   {e.key}: {_self_device_us(e) / 1e3:.3f} ms in {e.count} calls")


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler trace of a warm 5.2 MB round trip")
    profile = parser.parse_args(argv).profile
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    # 1. device
    print(card)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | capability {cap} | nvcc {_build.nvcc_path()}")
    require(cap == (9, 0), f"want an sm_90 card, got capability {cap}")

    # 2. build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    # 3. kernels, at the shapes of the 5.2 MB text corpus
    text = corpus("text", 5_200_000)
    xs, tables, n_valid, lanes = body_cols(text)
    print(f"[kernels] text body {n_valid} B: {lanes} lanes x {xs.shape[0]} B, "
          f"m={tables.m} s={tables.s} fused table {tuple(tables.fused.shape)} | {card}")
    results = {}
    w = min(decode8.SYNC_WINDOW, xs.shape[0])
    sx, zeros = xs[-w:], torch.zeros(lanes, dtype=torch.int32, device=DEV)
    results[cuda_fsm8.sync_pass] = (
        max_err(cuda_fsm8.sync_pass(sx, tables.next_state, zeros),
                cuda_fsm8.sync_pass_plain(sx, tables.next_state, zeros)),
        cuda_ms(lambda: cuda_fsm8.sync_pass(sx, tables.next_state, zeros), 20),
        cuda_ms(lambda: cuda_fsm8.sync_pass_plain(sx, tables.next_state, zeros), 3),
    )
    results[cuda_fsm8.fused_pass] = fused_check(xs, tables, n_valid, lanes, True)

    sk_xs, sk_tables, sk_valid, sk_lanes = body_cols(corpus("skewed", 5 * MB))
    err, ms, plain_ms = fused_check(sk_xs, sk_tables, sk_valid, sk_lanes, False)
    print(f"[kernels] fused_pass unpacked, skewed body {sk_valid} B: {sk_lanes} lanes, "
          f"m={sk_tables.m} table {tuple(sk_tables.fused.shape)} "
          f"({sk_tables.fused.numel()} B shared): max_abs_err {err}, "
          f"{ms:.4f} ms vs plain {plain_ms:.2f} ms | {card}")

    n_blocks = -(-len(text) // DEFAULT_BLOCK_BYTES)
    blocks = torch.zeros(n_blocks * DEFAULT_BLOCK_BYTES, dtype=torch.uint8, device=DEV)
    blocks[: len(text)] = torch.frombuffer(bytearray(text), dtype=torch.uint8).to(DEV)
    blocks = blocks.reshape(n_blocks, DEFAULT_BLOCK_BYTES)
    valid = torch.full((n_blocks,), DEFAULT_BLOCK_BYTES, dtype=torch.int32, device=DEV)
    valid[-1] = len(text) - (n_blocks - 1) * DEFAULT_BLOCK_BYTES
    codes, lengths = code_tensors_for(et.compress(text, backend="host"), DEV)
    pk = cuda_pack.pack_blocks(blocks, valid, codes, lengths)
    pp = cuda_pack.pack_blocks_plain(blocks, valid, codes, lengths)
    results[cuda_pack.pack_blocks] = (
        max(max_err(pk[0].view(torch.int32), pp[0].view(torch.int32), pp[1]),
            max_err(pk[1], pp[1]), max_err(pk[2].view(torch.int32), pp[2].view(torch.int32)),
            max_err(pk[3], pp[3])),
        cuda_ms(lambda: cuda_pack.pack_blocks(blocks, valid, codes, lengths), 20),
        cuda_ms(lambda: cuda_pack.pack_blocks_plain(blocks, valid, codes, lengths), 3),
    )

    wk = pk[0].view(torch.int32).t().contiguous()
    ek = pk[1].t().contiguous()
    sub = plane_sub_for(DEFAULT_BLOCK_BYTES)
    cap = plane_cap_g(int(grouped_counts_plane(pk[1]).max()), DEFAULT_BLOCK_BYTES)
    ck = cuda_compact.compact_rows(wk, ek, sub, cap)
    cp = cuda_compact.compact_rows_plain(wk, ek, sub, cap)
    results[cuda_compact.compact_rows] = (
        max(max_err(ck[0], cp[0]), max_err(ck[1], cp[1])),
        cuda_ms(lambda: cuda_compact.compact_rows(wk, ek, sub, cap), 20),
        cuda_ms(lambda: cuda_compact.compact_rows_plain(wk, ek, sub, cap), 3),
    )
    print(f"[kernels] pack/compact: {n_blocks} blocks x {DEFAULT_BLOCK_BYTES} B, "
          f"compaction sub={sub} cap={cap}")
    for fn, (err, ms, plain_ms) in results.items():
        print(f"[kernels] {KERNELS[fn][0]}: max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms (median CUDA events) | {card}")

    # 4. end to end, through the public API
    golden = (DATA / "nice.shakespeare.txt").read_bytes()
    cases = [("text 5.2 MB", text)] + [
        (f"{kind} 5 MB", corpus(kind, 5 * MB)) for kind in ("skewed", "runheavy", "random")
    ] + [("text 100 MB", corpus("text", 100 * MB))]
    for fn in KERNELS:
        fn.launches = 0
    decode8.decode_host.calls = 0
    golden_et = (DATA / "nice.shakespeare.et").read_bytes()
    require(et.compress(golden) == golden_et, "golden .et differs")
    require(et.decompress(golden_et) == golden, "golden round trip differs")
    print(f"[e2e] golden nice.shakespeare.et (374 B) matches | {card}")
    for name, data in cases:
        host_blob = et.compress(data, backend="host")
        blob = et.compress(data)
        require(blob == host_blob, f"{name}: .et differs from the host backend's")
        require(et.decompress(blob) == data, f"{name}: round trip differs")
        require(et.decompress(blob, backend="host") == data, f"{name}: host round trip differs")
        iters = 2 if len(data) > 20 * MB else 5
        line = []
        for backend in ("device", "host"):
            enc = wall_ms(lambda: et.compress(data, backend=backend), iters)
            dec = wall_ms(lambda: et.decompress(blob, backend=backend), iters)
            line.append(f"{backend}: compress {enc:.3f} ms ({len(data) / enc / 1e3:.1f} MB/s), "
                        f"decompress {dec:.3f} ms ({len(data) / dec / 1e3:.1f} MB/s)")
        print(f"[e2e] {name}: {len(data)} B -> {len(blob)} B, .et == host, round trip ok | "
              f"{' | '.join(line)} | warm median of {iters} | {card}")
    launches = {fn: fn.launches for fn in KERNELS}
    print(f"[e2e] launches: {{{', '.join(f'{KERNELS[f][0]}: {n}' for f, n in launches.items())}}}"
          f" | self-sync host fallbacks: {decode8.decode_host.calls}")
    missing = [KERNELS[f][0] for f, n in launches.items() if n == 0]
    require(not missing, f"main path never launched {missing}")
    require(decode8.decode_host.calls == 0, "self-sync fell back to the host decoder")

    # 5. stages of the device backend (and, with --profile, the device's busy share)
    for name, data in cases:
        blob = et.compress(data)
        iters = 1 if len(data) > 20 * MB else 5
        for direction, fn in (("compress", lambda: et.compress(data)),
                              ("decompress", lambda: et.decompress(blob))):
            runs = []
            for _ in range(iters):
                with trace.record_stages() as stages:
                    fn()
                runs.append(stages)
            print(f"[stages] {name} {direction}, ms (median of {iters}): "
                  + ", ".join(f"{k} {statistics.median(r[k] for r in runs):.3f}"
                              for k in runs[0]) + f" | {card}")
    if profile:
        profile_round_trip(text, card)
    require("jax" not in sys.modules, "the port imported jax")

    print(json.dumps({"kernels": [
        {"name": KERNELS[fn][0], "route": "cuda", "source": KERNELS[fn][1],
         "replaces": KERNELS[fn][2], "launches": launches[fn], "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms}
        for fn, (err, ms, plain_ms) in results.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
