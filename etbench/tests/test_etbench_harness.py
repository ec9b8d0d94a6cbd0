"""The harness on the CPU: readers on canned readings, ``BENCHMARK.json``
against its contract, the no-JAX check, runs of every cell through the
port's plain versions at a small size, and the faults that must make
``correct`` false. One test drives a cell on the card and skips without one.

Run from the root of a checkout: ``python -m pytest etbench/tests -q``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from etbench import judge, reduce
from etbench.cells import HERE, ROOT, load_cell, reader
from etbench.run import Port, execute, forbidden_modules

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = 48_000


def _reading(**kw) -> reduce.Reading:
    base = dict(op="decompress", calls=2, devices=[0],
                stages={"host_extract": 150.0, "host_validate": 10.0, "host_check_bits": 20.0,
                        "decode_tables": 8.0, "body_upload": 3.0, "device_sym_fetch": 5.0,
                        "allgather_exits": 4.0, "gather_symbols": 16.0, "input_upload": 6.0,
                        "sizing_fetch": 2.0, "device_fetch": 4.0, "code_table": 1.0,
                        "host_assemble": 3.0, "stitch": 2.0, "serialize": 4.0},
                work={"orig_bytes": 2 * 10**8, "body_bytes": 117_000_000},
                events=[reduce.DeviceEvent(0, "kernel", "k1", 0.10, 0.20),
                        reduce.DeviceEvent(0, "kernel", "k2", 0.15, 0.30),
                        reduce.DeviceEvent(0, "memcpy", "Memcpy HtoD", 0.50, 0.60),
                        reduce.DeviceEvent(0, "kernel", "k1", 1.20, 1.40)],
                spans=[(0.0, 0.9), (1.0, 2.0)])
    return reduce.Reading(**{**base, **kw})


def test_per_layer_readers_on_canned_reading():
    r = _reading()
    got = {m["name"]: reader("metrics", m["name"])(r) for m in BENCH["per_layer"]}
    assert got["decode_host_ms"] == pytest.approx(90.0)
    assert got["decode_tables_ms"] == pytest.approx(4.0)
    assert got["decode_transfer_ms"] == pytest.approx(4.0)
    assert got["encode_transfer_ms"] == pytest.approx(6.0)
    assert got["encode_host_ms"] == pytest.approx(5.0)
    kernel_s = 0.10 + 0.15 + 0.20
    assert got["decode_kernel_roofline"] == pytest.approx(100 * 317e6 / 3.35e12 / kernel_s)
    assert got["encode_kernel_roofline"] == got["decode_kernel_roofline"]
    busy = 0.20 + 0.10 + 0.20  # k1 and k2 overlap: their union counts once
    assert got["device_idle.decode"] == pytest.approx(100 * (1 - busy / 2.0))
    assert got["device_idle.encode"] == got["device_idle.decode"]


def test_readers_find_nothing_without_their_input():
    r = _reading(stages={}, events=[])
    for m in BENCH["per_layer"]:
        assert reader("metrics", m["name"])(r) is None, m["name"]


def test_busy_and_breakdown_over_two_cards():
    ev = [reduce.DeviceEvent(0, "kernel", "k", 0.0, 1.0), reduce.DeviceEvent(1, "kernel", "k", 0.0, 0.5)]
    r = _reading(devices=[0, 1], events=ev, spans=[(0.0, 1.0), (1.0, 2.0)])
    assert reduce.busy_s(r) == pytest.approx(0.75)
    bd = reduce.breakdown(r)
    assert bd["device_ops"] == [["k", 1.5]]
    assert bd["idle_gaps"][0] == ["cuda:1 idle in decompress call 1", pytest.approx(1.5)]
    assert len(bd["idle_gaps"]) <= 10


def test_timeline_keeps_the_call_span_off_the_card():
    def ev(name, dev, start, end, user=False):
        return SimpleNamespace(name=name, device_type=f"DeviceType.{dev}", device_index=0,
                               time_range=SimpleNamespace(start=start, end=end),
                               is_user_annotation=user)

    events = [ev(reduce.CALL_SPAN, "CPU", 0, 100, True), ev(reduce.CALL_SPAN, "CUDA", 5, 95, True),
              ev("fused_kernel", "CUDA", 10, 20), ev("Memcpy HtoD (Pageable -> Device)", "CUDA", 30, 40),
              ev("Memset (Device)", "CUDA", 41, 42), ev("aten::copy_", "CPU", 29, 41)]
    dev, spans = reduce.timeline(events)
    assert spans == [(0.0, pytest.approx(100e-6))]
    assert [(e.kind, e.name) for e in dev] == [("kernel", "fused_kernel"),
                                               ("memcpy", "Memcpy HtoD (Pageable -> Device)"),
                                               ("memset", "Memset (Device)")]


def test_end_to_end_readers_on_canned_window():
    calls = [SimpleNamespace(start=float(i), end=i + 0.5 + 0.01 * i, op="decompress", ok=True,
                             orig_bytes=10**6, doc=0) for i in range(40)]
    w = SimpleNamespace(start=0.0, calls=calls, setup_s=3.5, peak_bytes=2 * 10**8)
    assert reader("e2e", "decode_MBps")(w) == pytest.approx(40 / calls[-1].end)
    assert reader("e2e", "encode_MBps")(w) is None
    assert 500 + 10 * 36 < reader("e2e", "decode_ms.p95")(w) < 500 + 10 * 39
    assert reader("e2e", "peak_device_MB")(w) == 200.0
    assert reader("e2e", "setup_s")(w) == 3.5


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["etbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("etbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert (HERE / "e2e" / f"{m['name']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    fours = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (HERE / "mixes" / f"{w['traffic']}.json").is_file()
        cell = load_cell(w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        for m in cell.per_layer:  # each per-layer metric moves a metric its cell reports
            assert m["moves"] in got
    for entry in BENCH["configs"] + BENCH["workloads"]:
        for k in ("source", "why"):
            if k in entry:
                assert 1 <= len(entry[k]) <= 200 and "\t" not in entry[k] and "\n" not in entry[k]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1, "entreepy_tpu": 1,
            "entreepy_tpu.ops.decode8": 1, "entreepy_tpu_torch": 1, "entreepy_tpu_torch.api": 1,
            "jaxtyping": 1, "numpy": 1}
    assert forbidden_modules(mods) == ["entreepy_tpu", "entreepy_tpu.ops.decode8", "flax", "jax",
                                       "jax.numpy", "jaxlib.xla"]


def test_sample_is_drawn_from_the_seed():
    def draw(seed):
        s = judge.Sample(seed, keep=5)
        for i in range(100):
            s.offer(i)
        return s.items

    assert draw(3) == draw(3) and len(draw(3)) == 5 and draw(3) != draw(4)


def _small(name: str):
    cell = load_cell(name)
    cell.config["doc_bytes"] = SMALL
    return cell


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_correct_on_the_plain_versions(name, trace):
    cell = _small(name)
    res = execute(cell, 2**31 + 3, 0.5, bool(trace), Port(cell, device="cpu"), time.perf_counter())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    want -= {"peak_device_MB"} | {m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
    assert want <= set(res["metrics"])
    json.dumps(res)


def _flip(fn):
    def wrapped(*a, **kw):
        out = np.array(fn(*a, **kw), copy=True)
        out.reshape(-1)[out.size // 2] ^= 1
        return out
    return wrapped


def _half_syms(fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        return out[: out.size // 2]
    return wrapped


def _half_blocks(fn):
    def wrapped(flat, nwords, bit_lens):
        h = max(1, nwords.size // 2)
        return fn(flat, nwords[:h], bit_lens[:h])
    return wrapped


def _flip_words(fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        out[0].bitwise_xor_(1)  # every word the kernel wrote, the emitted ones among them
        return out
    return wrapped


DECODE8, ENCODE = "entreepy_tpu_torch.ops.decode8", "entreepy_tpu_torch.ops.encode"
FAULTS = {
    # a decoded symbol altered where the plane is read
    "decode.altered": ("text-5.2MB.decode", DECODE8, "extract_plane_symbols", _flip),
    # half of the lanes' symbols left out
    "decode.half": ("text-100MB.decode", DECODE8, "extract_plane_symbols", _half_syms),
    # a packed word altered where the pack kernel writes it
    "encode.altered": ("text-100MB.encode", ENCODE, "pack_blocks", _flip_words),
    # half of the blocks left out of the stitch
    "encode.half": ("text-100MB.encode", ENCODE, "stitch_flat_payload", _half_blocks),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    import importlib

    name, module, attr, wrap = FAULTS[fault]
    cell = _small(name)
    program = Port(cell, device="cpu")
    mod = importlib.import_module(module)
    calls = []

    def counting(fn):
        inner = wrap(fn)

        def f(*a, **kw):
            calls.append(1)
            return inner(*a, **kw)
        return f

    monkeypatch.setattr(mod, attr, counting(getattr(mod, attr)))
    res = execute(cell, 12345, 0.3, False, program, time.perf_counter())
    assert calls, "the fault was never reached"
    assert res["correct"] is False
    assert res["failed"] > 0 or res["checks"]["mismatched_bytes"]["value"] > 0


def test_the_control_is_not_correct():
    from etbench.control import control_checks

    for name in ("text-5.2MB.decode", "text-100MB.encode"):
        got = control_checks(_small(name), 99)
        assert got["correct"] is False and got["checks"]["mismatched_bytes"]["value"] > 0


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "etbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "etbench", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "-m", "etbench", "--workload", "text-5.2MB.decode",
                        "--seed", str(2**31 + 77), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert {"decode_MBps", "decode_ms.p95", "peak_device_MB", "setup_s"} <= set(res["metrics"])
