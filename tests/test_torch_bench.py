"""The port's bench (``python -m entreepy_tpu_torch.bench``) on the CPU, at
small sizes (64-256 KiB; ``--device cpu``: the kernels' plain versions).

Its corpora equal the JAX repo's bench generators byte for byte; the
headline, the sweep and the weak-scaling run exit 0 with their rows, their
ratios tie to the JAX package's host codec, and the headline's process
holds no module of JAX or of ``entreepy_tpu``; without a card the bench
refuses to run unless told ``--device cpu``; the probe's byte counts are its
passes' inputs and outputs, and it refuses the CPU.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entreepy_tpu.format import compress_host as jax_compress_host  # noqa: E402

import entreepy_tpu_torch as et  # noqa: E402
from entreepy_tpu_torch import _build, trace  # noqa: E402
from entreepy_tpu_torch.bench import corpus, probe, timing  # noqa: E402
from entreepy_tpu_torch.bench.__main__ import main as bench_main  # noqa: E402
from entreepy_tpu_torch.format import build_code_table, histogram  # noqa: E402
from entreepy_tpu_torch.ops import cuda_fsm8, cuda_pack, decode8  # noqa: E402
from entreepy_tpu_torch.ops.encode import DEFAULT_BLOCK_BYTES  # noqa: E402
from entreepy_tpu_torch.tables import code_tensors, decode_tables_for  # noqa: E402
from entreepy_tpu_torch.utils.stitch import split_blocks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HEADLINE_BYTES = 262_144
SCALE_MB = 0.064
ROWS = [("device", "compress", None)] + [("device", "decompress", r)
                                         for r in decode8.EXPAND_MODES] \
    + [("host", "compress", None), ("host", "decompress", None)]
PROBED = ("pass", "fused_pass", "pack_pass")


def _source(monkeypatch, relpath: str):
    """A script of the JAX repo's bench, loaded by its path with its import
    side effects (env defaults, sys.path) undone after the test."""
    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"_source_{Path(relpath).stem}",
                                                  ROOT / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bench_py_extras(n: int) -> list:
    """bench.py:408-413, as written there (the lines sit inside its main)."""
    rng = np.random.default_rng(11)
    return [
        ("random", rng.integers(0, 256, n, dtype=np.uint8).tobytes()),
        ("runheavy", (b"a" * 4096 + bytes(rng.integers(0, 256, 256, dtype=np.uint8)))
         * (n // 4352)),
    ]


def _mh_worker_text(n_bytes: int) -> bytes:
    """benchmarks/_mh_bench_worker.py:32-34, as written there."""
    src = (ROOT / "tests/data/a_midsummer_nights_dream.txt").read_bytes()
    return (src * (-(-n_bytes // len(src))))[:n_bytes]


@pytest.mark.parametrize("source,kind", [("scale", k) for k in corpus.KINDS]
                         + [("bench", "build_corpus"), ("bench", "random extra"),
                            ("bench", "runheavy extra"), ("mh_worker", "text")])
def test_corpus_matches_source(source, kind, monkeypatch):
    n = 300_001  # cuts the run-heavy unit and the text mid-way
    if source == "scale":
        ref = _source(monkeypatch, "benchmarks/scale.py").make_corpus(kind, n)
        assert corpus.make_corpus(kind, n) == ref
    elif kind == "build_corpus":
        assert corpus.build_corpus() == _source(monkeypatch, "bench.py").build_corpus()
    elif source == "bench":
        name = kind.split()[0]
        got, want = dict(corpus.extras(HEADLINE_BYTES)), dict(_bench_py_extras(HEADLINE_BYTES))
        assert list(dict(corpus.extras(8)).keys()) == ["random", "runheavy"]
        assert got[name] == want[name]
    else:
        assert corpus.make_corpus("text", n) == _mh_worker_text(n)


def test_text_required_outside_checkout(monkeypatch, capsys):
    """An installed package has no fixture: the run needs --text, and with
    it makes the same corpus."""
    fixture = corpus.text_path()
    want = corpus.build_corpus(10_000)
    monkeypatch.setattr(_build, "checkout_root", lambda: None)
    assert bench_main(["--device", "cpu", "--bytes", "10000"]) == 1
    assert "--text" in capsys.readouterr().err
    with pytest.raises(corpus.NoTextError, match="--text"):
        corpus.text_path()
    assert corpus.build_corpus(10_000, text=fixture) == want


def test_wall_and_timed_calls():
    calls = []
    out, stats = timing.wall(lambda: calls.append(1) or len(calls), warm=2, iters=4)
    assert out == 6 and len(calls) == 6 and stats["n"] == 4
    assert 0 <= stats["min_ms"] <= stats["median_ms"] <= stats["max_ms"]
    assert timing.timed_calls(99_999_999) == 5 and timing.timed_calls(100_000_000) == 2
    with timing.peak_bytes(torch.device("cpu")) as peak:
        pass
    assert peak["bytes"] is None


@pytest.mark.parametrize("cmd", [[], ["scale"], ["weak"]])
def test_no_card_needs_device_cpu(cmd, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench runs on it")
    assert bench_main([*cmd, "--bytes", "1000"] if not cmd else cmd) == 1
    got = capsys.readouterr()
    assert "--device cpu" in got.err and got.out == ""


# --- the headline, in a process of its own ---

@pytest.fixture(scope="module")
def headline():
    r = subprocess.run([sys.executable, "-m", "entreepy_tpu_torch.bench", "--device", "cpu",
                        "--bytes", str(HEADLINE_BYTES)], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr


def test_headline_line(headline):
    line, _ = headline
    assert line["metric"] == "decode_throughput_5MB" and line["unit"] == "MB/s"
    assert line["value"] > 0 and line["vs_baseline"] == line["value"] / 0.44
    assert line["corpus_bytes"] == HEADLINE_BYTES and line["auto_backend"] == "host"
    assert line["headline_calls"]["decompress"]["n"] == 13


def test_headline_cpu_has_no_card_figures(headline):
    line, _ = headline
    assert line["device"] == {"platform": "cpu", "kind": line["device"]["kind"],
                              "power_limit_w": None, "count": 1}
    assert not [k for k in line if k.startswith("cuda_")]


@pytest.mark.parametrize("backend,op,expand", ROWS)
def test_headline_rows(backend, op, expand, headline):
    line, _ = headline
    got = [r for r in line["rows"] if (r["backend"], r["op"], r["expand"]) == (backend, op, expand)]
    assert len(got) == 1
    r = got[0]
    assert r["ok"] and r["n"] == 5 and r["peak_bytes"] is None
    assert 0 < r["min_ms"] <= r["median_ms"] <= r["max_ms"]
    assert r["MBps"] == HEADLINE_BYTES / r["median_ms"] / 1e3


def test_headline_imports_no_jax(headline):
    _, err = headline
    assert "[bench] modules of jax or entreepy_tpu imported: []" in err.splitlines()


# --- the sweep and the weak-scaling run ---

def _rows(argv: list[str]) -> list[dict]:
    """The JSON rows of a bench run in a process of its own (this one holds
    JAX, which the bench's own check refuses)."""
    r = subprocess.run([sys.executable, "-m", "entreepy_tpu_torch.bench", *argv], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(x) for x in r.stdout.splitlines()]


@pytest.fixture(scope="module")
def scale_rows():
    return _rows(["scale", "--device", "cpu", "--sizes", str(SCALE_MB), "--corpora",
                  ",".join(corpus.KINDS), "--backends", "auto,host,device", "--stages"])


@pytest.mark.parametrize("kind", corpus.KINDS)
def test_scale_rows_tie_to_jax(kind, scale_rows):
    data = corpus.make_corpus(kind, int(SCALE_MB * 1e6))
    rows = [r for r in scale_rows if r["corpus"] == kind]
    assert [(r["backend"], r["route"]) for r in rows] == [
        ("auto", None), ("host", None), ("device", "onepass")]
    for r in rows:
        assert r["ratio"] == len(data) / len(jax_compress_host(data))
        assert r["et_equals_host"] and r["round_trip"] and r["bytes"] == len(data)
        assert r["encode"]["n"] == r["decode"]["n"] == 5
        assert r["decode_MBps"] == len(data) / r["decode"]["median_ms"] / 1e3
    assert rows[0]["picked"] == {"compress": "host", "decompress": "host"}


def test_scale_stages(scale_rows):
    """The device row's stages are trace.record_stages' of the same calls."""
    data = corpus.make_corpus("text", int(SCALE_MB * 1e6))
    with trace.record_stages() as enc:
        blob = et.compress(data, backend="device", device="cpu")
    with trace.record_stages() as dec:
        et.decompress(blob, backend="device", device="cpu")
    row = next(r for r in scale_rows if (r["corpus"], r["backend"]) == ("text", "device"))
    assert list(row["stages"]["compress"]) == list(enc)
    assert list(row["stages"]["decompress"]) == list(dec)
    assert "device_fsm8_decode" in dec and "device_pack" in enc


@pytest.fixture(scope="module")
def weak_rows():
    return _rows(["weak", "--device", "cpu", "--worlds", "1,2", "--per-rank-mb", "0.1"])


@pytest.mark.parametrize("world", [1, 2])
def test_weak_rows(world, weak_rows):
    assert [r["processes"] for r in weak_rows] == [1, 2]
    r = weak_rows[world - 1]
    assert r["corpus_MB"] == 0.1 * world and r["et_equals_host"] and r["round_trip"]
    assert r["weak_eff_encode"] > 0 and r["weak_eff_decode"] > 0
    assert r["encode_s"] > 0 and r["decode_s"] > 0 and r["decode"]["n"] == 3


# --- the probe ---

@pytest.fixture(scope="module")
def small_et():
    return et.compress(corpus.build_corpus(65_536), backend="host")


@pytest.mark.parametrize("name", PROBED)
def test_probe_bound_bytes(name, small_et):
    """The bytes behind each bound share: the probed pass's inputs and
    outputs, each element once (PERF.md §6's count), from the plain
    versions on the CPU."""
    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    tables, buf = decode_tables_for(small_et, "cpu")
    lanes = -(-buf.size // decode8.DEFAULT_CHUNK_BYTES)
    padded = np.zeros(lanes * decode8.DEFAULT_CHUNK_BYTES, np.uint8)
    padded[: buf.size] = buf
    xs = torch.from_numpy(padded.reshape(lanes, -1).T.copy())
    entries = torch.zeros(lanes, dtype=torch.int32)
    if name == "pass":
        want = nbytes(xs, tables.next_state, entries,
                      *cuda_fsm8.emit_pass_plain(xs, tables.next_state, entries))
    elif name == "fused_pass":
        out = cuda_fsm8.fused_pass_plain(xs, tables.fused, entries, tables.m, tables.mt,
                                         tables.s, True, buf.size)
        want = nbytes(xs, tables.fused, entries, *out)
    else:
        arr = np.frombuffer(small_et, np.uint8)
        blocks, valid = (torch.from_numpy(a) for a in split_blocks(arr, DEFAULT_BLOCK_BYTES))
        codes, lengths = code_tensors(build_code_table(histogram(arr)), "cpu")
        want = nbytes(blocks, valid, codes, lengths,
                      *cuda_pack.pack_blocks_plain(blocks, valid, codes, lengths))
    assert probe.bound_bytes(small_et, "cpu")[name] == want


def test_probe_refuses_the_cpu(small_et):
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe.run(small_et, "cpu")
