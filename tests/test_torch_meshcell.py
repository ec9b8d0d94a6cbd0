"""The four-card cell ``text-100MB-4card.decode`` on the CPU:
the cell through the harness (``etbench.run.execute``) at a small size over
a local mesh of four CPU ranks (the kernels' plain versions), the fault that
must make it not ``correct``, the sharded decode's partition against the
plain reference of its lanes (``etbench/reference/lanes.py``), and the
stages and counts of the mesh's exchanges (``parallel.dist``).
"""

import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import entreepy_tpu_torch.parallel as par  # noqa: E402
from entreepy_tpu_torch import trace  # noqa: E402
from entreepy_tpu_torch.ops import decode8  # noqa: E402
from entreepy_tpu_torch.parallel import compress_sharded, decompress_sharded, make_mesh  # noqa: E402
from entreepy_tpu_torch.parallel import dist as pdist  # noqa: E402
from etbench.cells import load_cell  # noqa: E402
from etbench.reference import et_file  # noqa: E402
from etbench.reference.lanes import decode_lanes  # noqa: E402
from etbench.run import Port, execute  # noqa: E402
from etbench.traffic import documents  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMALL = 48_000
WORLD = 4


def _tool():
    spec = importlib.util.spec_from_file_location(
        "mesh_lanes_check", ROOT / "tools" / "mesh_lanes_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
CELL = TOOL.CELL
MESH_METRICS = {"decode_mesh_wait_ms", "decode_mesh_copy_ms"}


def _cell(doc_bytes: int = SMALL):
    cell = load_cell(CELL)
    cell.config["doc_bytes"] = doc_bytes
    return cell


@pytest.fixture
def cpu_mesh(monkeypatch):
    """``make_mesh()`` as the API calls it, on a machine of ``WORLD`` cards:
    here a local mesh of ``WORLD`` CPU ranks."""
    real = par.make_mesh

    def fake(*a, **k):
        if a or k.get("device") is not None:
            return real(*a, **k)
        return real(devices=["cpu"] * WORLD)

    monkeypatch.setattr(par, "make_mesh", fake)


def _skewed(n: int = 40_000) -> bytes:
    """Zipf bytes: codes past 3 per byte (m > 3, the one-pass plane form)."""
    p = 1.0 / np.arange(1, 257) ** 1.3
    return np.random.default_rng(11).choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


# --- the cell through the harness ---

def test_the_cell_is_the_sharded_deployment():
    cell = load_cell(CELL)
    assert cell.chips == WORLD == cell.config["cards"]
    assert cell.config["backend"] == "sharded" and cell.config["doc_bytes"] == 10**8
    assert cell.mix == load_cell("text-100MB.decode").mix
    assert MESH_METRICS <= {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("trace_on", [0, 1])
def test_the_cell_runs_correct_over_four_cpu_ranks(trace_on, cpu_mesh, monkeypatch):
    cell = _cell()
    calls = []
    real = pdist._spmd
    monkeypatch.setattr(pdist, "_spmd", lambda mesh, *a, **k: calls.append(mesh.world) or real(mesh, *a, **k))
    res = execute(cell, 2**31 + 7, 0.5, bool(trace_on), Port(cell), time.perf_counter())
    assert calls and set(calls) == {WORLD}  # every call ran over the four ranks
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["mismatched_bytes"]["value"] == 0
    if trace_on:
        spans = {m["name"] for m in cell.per_layer if m["source"] == "program_span"}
        assert MESH_METRICS <= spans <= set(res["metrics"])
        assert res["metrics"]["decode_mesh_wait_ms"]["value"] >= 0
        assert res["metrics"]["decode_mesh_copy_ms"]["value"] >= 0
    else:
        assert "decode_MBps" in res["metrics"]


def test_one_rank_altering_a_symbol_is_not_correct(cpu_mesh, monkeypatch):
    """A symbol altered where rank 1 extracts its fetched symbols
    (``decode8.extract_plane_symbols``, the harness's fault point) only:
    the harness must find it."""
    cell = _cell()
    hits = []
    real = decode8.extract_plane_symbols

    def faulty(syms, room):
        syms = real(syms, room)
        if threading.current_thread().name == "entreepy-rank-1":
            hits.append(1)
            syms = syms.copy()
            syms[syms.size // 2] ^= 1
        return syms

    monkeypatch.setattr(decode8, "extract_plane_symbols", faulty)
    res = execute(cell, 12345, 0.3, False, Port(cell), time.perf_counter())
    assert hits, "the fault was never reached"
    assert res["correct"] is False
    assert res["checks"]["mismatched_bytes"]["value"] > 0


# --- the partition against the plain reference ---

def _doc(name: str) -> bytes:
    if name == "zipf":
        return _skewed()
    seed = {"text-a": 2**31 + 11, "text-b": 2**33 + 5}[name]
    return documents(_cell(60_000), seed)[0]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("doc", ["text-a", "text-b", "zipf"])
def test_rank_parts_match_the_lanes_reference(doc, world, monkeypatch):
    """Each rank's ``lane_tot`` and symbols, as ``_decompress_rank`` returns
    them, equal the serial decode's share of that rank."""
    real = par.make_mesh
    monkeypatch.setattr(par, "make_mesh", lambda *a, **k: real(devices=["cpu"] * world))
    data = _doc(doc)
    et = et_file(data)
    out, parts = TOOL.rank_parts(et, expand="onepass")
    assert out == data and len(parts) == world
    ref = decode_lanes(et)
    assert ref.symbols[: len(data)].tobytes() == data
    rows = TOOL.compare(parts, ref)
    assert all(r["lane_tot_equal"] and r["symbols_equal"] for r in rows), rows
    lanes = -(-ref.lane_tot.size // world)
    assert [r["lanes"] for r in rows] == [[r * lanes, (r + 1) * lanes] for r in range(world)]


def test_the_lanes_reference_counts_by_the_end_bit():
    """Two codes: ``0`` and ``1``. Every bit is a symbol; a lane of one
    byte holds eight."""
    from etbench.reference.lanes import symbol_starts

    codes, lengths = np.zeros(256, np.uint32), np.zeros(256, np.uint8)
    codes[ord("a")], codes[ord("b")] = 0, 1
    lengths[ord("a")] = lengths[ord("b")] = 1
    starts, length, sym = symbol_starts(bytes([0b10000001, 0b01000000]), codes, lengths)
    assert starts.tolist() == list(range(16)) and length.tolist() == [1] * 16
    assert bytes(sym.tolist()) == b"baaaaaababaaaaaa"


# --- the exchanges' stages and counts ---

@pytest.mark.parametrize("world", [2, 4])
def test_exchange_counts_on_a_local_mesh(world):
    """``mesh_exchanges`` = world × the exit gathers (``_ExitGather.calls``
    = passes + 1), ``p2p_bytes`` = (world - 1) × the exit states' bytes,
    per exchange per rank; both stages under ``allgather_exits``."""
    data = documents(_cell(60_000), 2**31 + 3)[0]
    et = et_file(data)
    mesh = make_mesh(devices=["cpu"] * world)
    with trace.record_stages() as rec:
        assert decompress_sharded(et, mesh) == data
    ranks = pdist.last_decode_stats["ranks"]
    calls = ranks[0]["passes"] + 1
    exits_bytes = 4 * ranks[0]["lanes"]  # int32 exit states, one per lane of a rank
    assert rec.counts["mesh_exchanges"] == world * calls
    assert rec.counts["p2p_bytes"] == world * calls * (world - 1) * exits_bytes
    for r in ranks:
        assert r["stages"].counts["mesh_exchanges"] == calls
        assert r["stages"].counts["p2p_bytes"] == calls * (world - 1) * exits_bytes
        assert {"mesh_wait", "mesh_copy"} <= set(r["stages"])
        assert r["stages"]["mesh_wait"] + r["stages"]["mesh_copy"] <= r["stages"]["allgather_exits"]
    with trace.record_stages() as rec:
        assert compress_sharded(data, mesh) == et_file(data)
    assert rec.counts["mesh_exchanges"] == world  # the histogram's all-reduce
    assert rec.counts["p2p_bytes"] == world * (world - 1) * 256 * 8  # int64[256] each
    for r in pdist.last_encode_stats["ranks"]:
        assert {"mesh_wait", "mesh_copy"} <= set(r["stages"])


def test_a_lone_rank_records_its_stages_and_counts_nothing():
    data = documents(_cell(30_000), 5)[0]
    with trace.record_stages() as rec:
        assert decompress_sharded(et_file(data), make_mesh(device="cpu")) == data
    assert {"mesh_wait", "mesh_copy"} <= set(rec)
    assert "mesh_exchanges" not in rec.counts and "p2p_bytes" not in rec.counts

