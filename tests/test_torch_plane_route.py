"""The one-pass decode's plane route (m > 3) on the CPU, against the plain
reference of its lanes (``etbench/reference/lanes.py``): seeded documents of
the benchmark's ``skewed`` family (m = 4) and of the run-heavy corpus
(m = 8), each call's ``.et`` relabelled as the traffic of the cell
``skewed-100MB.decode`` makes it, decoded in several tiles (the
``tile_lanes`` hook, and ``TILE_LANES`` through the API as
``tools/plane_lanes_check.py`` drives it) and on a local mesh of CPU ranks,
with the stage ``plane_compact`` and the count ``plane_compactions`` of
``trace.record_stages``.
"""

import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entreepy_tpu_torch import trace  # noqa: E402
from entreepy_tpu_torch.bench import make_corpus  # noqa: E402
from entreepy_tpu_torch.format.etformat import parse_header  # noqa: E402
from entreepy_tpu_torch.ops import decode8  # noqa: E402
from entreepy_tpu_torch.tables import decode_tables_for  # noqa: E402
from etbench.cells import load_cell  # noqa: E402
from etbench.reference import et_file  # noqa: E402
from etbench.reference.lanes import decode_lanes  # noqa: E402
from etbench.traffic import Feed  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CHUNK = decode8.DEFAULT_CHUNK_BYTES
SEED = 2**31 + 2024


def _tool():
    spec = importlib.util.spec_from_file_location(
        "plane_lanes_check", ROOT / "tools" / "plane_lanes_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
# (family, document bytes, the table's m, lanes per tile)
DOCS = {"skewed": (150_000, 4, 64), "runheavy": (300_000, 8, 40)}


def _feed(kind: str) -> Feed:
    """The cell's relabelled traffic over one seeded document of ``kind``."""
    cell = load_cell(TOOL.CELL)
    n = DOCS[kind][0]
    cell.config["doc_bytes"] = n
    return Feed(cell, SEED) if kind == "skewed" else Feed(cell, SEED, docs=[make_corpus(kind, n)])


@pytest.fixture(params=sorted(DOCS))
def kind(request):
    return request.param


def _decode(et: bytes, tile_lanes: int):
    """The tiled one-pass decode of ``et`` on the CPU inside a stage record,
    each tile's (lane_tot, w_inv) kept -> (output, metas, record)."""
    hdr = parse_header(et)
    metas, real = [], decode8.fetch_symbols

    def spy(pending):
        got = real(pending)
        metas.append(got[1:])
        return got

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decode8, "fetch_symbols", spy)
        with trace.record_stages() as rec:
            out = decode8.decode_body_device_tiled(et[hdr.body_start:], hdr.table, hdr.body_len,
                                                   device="cpu", tile_lanes=tile_lanes)
    return out.tobytes(), metas, rec


def test_documents_take_the_plane_route(kind):
    feed = _feed(kind)
    n, m, tile = DOCS[kind]
    tables, body = decode_tables_for(feed.call(0)[1], "cpu")
    assert tables.m == m and len(feed.docs[0]) == n
    assert -(-body.size // CHUNK) > 2 * tile  # three tiles or more


@pytest.mark.parametrize("call", [0, 1, 2])
def test_tiles_hold_to_the_reference(kind, call):
    """Every lane's count of every tile equals the serial decode's, no lane
    meets an invalid edge, and the output is the document under the call's
    labels; one plane compacted per tile."""
    feed = _feed(kind)
    key, et = feed.call(call)
    out, metas, rec = _decode(et, DOCS[kind][2])
    ref = decode_lanes(et)
    tot = np.concatenate([t for t, _ in metas])
    assert len(metas) >= 3 and np.array_equal(tot, ref.lane_tot)
    assert all((w >= decode8.NO_INVALID).all() for _, w in metas)
    assert out == feed[key] and out != feed.docs[0]  # relabelled
    assert rec.counts["plane_compactions"] == len(metas)


def test_plane_compact_nests_in_device_expand(kind, monkeypatch):
    """``plane_compact`` opens inside ``device_expand`` (no other stage
    between), once a tile, and its time is part of the outer stage's."""
    opened, stack, real_phase = [], [], decode8.phase

    @contextlib.contextmanager
    def phase(name, *a):
        if name == "plane_compact":
            opened.append(list(stack))
        stack.append(name)
        with real_phase(name, *a):
            yield
        stack.pop()

    monkeypatch.setattr(decode8, "phase", phase)
    out, metas, rec = _decode(_feed(kind).call(0)[1], DOCS[kind][2])
    assert len(opened) == len(metas) >= 3
    assert all(s[-1] == "device_expand" for s in opened)
    assert list(rec).index("plane_compact") < list(rec).index("device_expand")
    assert 0 <= rec["plane_compact"] <= rec["device_expand"]


def test_text_compacts_no_plane(midsummer):
    """The packed route (m = 3) records neither the stage nor the count."""
    et = et_file(midsummer)
    out, metas, rec = _decode(et, 8)
    assert out == midsummer and len(metas) > 2
    assert "plane_compactions" not in rec.counts and "plane_compact" not in rec


@pytest.mark.parametrize("family", ["text", "skewed"])
def test_a_local_mesh_counts_its_planes(family, midsummer):
    """On a local mesh of four CPU ranks, as the four-card cell runs: each
    rank's one tile compacts one plane at m = 4, and text (m = 3) none."""
    from entreepy_tpu_torch.parallel import decompress_sharded, make_mesh
    from entreepy_tpu_torch.parallel import dist as pdist

    data = midsummer if family == "text" else _feed("skewed").docs[0]
    with trace.record_stages() as rec:
        assert decompress_sharded(et_file(data), make_mesh(devices=["cpu"] * 4)) == data
    want = 0 if family == "text" else 1
    assert rec.counts.get("plane_compactions", 0) == 4 * want
    assert [r["stages"].counts.get("plane_compactions", 0)
            for r in pdist.last_decode_stats["ranks"]] == [want] * 4
    assert ("plane_compact" in rec) == bool(want)


def test_the_tool_through_the_api(kind, monkeypatch):
    """``tools/plane_lanes_check.py`` over three relabelled calls through
    ``decompress(backend="device")``, its tiles narrowed to force three or
    more: every comparison holds, one plane compacted a tile."""
    monkeypatch.setattr(decode8, "TILE_LANES", DOCS[kind][2])
    res = TOOL.check(_feed(kind), 3, device="cpu")
    assert res["ok"] and res["m"] == DOCS[kind][1] and len(res["calls"]) == 3
    for row in res["calls"]:
        assert len(row["tile_lanes"]) >= 3 and sum(row["tile_lanes"]) == res["lanes"]
        assert row["plane_compactions"] == len(row["tile_lanes"])
        assert row["plane_compact_ms"] > 0


def test_the_tool_refuses_a_wrong_lane_count(monkeypatch):
    """A lane count altered where the tiles' metadata is fetched fails the
    tool's check, though the output is still the document."""
    real = decode8.fetch_symbols

    def wrong(pending):
        syms, lane_tot, w_inv = real(pending)
        lane_tot = np.array(lane_tot)
        lane_tot[0] += 1
        return syms, lane_tot, w_inv

    monkeypatch.setattr(decode8, "fetch_symbols", wrong)
    res = TOOL.check(_feed("skewed"), 1, device="cpu")
    assert not res["ok"] and not res["calls"][0]["lane_tot_equal"]
    assert res["calls"][0]["output_equal"] and res["calls"][0]["no_invalid_edge"]
