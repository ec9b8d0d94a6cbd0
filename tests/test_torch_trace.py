"""The port's stage record on the profiler's clock, and its counts
(``entreepy_tpu_torch.trace``): ranges ``entreepy.<stage>`` and
``entreepy.<call>`` while ``torch.profiler`` records, none otherwise, and the
bytes, plane slots, symbols and automaton builds a record counts, computed
here from the pipeline's shapes. All on the CPU (``device="cpu"``, the
kernels' plain versions)."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._C._profiler import _ExperimentalConfig  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import entreepy_tpu_torch  # noqa: E402
from entreepy_tpu_torch import trace  # noqa: E402
from entreepy_tpu_torch.format import compress_host, parse_header  # noqa: E402
from entreepy_tpu_torch.format import fsm8  # noqa: E402
from entreepy_tpu_torch.ops import decode8, encode  # noqa: E402
from entreepy_tpu_torch.parallel import compress_sharded, decompress_sharded, make_mesh  # noqa: E402
from entreepy_tpu_torch.parallel import dist as pdist  # noqa: E402
from entreepy_tpu_torch.tables import code_tensors, decode_tables  # noqa: E402

CHUNK = decode8.DEFAULT_CHUNK_BYTES


@pytest.fixture
def et(midsummer):
    return compress_host(midsummer)


@pytest.fixture
def opened(monkeypatch):
    """The names of every ``torch.profiler.record_function`` opened."""
    names, real = [], torch.profiler.record_function

    def spy(name, *args):
        names.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return names


def _ranges(prof) -> list:
    """(name, start, end, thread) of the host's ``entreepy.*`` ranges."""
    return sorted((e.name, e.time_range.start, e.time_range.end, e.thread)
                  for e in prof.events()
                  if e.name.startswith("entreepy.") and not str(e.device_type).endswith("CUDA"))


def _relabelled(data: bytes) -> bytes:
    """``data`` with its present bytes permuted: the same code lengths under
    another code table."""
    arr = np.frombuffer(data, dtype=np.uint8)
    present = np.unique(arr)
    lut = np.arange(256, dtype=np.uint8)
    lut[present] = np.roll(present, 1)
    return lut[arr].tobytes()


def test_off_path_opens_no_range_and_counts_nothing(opened, et, midsummer):
    """No profiler and no record: no range opens, and a count outside a
    record goes nowhere."""
    assert entreepy_tpu_torch.decompress(et, backend="device", device="cpu") == midsummer
    assert entreepy_tpu_torch.compress(midsummer, backend="device", device="cpu") == et
    trace.count("h2d_bytes", 1)
    assert opened == [] and trace.current() is None
    with trace.record_stages() as rec:
        pass
    assert rec == {} and rec.counts == {}


def test_ranges_open_under_the_profiler_without_a_record(opened, et, midsummer):
    """The profiler alone (an ``ENTREEPY_PROFILE`` trace) sees the call and
    its stages; nothing is counted."""
    with profile(activities=[ProfilerActivity.CPU]):
        assert entreepy_tpu_torch.decompress(et, backend="device", device="cpu") == midsummer
    assert opened[0] == "entreepy.decompress"
    assert {"entreepy.body_upload", "entreepy.host_extract"} <= set(opened)
    assert trace.current() is None


@pytest.mark.parametrize("op", ["compress", "decompress"])
def test_every_stage_is_a_range_inside_its_call(op, et, midsummer):
    """Under the profiler and a record, each recorded stage is a range
    ``entreepy.<stage>`` inside the one ``entreepy.<op>``, on the caller's
    thread, first ending in record order; nested stages nest."""
    fsm8._FSM_CACHE.clear()
    x = midsummer if op == "compress" else et
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.record_stages() as rec:
            getattr(entreepy_tpu_torch, op)(x, backend="device", device="cpu")
    got = _ranges(prof)
    calls = [g for g in got if g[0] == f"entreepy.{op}"]
    assert len(calls) == 1
    _, c0, c1, thread = calls[0]
    stages = [g for g in got if g[0] != f"entreepy.{op}"]
    assert all(c0 <= s <= e <= c1 and t == thread for _, s, e, t in stages)
    by_end = [name.removeprefix("entreepy.") for name, *_ in sorted(stages, key=lambda g: g[2])]
    assert list(dict.fromkeys(by_end)) == list(rec)
    assert Counter(by_end) == {name: 1 for name in rec}
    if op == "decompress":
        span = {name: (s, e) for name, s, e, _ in stages}
        (bs, be), (ts, te) = span["entreepy.fsm_build"], span["entreepy.decode_tables"]
        assert ts <= bs <= be <= te


@pytest.mark.parametrize("n_tiles", [1, 2])
def test_decode_link_bytes(n_tiles, et, midsummer):
    """One-pass decode in one tile and in two: the tables and each tile's
    padded body go up; each tile's symbols, in stream order, and two int32
    words per lane come back, not its 3-slot plane."""
    hdr = parse_header(et)
    body = np.frombuffer(et, dtype=np.uint8)[hdr.body_start:]
    tables = decode_tables(fsm8.build_byte_fsm(hdr.table), "cpu")
    assert tables.m == 3  # the packed route
    lanes = -(-body.size // CHUNK)
    tile_lanes = -(-lanes // n_tiles)
    tiles = [min(tile_lanes, lanes - l0) for l0 in range(0, lanes, tile_lanes)]
    assert len(tiles) == n_tiles
    with trace.record_stages() as rec:
        got = decode8.decode_body_device_tiled(body, hdr.table, hdr.body_len, device="cpu",
                                               tile_lanes=tile_lanes)
    assert got.tobytes() == midsummer
    tables_bytes = tables.next_state.numel() + tables.fused.numel()
    assert rec.counts["h2d_bytes"] == tables_bytes + sum(tl * CHUNK for tl in tiles)
    assert rec.counts["d2h_bytes"] == rec.counts["symbols"] + 8 * lanes
    assert len(midsummer) <= rec.counts["symbols"] < len(midsummer) + 8 * lanes


@pytest.mark.parametrize("expand", ["onepass", "split", "fused"])
@pytest.mark.parametrize("kind", ["text", "skewed"])
def test_decode_fetches_symbols_not_the_plane(kind, expand):
    """Every device route's fetch is its symbols, in stream order, and two
    int32 words per lane (lane_tot, w_inv): the packed route (text, m = 3)
    and the plane form (skewed, m = 4, and both two-pass routes) alike,
    fewer bytes than the slots the symbols came from."""
    from entreepy_tpu_torch.bench import make_corpus

    data = make_corpus(kind, 20_000)
    et = compress_host(data)
    lanes = -(-(len(et) - parse_header(et).body_start) // CHUNK)
    with trace.record_stages() as rec:
        assert entreepy_tpu_torch.decompress(et, backend="device", device="cpu",
                                             expand=expand) == data
    c = rec.counts
    assert c["d2h_bytes"] == c["symbols"] + 8 * lanes
    assert len(data) <= c["symbols"] < c["plane_slots"]


@pytest.mark.parametrize("tile_blocks", [None, 64])
def test_encode_link_bytes(tile_blocks, monkeypatch, midsummer):
    """Compress in one tile and in two: past one tile the input goes up
    twice (histogram, then pack); each tile also uploads its blocks' valid
    lengths and the code tables, and fetches its histogram and its stitched
    bytes: the body once, and once more the byte a tile shares with the one
    before it where the tile starts inside a byte."""
    bits, real = [], encode.encode_blocks_device

    def spy(*args):
        out = real(*args)
        bits.append(out[1])
        return out

    monkeypatch.setattr(encode, "encode_blocks_device", spy)
    block = encode.DEFAULT_BLOCK_BYTES
    n_blocks = -(-len(midsummer) // block)
    step = tile_blocks or n_blocks
    tiles = [min(step, n_blocks - b0) for b0 in range(0, n_blocks, step)]
    assert len(tiles) == (2 if tile_blocks else 1)
    et = compress_host(midsummer)
    with trace.record_stages() as rec:
        assert encode.compress_device(midsummer, device="cpu", tile_blocks=tile_blocks) == et
    codes, lengths = code_tensors(parse_header(et).table, "cpu")
    crossings = 2 if len(tiles) > 1 else 1
    per_tile = codes.numel() * 4 + lengths.numel()
    assert rec.counts["h2d_bytes"] == (len(midsummer) * crossings
                                       + sum(nb * 4 + per_tile for nb in tiles))
    shared = sum(int(at) % 8 != 0 for at in np.cumsum(bits)[:-1])
    body = len(et) - parse_header(et).body_start
    assert rec.counts["d2h_bytes"] == 256 * 8 * len(tiles) + body + shared
    assert len(bits) == rec.counts["device_stitches"] == len(tiles)


def test_plane_slots_and_symbols(monkeypatch, et, midsummer):
    """``plane_slots`` is every slot the packed route's symbols come from, 3
    per body byte of each lane's 512; ``symbols`` what the fetch brought
    back, all of which the extraction returned (the output had room)."""
    extracted, real = [], decode8.extract_plane_symbols

    def spy(syms, room):
        out = real(syms, room)
        extracted.append(out.size)
        return out

    monkeypatch.setattr(decode8, "extract_plane_symbols", spy)
    hdr = parse_header(et)
    lanes = -(-(len(et) - hdr.body_start) // CHUNK)
    with trace.record_stages() as rec:
        assert entreepy_tpu_torch.decompress(et, backend="device", device="cpu") == midsummer
    assert rec.counts["plane_slots"] == 3 * lanes * CHUNK
    assert rec.counts["symbols"] == sum(extracted) >= len(midsummer)


def test_fsm_builds_count_cache_misses(et, midsummer):
    """One build for a new table, none for the same table again, one for a
    relabelled table."""
    fsm8._FSM_CACHE.clear()
    other = compress_host(_relabelled(midsummer))
    assert parse_header(other).table.codes.tobytes() != parse_header(et).table.codes.tobytes()
    builds = []
    for x in (et, et, other):
        with trace.record_stages() as rec:
            entreepy_tpu_torch.decompress(x, backend="device", device="cpu")
        builds.append(rec.counts.get("fsm_builds", 0))
        assert ("fsm_build" in rec) == bool(builds[-1])
    assert builds == [1, 0, 1]


@pytest.mark.parametrize("op", ["compress", "decompress"])
def test_local_mesh_sums_counts_and_keeps_the_slowest_stage(op, et, midsummer):
    """A two-rank local mesh on the CPU: the caller's record holds each count
    summed over the ranks (plus its own automaton build), each rank stage at
    its slowest rank; each rank's ranges are on its own thread, which a
    profiler of every thread sees."""
    fsm8._FSM_CACHE.clear()
    mesh = make_mesh(devices=["cpu"] * 2)
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        with trace.record_stages() as rec:
            if op == "compress":
                assert compress_sharded(midsummer, mesh) == et
            else:
                assert decompress_sharded(et, mesh) == midsummer
    stats = pdist.last_encode_stats if op == "compress" else pdist.last_decode_stats
    ranks = [r["stages"] for r in stats["ranks"]]
    assert all(r.counts["h2d_bytes"] > 0 and r.counts["d2h_bytes"] > 0 for r in ranks)
    want = Counter({"fsm_builds": 1} if op == "decompress" else {})
    for r in ranks:
        want.update(r.counts)
    assert rec.counts == dict(want)
    for name in dict.fromkeys(k for r in ranks for k in r):
        assert rec[name] == max(r.get(name, 0.0) for r in ranks)
    got = _ranges(prof)
    tail = "entreepy.stitch" if op == "compress" else "entreepy.host_validate"
    caller = next(t for name, _, _, t in got if name == tail)  # the caller's own stage
    first = "entreepy.input_upload" if op == "compress" else "entreepy.decode_tables"
    threads = [t for name, _, _, t in got if name == first]
    assert len(threads) == 2 and caller not in threads and threads[0] != threads[1]
