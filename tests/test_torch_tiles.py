"""The port's streaming tiles on ``device="cpu"`` (the kernels' plain
versions) against the JAX package: the tiled one-pass decode against JAX's
``decode_body_device_tiled`` (its XLA scan twins on the CPU) and the port's
default one-pass route (one tile), the router between the routes, and the
tiled encode against the host codec. Exact byte equality, and the same error on bad streams."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entreepy_tpu.format import compress_host, parse_header  # noqa: E402
from entreepy_tpu.ops import decode8 as jd  # noqa: E402

from entreepy_tpu_torch.ops import decode8 as td  # noqa: E402
from entreepy_tpu_torch.ops import encode as te  # noqa: E402

CHUNK = 64


def _data(name: str, request) -> bytes:
    """~30 KB of text (m = 3: packed rows) or of the Zipf-1.3 skewed family
    of benchmarks/scale.py (m = 4: unpacked rows, the compaction kernel)."""
    if name == "text":
        return request.getfixturevalue("midsummer")[:30000]
    p = 1.0 / np.arange(1, 257) ** 1.3
    rng = np.random.default_rng(1234)
    return rng.choice(256, 30000, p=p / p.sum()).astype(np.uint8).tobytes()


def _parts(data: bytes):
    et = compress_host(data)
    hdr = parse_header(et)
    return et, hdr, et[hdr.body_start:]


def _outcome(fn):
    try:
        return bytes(fn())
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("tile_lanes", [8, 64, 100000])
@pytest.mark.parametrize("name", ["text", "skewed"])
def test_tiled_decode_matches_jax(name, tile_lanes, request):
    data = _data(name, request)
    _, hdr, body = _parts(data)
    args = (body, hdr.table, hdr.body_len)
    one_tile = td.decode_body_device_tiled(*args, device="cpu", chunk_bytes=CHUNK)
    got = td.decode_body_device_tiled(*args, device="cpu", chunk_bytes=CHUNK,
                                      tile_lanes=tile_lanes)
    want = jd.decode_body_device_tiled(*args, chunk_bytes=CHUNK, tile_lanes=tile_lanes)
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, one_tile)
    assert bytes(got) == data


@pytest.mark.parametrize("name", ["text", "skewed"])
def test_tiled_decode_row_modes(name, request):
    """Text takes the packed rows (m <= 3), the skewed body the unpacked
    rows and the compaction (m > 3)."""
    from entreepy_tpu.format.fsm8 import build_byte_fsm

    _, hdr, body = _parts(_data(name, request))
    m = td.decode_tables(build_byte_fsm(hdr.table), "cpu").m
    assert (m <= 3) is (name == "text")


@pytest.mark.parametrize("cut", [0.25, 0.5, 0.9])
@pytest.mark.parametrize("name", ["text", "skewed"])
def test_tiled_truncated_same_error(name, cut, request):
    _, hdr, body = _parts(_data(name, request))
    short = body[: int(len(body) * cut)]
    got = _outcome(lambda: td.decode_body_device_tiled(
        short, hdr.table, hdr.body_len, device="cpu", chunk_bytes=CHUNK, tile_lanes=64))
    want = _outcome(lambda: jd.decode_body_device_tiled(
        short, hdr.table, hdr.body_len, chunk_bytes=CHUNK, tile_lanes=64))
    assert isinstance(got, tuple) and "ended early" in got[1]
    assert got == want


@pytest.mark.parametrize("name,seed", [("text", 5), ("skewed", 11)])
def test_tiled_corrupt_same_outcome(name, seed, request):
    """Flipped body bytes: the same bytes or the same error as JAX's tiled
    decode; at least one flip is caught."""
    _, hdr, body = _parts(_data(name, request))
    rng = np.random.default_rng(seed)
    rejected = 0
    for _ in range(6):
        pos = int(rng.integers(5, len(body) - 16))
        bad = body[:pos] + bytes([body[pos] ^ 0xFF]) + body[pos + 1:]
        got = _outcome(lambda: td.decode_body_device_tiled(
            bad, hdr.table, hdr.body_len, device="cpu", chunk_bytes=CHUNK, tile_lanes=64))
        assert got == _outcome(lambda: jd.decode_body_device_tiled(
            bad, hdr.table, hdr.body_len, chunk_bytes=CHUNK, tile_lanes=64))
        rejected += isinstance(got, tuple)
    assert rejected >= 1


def test_mid_train_tile_unconverged_uses_host_decoder(monkeypatch, midsummer):
    """Only the second tile reports an unconverged self-sync: the whole body
    goes to the exact serial decoder, once."""
    data = midsummer[:20000]
    _, hdr, body = _parts(data)
    real = td.fsm8_decode_fused
    calls = []

    def fail_second_tile(*a, **k):
        vals, exits, _ = real(*a, **k)
        calls.append(k["entry0"])
        return vals, exits, len(calls) == 2

    monkeypatch.setattr(td, "fsm8_decode_fused", fail_second_tile)
    before = td.decode_host.calls
    out = td.decode_body_device_tiled(body, hdr.table, hdr.body_len, device="cpu",
                                      chunk_bytes=CHUNK, tile_lanes=64)
    assert len(calls) == 2  # the train stopped at the failing tile
    assert calls[0] == 0 and torch.is_tensor(calls[1]) and calls[1].shape == (1,)
    assert bytes(out) == data
    assert td.decode_host.calls == before + 1


@pytest.mark.parametrize("expand,tile_lanes,tiled", [
    ("onepass", 16, True), ("onepass", 1 << 20, True),
    ("split", 16, False), ("fused", 16, False), ("host", 16, False),
])
def test_router(monkeypatch, expand, tile_lanes, tiled, midsummer):
    """The one-pass route always streams in tiles (one tile up to
    TILE_LANES lanes); the two-pass routes run the same route step as one
    tile of every lane, the device ones through the same tile loop."""
    data = midsummer[:20000]
    et, _, body = _parts(data)
    monkeypatch.setattr(td, "TILE_LANES", tile_lanes)
    real_loop, real_passes, loops, tiles = td.decode_body_device_tiled, td.route_passes, [], []

    def loop(*a, **k):
        loops.append(k.get("tile_lanes"))
        return real_loop(*a, **k)

    def passes(seg, lanes, *a, **k):
        tiles.append(lanes)
        return real_passes(seg, lanes, *a, **k)

    monkeypatch.setattr(td, "decode_body_device_tiled", loop)
    monkeypatch.setattr(td, "route_passes", passes)
    assert td.decompress_device(et, device="cpu", chunk_bytes=CHUNK, expand=expand) == data
    lanes = -(-len(body) // CHUNK)
    assert loops == ([] if expand == "host" else [None])
    assert tiles == ([min(tile_lanes, lanes - l0) for l0 in range(0, lanes, tile_lanes)]
                     if tiled else [lanes])
    assert (len(tiles) > 1) is (tiled and tile_lanes < lanes)


def test_untiled_two_pass_keeps_its_bound(monkeypatch, midsummer):
    """Above the int32 position bound a two-pass route raises; the one-pass
    route streams instead."""
    et, hdr, body = _parts(midsummer[:5000])
    monkeypatch.setattr(td, "MAX_UNTILED_BYTES", 1024)
    monkeypatch.setattr(td, "TILE_LANES", 8)
    with pytest.raises(NotImplementedError, match="no tiled route"):
        td.decode_body_device_tiled(body, hdr.table, hdr.body_len, device="cpu",
                                    chunk_bytes=CHUNK, expand="split")
    assert td.decompress_device(et, device="cpu", chunk_bytes=CHUNK) == midsummer[:5000]


@pytest.mark.parametrize("tile_blocks", [1, 4, 1000])
def test_tiled_encode_matches_host(monkeypatch, tile_blocks, midsummer):
    data = midsummer[:50000]
    real, tiles = te.encode_blocks_device, []

    def spy(t, *a, **k):
        tiles.append(t.numel())
        return real(t, *a, **k)

    monkeypatch.setattr(te, "encode_blocks_device", spy)
    out = te.compress_device(data, device="cpu", block_bytes=256, tile_blocks=tile_blocks)
    assert out == compress_host(data)
    assert len(tiles) == -(-len(data) // (tile_blocks * 256)) and sum(tiles) == len(data)


def test_tiled_histogram_exact(midsummer):
    arr = np.frombuffer(midsummer[:50000], np.uint8)
    got = te.histogram_tiles(te._uploads(arr, 4 * 256, "cpu"))
    assert np.array_equal(got, np.bincount(arr, minlength=256))


def test_encode_default_tile_width():
    """32 MB of input per tile at the default block size, as the JAX package."""
    from entreepy_tpu.ops import encode as je

    assert te.TILE_BLOCKS * te.DEFAULT_BLOCK_BYTES == 32 << 20 == je.TILE_BLOCKS * 1024
    assert td.TILE_LANES == jd.TILE_LANES == 65536


def test_tile_fetch_lands_before_next_compaction(monkeypatch, midsummer):
    """The previous tile's symbols are fetched, and let go on the device,
    before the next tile's extraction runs: one tile's symbols at most are on
    the device through an extraction, so the tiled decode's peak does not
    grow with the number of tiles (the JAX package's decode has no
    device-side copy to wait for)."""
    data = midsummer[:20000]
    _, hdr, body = _parts(data)
    events = []
    real_fetch, real_plane = td._fetch_async, td.onepass_symbols

    def fetch(tensors):
        i = sum(e[0] == "fetch" for e in events)
        events.append(("fetch", i))
        wait = real_fetch(tensors)

        def landed():
            events.append(("landed", i))
            return wait()

        return landed

    def plane(*a, **k):
        events.append(("compact", sum(e[0] == "compact" for e in events)))
        return real_plane(*a, **k)

    monkeypatch.setattr(td, "_fetch_async", fetch)
    monkeypatch.setattr(td, "onepass_symbols", plane)
    got = td.decode_body_device_tiled(body, hdr.table, hdr.body_len, device="cpu",
                                      chunk_bytes=CHUNK, tile_lanes=8)
    assert bytes(got) == data
    tiles = sum(e[0] == "compact" for e in events)
    assert tiles == -(-len(body) // (8 * CHUNK)) > 2
    for i in range(1, tiles):
        assert events.index(("landed", i - 1)) < events.index(("compact", i)), events


def test_tile_fetch_is_let_go_once_extracted(monkeypatch, midsummer):
    """Each tile's fetched symbols (pinned host memory on the card) are let
    go once they land in the output, before the next tile's fetch starts:
    the host holds one tile's symbols at a time, not one per tile until
    assembly, and the wait of a landed fetch keeps no buffer of it."""
    import weakref

    data = midsummer[:20000]
    _, hdr, body = _parts(data)
    real_fetch, planes = td._fetch_async, []

    def held():
        return [r for r in planes if r() is not None]

    def fetch(tensors):
        assert not held(), "an earlier tile's symbols are still held"
        wait = real_fetch(tensors)
        planes.append(weakref.ref(tensors[0]))  # the symbols

        def landed():
            got = wait()
            planes.append(weakref.ref(got[0]))
            return got

        return landed

    monkeypatch.setattr(td, "_fetch_async", fetch)
    got = td.decode_body_device_tiled(body, hdr.table, hdr.body_len, device="cpu",
                                      chunk_bytes=CHUNK, tile_lanes=8)
    assert bytes(got) == data and len(planes) == 2 * -(-len(body) // (8 * CHUNK)) > 4
    assert not held()


@pytest.mark.parametrize("expand,stage", [("onepass", None), ("split", "device_sym_fetch"),
                                          ("fused", "device_sym_fetch")])
def test_fetch_starts_in_its_own_stage(expand, stage, monkeypatch, midsummer):
    """Where a plane's fetch starts decides which stage of
    ``trace.record_stages`` its copy is charged to: the untiled routes start
    it inside ``device_sym_fetch``; the tiled decode starts each tile's
    after that tile's ``device_expand`` has closed, so the compaction's time
    holds no copy."""
    import contextlib

    data = midsummer[:20000]
    _, hdr, body = _parts(data)
    open_stages, starts = [], []
    real_fetch, real_phase = td._fetch_async, td.phase

    @contextlib.contextmanager
    def phase(name, *a):
        open_stages.append(name)
        with real_phase(name, *a):
            yield
        open_stages.pop()

    def fetch(tensors):
        starts.append(open_stages[-1] if open_stages else None)
        return real_fetch(tensors)

    monkeypatch.setattr(td, "phase", phase)
    monkeypatch.setattr(td, "_fetch_async", fetch)
    if expand == "onepass":
        got = td.decode_body_device_tiled(body, hdr.table, hdr.body_len, device="cpu",
                                          chunk_bytes=CHUNK, tile_lanes=8)
    else:
        got = td.decode_body_device_tiled(body, hdr.table, hdr.body_len, device="cpu",
                                          chunk_bytes=CHUNK, expand=expand)
    assert bytes(got) == data
    assert starts and set(starts) == {stage}, starts
