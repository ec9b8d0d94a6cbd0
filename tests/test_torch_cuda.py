"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips without a CUDA device. The card's machine
has no JAX, so run this file without the suite's conftest (which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Exact equality on every integer; fused and expanded symbol slots and dense
pack words are compared where the byte's count or the ``emitted`` flag makes
them live.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import entreepy_tpu_torch as et  # noqa: E402
from entreepy_tpu_torch.ops import cuda_compact, cuda_fsm8, cuda_pack, decode8  # noqa: E402
from entreepy_tpu_torch.tables import (  # noqa: E402
    body_for,
    code_tensors_for,
    decode_tables_for,
    expand_tables_for,
)

pytestmark = pytest.mark.cuda
DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _corpus(kind: str, n: int = 60000) -> bytes:
    rng = np.random.default_rng(7)
    if kind == "text":
        return (DATA / "a_midsummer_nights_dream.txt").read_bytes()[:n]
    if kind == "random":  # m = 1, s = 256
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "skewed":  # m = 4, s = 256
        p = 1.0 / np.arange(1, 257) ** 1.3
        return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()
    if kind == "runheavy":  # m = 8
        return (b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()) * 10
    raise ValueError(kind)


def _body(kind: str, chunk: int, dev):
    tables, buf = decode_tables_for(et.compress(_corpus(kind), backend="host"), dev)
    lanes = -(-buf.size // chunk)
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: buf.size] = buf
    xs = torch.from_numpy(np.ascontiguousarray(padded.reshape(lanes, chunk).T)).to(dev)
    return xs, tables, buf.size


def _entries(t, lanes, dev, seed=3):
    e = np.random.default_rng(seed).integers(0, t.s, lanes).astype(np.int32)
    return torch.from_numpy(e).to(dev)


@pytest.mark.parametrize("kind,chunk", [("text", 512), ("random", 64), ("skewed", 100)])
def test_sync_pass(kind, chunk, dev):
    xs, t, _ = _body(kind, chunk, dev)
    entries = _entries(t, xs.shape[1], dev)
    before = cuda_fsm8.sync_pass.launches
    got = cuda_fsm8.sync_pass(xs[-min(128, chunk):], t.next_state, entries)
    want = cuda_fsm8.sync_pass_plain(xs[-min(128, chunk):], t.next_state, entries)
    assert cuda_fsm8.sync_pass.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", [1, 33, 65536])
@pytest.mark.parametrize("w", [1, 5, 17, 128])
def test_sync_pass_windows(w, lanes, dev):
    """The sync kernel at windows shorter than, off and on its byte ring,
    one lane, a part warp and a 65,536-lane tile, with the skewed corpus's
    256-state table (64 KB of shared memory), on random bytes: exits exact."""
    t = _body("skewed", 512, dev)[1]
    assert t.next_state.shape == (256, 256)
    rng = np.random.default_rng(w * lanes)
    xs = torch.from_numpy(rng.integers(0, 256, (w, lanes), dtype=np.uint8)).to(dev)
    entries = _entries(t, lanes, dev, seed=w)
    before = cuda_fsm8.sync_pass.launches
    got = cuda_fsm8.sync_pass(xs, t.next_state, entries)
    want = cuda_fsm8.sync_pass_plain(xs, t.next_state, entries)
    torch.cuda.synchronize()
    assert cuda_fsm8.sync_pass.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind,chunk,packed", [
    ("text", 512, True), ("text", 48, False), ("random", 64, True),
    ("skewed", 512, False), ("runheavy", 32, False),
])
def test_fused_pass(kind, chunk, packed, dev):
    xs, t, n_body = _body(kind, chunk, dev)
    entries = _entries(t, xs.shape[1], dev)
    args = (xs, t.fused, entries, t.m, t.mt, t.s, packed, n_body - 3)
    vk, xk = cuda_fsm8.fused_pass(*args)
    vp, xp = cuda_fsm8.fused_pass_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(xk, xp)
    m = t.m
    j = torch.arange(m, device=dev)[None, :, None]
    if packed:
        row0k, row0p = vk >> (8 * m), vp >> (8 * m)
        sh = (8 * (m - 1 - j)).int()
        sk, sp = (vk[:, None] >> sh) & 255, (vp[:, None] >> sh) & 255
    else:
        row0k, row0p, sk, sp = vk[:, 0], vp[:, 0], vk[:, 1:], vp[:, 1:]
    assert torch.equal(row0k, row0p)
    live = j < (row0p & 15)[:, None]
    assert torch.equal(torch.where(live, sk, 0), torch.where(live, sp, 0))


def _widest_fsm():
    """The byte FSM of a 1-bit code beside 255 longer ones: 256 live states
    and m = 8 symbols per byte."""
    from entreepy_tpu_torch.format import build_code_table
    from entreepy_tpu_torch.format.fsm8 import build_byte_fsm

    counts = np.arange(1, 257, dtype=np.int64)
    counts[0] = 1 << 40
    return build_byte_fsm(build_code_table(counts))


def _pruned_fsm():
    """The text corpus's byte FSM with two codes removed: their bits walk
    dead trie edges, so random bytes hit invalid transitions."""
    from entreepy_tpu_torch.format.fsm8 import build_byte_fsm
    from entreepy_tpu_torch.format.huffman import CodeTable

    table = body_for(et.compress(_corpus("text"), backend="host"))[0]
    lengths, codes = table.lengths.copy(), table.codes.copy()
    for sym in b"eq":
        lengths[sym] = codes[sym] = 0
    return build_byte_fsm(CodeTable(codes, lengths))


def _widest_tables(dev):
    """The widest one-pass table: s = 256 live states and m = 8 symbols per
    byte, 151,808 B fused + 65,536 B chain table in shared memory."""
    from entreepy_tpu_torch.tables import decode_tables

    t = decode_tables(_widest_fsm(), dev)
    assert (t.s, t.m, t.mt, t.fused.shape[1]) == (256, 8, 7, 593)
    return t


def _pruned_tables(dev):
    """The one-pass tables of :func:`_pruned_fsm`."""
    from entreepy_tpu_torch.tables import decode_tables

    return decode_tables(_pruned_fsm(), dev)


@pytest.mark.parametrize("kind,lanes,k", [
    ("text", 1, 512), ("text", 31, 512), ("text", 33, 50), ("text", 65, 512),
    ("text", 5958, 512), ("text", 65536, 512), ("skewed", 1, 5), ("skewed", 33, 512),
    ("skewed", 5911, 512), ("skewed", 65536, 512), ("widest", 65, 512),
    ("widest", 5958, 512), ("widest", 31, 37), ("pruned", 33, 512), ("pruned", 5958, 512),
])
def test_fused_pass_lanes(kind, lanes, k, dev):
    """The fused kernel at edge lane counts (one walking lane, part warps, a
    65,536-lane tile), chunk lengths off the byte ring, and the widest table,
    on random bytes (corrupt streams; with a pruned code table they hit
    invalid transitions): exits and row 0 exact, symbol slots where live."""
    t = {"widest": _widest_tables, "pruned": _pruned_tables}.get(
        kind, lambda d: _body(kind, 512, d)[1])(dev)
    packed = t.m <= 3
    rng = np.random.default_rng(lanes + k)
    xs = torch.from_numpy(rng.integers(0, 256, (k, lanes), dtype=np.uint8)).to(dev)
    entries = torch.from_numpy(rng.integers(0, t.s, lanes).astype(np.int32)).to(dev)
    args = (xs, t.fused, entries, t.m, t.mt, t.s, packed, k * lanes - k // 2)
    before = cuda_fsm8.fused_pass.launches
    vk, xk = cuda_fsm8.fused_pass(*args)
    vp, xp = cuda_fsm8.fused_pass_plain(*args)
    torch.cuda.synchronize()
    assert cuda_fsm8.fused_pass.launches == before + 1
    assert torch.equal(xk, xp)
    m = t.m
    j = torch.arange(m, device=dev)[None, :, None]
    if packed:
        row0k, row0p = vk >> (8 * m), vp >> (8 * m)
        sh = (8 * (m - 1 - j)).int()
        sk, sp = (vk[:, None] >> sh) & 255, (vp[:, None] >> sh) & 255
    else:
        row0k, row0p, sk, sp = vk[:, 0], vp[:, 0], vk[:, 1:], vp[:, 1:]
    assert torch.equal(row0k, row0p)
    if kind == "pruned":
        assert bool((row0p >= 16).any())
    live = j < (row0p & 15)[:, None]
    assert torch.equal(torch.where(live, sk, 0), torch.where(live, sp, 0))


@pytest.mark.parametrize("kind,chunk", [("text", 1), ("skewed", 3), ("text", 512),
                                        ("runheavy", 512)])
def test_emit_pass(kind, chunk, dev):
    xs, t, _ = _body(kind, chunk, dev)
    lanes = xs.shape[1] - (xs.shape[1] % 64 == 0)  # not a multiple of the block
    xs = xs[:, :lanes].contiguous()
    entries = _entries(t, lanes, dev)
    before = cuda_fsm8.emit_pass.launches
    sk, xk = cuda_fsm8.emit_pass(xs, t.next_state, entries)
    sp, xp = cuda_fsm8.emit_pass_plain(xs, t.next_state, entries)
    torch.cuda.synchronize()
    assert cuda_fsm8.emit_pass.launches == before + 1
    assert sk.dtype == torch.uint8 and sk.shape == xs.shape
    assert torch.equal(sk, sp) and torch.equal(xk, xp)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("lanes", [1, 31, 33, 65, 5958, 65536])
@pytest.mark.parametrize("k", [1, 3, 15, 16, 17, 33, 128, 512])
def test_emit_pass_shapes(k, lanes, s, dev):
    """The emit walk at chunk lengths below, on and off its 16-byte ring,
    one lane, part warps, the 5.2 MB text body's lane count and a
    65,536-lane tile, with a 128- and a 256-state table, on random bytes
    and entry states below S: every state and exit exact."""
    t = _body("text" if s == 128 else "skewed", 512, dev)[1]
    assert t.next_state.shape == (s, 256)
    rng = np.random.default_rng(k * lanes + s)
    xs = torch.from_numpy(rng.integers(0, 256, (k, lanes), dtype=np.uint8)).to(dev)
    entries = torch.from_numpy(rng.integers(0, s, lanes).astype(np.int32)).to(dev)
    before = cuda_fsm8.emit_pass.launches
    sk, xk = cuda_fsm8.emit_pass(xs, t.next_state, entries)
    sp, xp = cuda_fsm8.emit_pass_plain(xs, t.next_state, entries)
    torch.cuda.synchronize()
    assert cuda_fsm8.emit_pass.launches == before + 1
    assert sk.dtype == torch.uint8 and sk.shape == (k, lanes)
    assert torch.equal(sk, sp) and torch.equal(xk, xp)


def _expand_check(vk, vp, m):
    """Rows of an expansion kernel and its plain version: row 0 exact, symbol
    slots where live."""
    assert vk.shape == vp.shape == (vp.shape[0], m + 1, vp.shape[2])
    assert torch.equal(vk[:, 0], vp[:, 0])
    live = torch.arange(m, device=vp.device)[None, :, None] < (vp[:, 0] & 15)[:, None]
    assert torch.equal(torch.where(live, vk[:, 1:], 0), torch.where(live, vp[:, 1:], 0))


def _two_pass_inputs(kind, chunk, split, dev):
    """(xs uint8[K, lanes], random states < S, expand tables) of a corpus."""
    tables, buf = expand_tables_for(et.compress(_corpus(kind), backend="host"), dev, split)
    lanes = -(-buf.size // chunk) + 5  # a few padding lanes
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: buf.size] = buf
    xs = torch.from_numpy(np.ascontiguousarray(padded.reshape(lanes, chunk).T)).to(dev)
    rng = np.random.default_rng(chunk)
    states = torch.from_numpy(rng.integers(0, tables.s, xs.shape).astype(np.uint8)).to(dev)
    return xs, states, tables


@pytest.mark.parametrize("kind,m", [("random", 1), ("skewed", 4), ("runheavy", 8),
                                    ("text", 3)])
def test_expand_pass_split(kind, m, dev):
    xs, states, t = _two_pass_inputs(kind, 512, True, dev)
    assert t.m == m and t.table.shape == (256, 2 * t.s + 9 * (t.mt + 1))
    before = cuda_fsm8.expand_pass_split.launches
    vk = cuda_fsm8.expand_pass_split(xs, states, t.table, t.m, t.mt)
    vp = cuda_fsm8.expand_pass_split_plain(xs, states, t.table, t.m, t.mt)
    torch.cuda.synchronize()
    assert cuda_fsm8.expand_pass_split.launches == before + 1
    _expand_check(vk, vp, m)


def _split_tables(kind, dev):
    """Split expand tables: a corpus's, the widest (m = 8, 256 x 584 B =
    146 KB of shared memory) or the pruned text table's."""
    from entreepy_tpu_torch.tables import expand_tables

    fsm = {"widest": _widest_fsm, "pruned": _pruned_fsm}.get(kind)
    if fsm is not None:
        return expand_tables(fsm(), dev, split=True)
    return expand_tables_for(et.compress(_corpus(kind), backend="host"), dev, True)[0]


@pytest.mark.parametrize("kind,m", [("random", 1), ("text", 3), ("skewed", 4), ("widest", 8),
                                    ("pruned", 3)])
@pytest.mark.parametrize("lanes", [1, 33, 64, 5958])
@pytest.mark.parametrize("k", [1, 17, 512])
def test_expand_pass_split_shapes(k, lanes, kind, m, dev):
    """The split kernel's uint8 rows at one and a few rows (a warp's share
    crossing rows), one lane, part groups of 8 lanes, a multiple of 8 (no
    row padding) and the 5.2 MB text body's lane count (not a multiple of
    4), m from 1 to 8, the 146 KB table and a pruned table whose random
    bytes hit invalid transitions: row 0 exact, symbol slots where live."""
    t = _split_tables(kind, dev)
    assert t.m == m and t.table.shape == (256, 2 * t.s + 9 * (t.mt + 1))
    if kind == "widest":
        assert t.table.numel() == 256 * 584
    rng = np.random.default_rng(k * lanes + m)
    xs = torch.from_numpy(rng.integers(0, 256, (k, lanes), dtype=np.uint8)).to(dev)
    states = torch.from_numpy(rng.integers(0, t.s, (k, lanes)).astype(np.uint8)).to(dev)
    before = cuda_fsm8.expand_pass_split.launches
    vk = cuda_fsm8.expand_pass_split(xs, states, t.table, t.m, t.mt)
    vp = cuda_fsm8.expand_pass_split_plain(xs, states, t.table, t.m, t.mt)
    torch.cuda.synchronize()
    assert cuda_fsm8.expand_pass_split.launches == before + 1
    assert vk.dtype == vp.dtype == torch.uint8
    assert vk.is_contiguous() is (lanes % 8 == 0)
    _expand_check(vk, vp, m)
    if kind == "pruned" and k * lanes >= 512:
        assert bool((vp[:, 0] >= 16).any())


@pytest.mark.parametrize("kind,table_bytes", [("skewed", 320 * 1024), ("runheavy", 576 * 1024),
                                              ("text", 128 * 1024)])
def test_expand_pass(kind, table_bytes, dev):
    """Tables beyond a block's 227 KB of shared memory included."""
    xs, states, t = _two_pass_inputs(kind, 100, False, dev)
    assert t.mt is None and t.table.numel() == table_bytes
    before = cuda_fsm8.expand_pass.launches
    vk = cuda_fsm8.expand_pass(xs, states, t.table, t.m)
    vp = cuda_fsm8.expand_pass_plain(xs, states, t.table, t.m)
    torch.cuda.synchronize()
    assert cuda_fsm8.expand_pass.launches == before + 1
    assert vk.dtype == vp.dtype == torch.uint8
    _expand_check(vk, vp, t.m)


def _full_tables(kind, dev):
    """Full expand tables: a corpus's or the pruned text table's."""
    from entreepy_tpu_torch.tables import expand_tables

    if kind == "pruned":
        return expand_tables(_pruned_fsm(), dev, split=False)
    return expand_tables_for(et.compress(_corpus(kind), backend="host"), dev, False)[0]


@pytest.mark.parametrize("kind,m,vector_bytes", [
    ("text", 3, 128 * 1024),       # staged in shared memory
    ("pruned", 3, 128 * 1024),     # staged; random bytes hit invalid transitions
    ("random", 1, 256 * 1024),     # 4-byte entries through L2 (S = 256)
    ("skewed", 4, 512 * 1024),     # 8-byte entries through L2
    ("runheavy", 8, 1024 * 1024),  # 16-byte entries through L2
])
@pytest.mark.parametrize("lanes", [1, 7, 8, 9, 5958])
@pytest.mark.parametrize("k", [1, 17, 512])
def test_expand_pass_shapes(k, lanes, kind, m, vector_bytes, dev):
    """The full-table kernel's uint8 rows at one and a few rows (a warp's
    share crossing rows), one lane, part groups of 8 lanes, a multiple of 8
    (no row padding) and the 5.2 MB text body's lane count, through each
    table path (the vector table staged in shared memory, or read through
    L2 with 4-, 8- and 16-byte entries), on random bytes and states below S:
    every row value exact, dead slots included."""
    t = _full_tables(kind, dev)
    assert t.m == m and t.mt is None
    assert cuda_fsm8.expand_vector_table(t.table, m).numel() == vector_bytes
    rng = np.random.default_rng(k * lanes + m)
    xs = torch.from_numpy(rng.integers(0, 256, (k, lanes), dtype=np.uint8)).to(dev)
    states = torch.from_numpy(rng.integers(0, t.s, (k, lanes)).astype(np.uint8)).to(dev)
    before = cuda_fsm8.expand_pass.launches
    vk = cuda_fsm8.expand_pass(xs, states, t.table, m)
    vp = cuda_fsm8.expand_pass_plain(xs, states, t.table, m)
    torch.cuda.synchronize()
    assert cuda_fsm8.expand_pass.launches == before + 1
    assert vk.dtype == vp.dtype == torch.uint8 and vk.shape == (k, m + 1, lanes)
    assert vk.is_contiguous() is (lanes % 8 == 0)
    assert torch.equal(vk, vp)
    if kind == "pruned" and k * lanes >= 512:
        assert bool((vp[:, 0] >= 16).any())


@pytest.mark.parametrize("m", range(1, 9))
def test_expand_vector_table_pad_written(m, dev):
    """The kernel loads each vector-table entry whole, pad bytes included,
    so the relayout writes them: under a poisoned guard band (the table's
    allocation filled with 0xA5 first) every pad byte is 0."""
    sk = _sanitize_kernels()
    rng = np.random.default_rng(m)
    t_exp = torch.from_numpy(rng.integers(0, 256, (256, (m + 1) * 256), dtype=np.uint8)).to(dev)
    with sk.Guard(0xA5):
        vec = cuda_fsm8.expand_vector_table(t_exp, m)
    assert torch.equal(vec[:, :, : m + 1], t_exp.view(256, m + 1, 256).transpose(1, 2))
    assert bool((vec[:, :, m + 1:] == 0).all())


def _sanitize_kernels():
    import sys

    sys.path.insert(0, str(DATA.parent.parent / "tools"))
    import sanitize_kernels

    return sanitize_kernels


@pytest.mark.parametrize("kind", ["text", "skewed", "runheavy"])
def test_expand_pass_prebuilt_vector_table(kind, dev):
    """The decode's tables carry the vector table, built once per table
    (pads 0); the kernel given it writes the rows it builds per call, and a
    vector table of the wrong entry width raises."""
    t = _full_tables(kind, dev)
    assert t.vec is not None
    assert t.vec.shape == (256, t.s, 4 if t.m < 4 else 8 if t.m < 8 else 16)
    assert torch.equal(t.vec, cuda_fsm8.expand_vector_table(t.table, t.m))
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.integers(0, 256, (37, 300), dtype=np.uint8)).to(dev)
    states = torch.from_numpy(rng.integers(0, t.s, (37, 300)).astype(np.uint8)).to(dev)
    assert torch.equal(cuda_fsm8.expand_pass(xs, states, t.table, t.m, t.vec),
                       cuda_fsm8.expand_pass(xs, states, t.table, t.m))
    with pytest.raises(ValueError, match="vector table"):
        cuda_fsm8.expand_pass(xs, states, t.table, t.m, t.vec[:, :, :2].contiguous())


@pytest.mark.parametrize("lanes", [7, 5958])
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("m", range(1, 9))
def test_expand_pass_every_m(m, s, lanes, dev):
    """Every instantiation of the full-table kernel, one per (m, table path):
    a random uint8[256, (m+1)S] table (the kernel and its plain version only
    index it), random bytes and states below S; every row value exact."""
    rng = np.random.default_rng(16 * m + s + lanes)
    table = torch.from_numpy(rng.integers(0, 256, (256, (m + 1) * s), dtype=np.uint8)).to(dev)
    xs = torch.from_numpy(rng.integers(0, 256, (33, lanes), dtype=np.uint8)).to(dev)
    states = torch.from_numpy(rng.integers(0, s, (33, lanes)).astype(np.uint8)).to(dev)
    before = cuda_fsm8.expand_pass.launches
    vk = cuda_fsm8.expand_pass(xs, states, table, m)
    vp = cuda_fsm8.expand_pass_plain(xs, states, table, m)
    torch.cuda.synchronize()
    assert cuda_fsm8.expand_pass.launches == before + 1
    assert vk.dtype == torch.uint8 and vk.shape == (33, m + 1, lanes)
    assert torch.equal(vk, vp)


@pytest.mark.parametrize("expand", ["onepass", "split", "fused", "host"])
@pytest.mark.parametrize("kind", ["text", "skewed", "runheavy"])
def test_decode_routes(kind, expand, dev):
    """Every decode route round-trips on the card, through its kernels."""
    data = _corpus(kind)
    blob = et.compress(data, backend="host")
    kernels = {"split": cuda_fsm8.expand_pass_split, "fused": cuda_fsm8.expand_pass,
               "host": cuda_fsm8.emit_pass, "onepass": cuda_fsm8.fused_pass}
    before = kernels[expand].launches
    calls = decode8.decode_host.calls
    assert et.decompress(blob, backend="device", expand=expand) == data
    assert kernels[expand].launches > before
    assert decode8.decode_host.calls == calls


@pytest.mark.parametrize("expand", ["onepass", "split", "fused", "host"])
@pytest.mark.parametrize("kind", ["text", "skewed"])
def test_sharded_world1_routes(kind, expand, dev):
    """The sharded backend at one rank (no process group) round-trips on the
    card through every route, with the host codec's .et, through the
    kernels and with no host fallback."""
    data = _corpus(kind)
    blob = et.compress(data, backend="host")
    kernels = {"split": cuda_fsm8.expand_pass_split, "fused": cuda_fsm8.expand_pass,
               "host": cuda_fsm8.emit_pass, "onepass": cuda_fsm8.fused_pass}
    packs, before = cuda_pack.pack_blocks.launches, kernels[expand].launches
    calls = decode8.decode_host.calls
    assert et.compress(data, backend="sharded") == blob
    assert cuda_pack.pack_blocks.launches == packs + 1
    assert et.decompress(blob, backend="sharded", expand=expand) == data
    assert kernels[expand].launches > before
    assert decode8.decode_host.calls == calls


@pytest.mark.parametrize("kind,lanes,steps,offset", [
    ("text", 100, 1024, 0), ("fib", 65, 256, 0), ("skewed", 1, 64, 0),
    ("text", 5079, 1024, 0),    # the encode plane of the 5.2 MB text
    ("fib", 300, 1024, 0),      # many words of 31-bit codes per block
    ("text", 70, 100, 0),       # steps off the 16-byte loads: byte loads, a part segment
    ("skewed", 33, 1100, 0),    # more than 16 segments: two rounds
    ("fib", 40, 2085, 0),       # three rounds, the last a part segment
    ("text", 64, 1024, 1),      # a row that is not 16-byte aligned: byte loads
    ("text", 3, 1, 0),          # one step
    ("wide", 97, 1024, 0),      # codes of up to 32 bits
])
def test_pack_blocks(kind, lanes, steps, offset, dev):
    """The pack kernel against its serial plain version: emitted, acc and
    nbits exact, words where emitted; blocks of 0, 1, all and a random
    number of live bytes."""
    rng = np.random.default_rng(11)
    if kind == "wide":  # not a prefix code: the pack only lays codes end to end
        blocks = rng.integers(0, 256, (lanes, steps)).astype(np.uint8)
        lengths = rng.integers(1, 33, 256).astype(np.uint8)
        lengths[:16] = 32
        codes = np.array([rng.integers(0, 1 << int(n)) for n in lengths], np.int64)
        codes, lengths = (torch.from_numpy(codes.astype(np.uint32)).to(dev),
                          torch.from_numpy(lengths).to(dev))
    elif kind == "fib":  # 31-bit-deep code: long codes cross the word boundary
        counts = np.zeros(32, np.int64)
        a, b = 1, 1
        for sym in range(32):
            counts[sym], a, b = a, b, a + b
        table_src = np.repeat(np.arange(32, dtype=np.uint8), counts).tobytes()
        blocks = rng.integers(0, 32, (lanes, steps)).astype(np.uint8)
        codes, lengths = code_tensors_for(et.compress(table_src, backend="host"), dev)
    else:
        src = _corpus(kind)
        table_src = (src * -(-lanes * steps // len(src)))[: lanes * steps]
        blocks = np.frombuffer(table_src, np.uint8).reshape(lanes, steps).copy()
        codes, lengths = code_tensors_for(et.compress(table_src, backend="host"), dev)
    valid = rng.integers(0, steps + 1, lanes).astype(np.int32)
    valid[0] = steps
    valid[1:3] = [0, 1][: lanes - 1]
    flat = torch.zeros(offset + lanes * steps, dtype=torch.uint8, device=dev)
    flat[offset:] = torch.from_numpy(blocks.reshape(-1)).to(dev)
    blocks = flat[offset:].view(lanes, steps)
    assert (blocks.data_ptr() % 16 == 0) is (offset == 0)
    valid = torch.from_numpy(valid).to(dev)
    before = cuda_pack.pack_blocks.launches
    wk, ek, ak, nk = cuda_pack.pack_blocks(blocks, valid, codes, lengths)
    wp, ep, ap, np_ = cuda_pack.pack_blocks_plain(blocks, valid, codes, lengths)
    torch.cuda.synchronize()
    assert cuda_pack.pack_blocks.launches == before + 1
    assert torch.equal(ek, ep) and torch.equal(nk, np_)
    assert torch.equal(ak.view(torch.int32), ap.view(torch.int32))
    live_k = torch.where(ep, wk.view(torch.int32), 0)
    assert torch.equal(live_k, torch.where(ep, wp.view(torch.int32), 0))


@pytest.mark.parametrize("k,lanes,sub,cap", [
    (512, 100, 256, 64), (96, 33, 24, 16), (64, 1, 64, 64),
    (256, 130, 256, 64),     # sub = k: one group
    (128, 70, 128, 16),      # cap far below the live count: counts overflow it
    (96, 129, 32, 32),       # cap = sub
    (400, 65, 200, 48),      # a subgroup across chunks of staged rows
    (1024, 5079, 256, 64),   # the encode plane (5.2 MB text, 1 KiB blocks)
    (2048, 5911, 32, 32),    # the m > 3 one-pass decode (5 MB skewed)
    (1536, 5958, 24, 24),    # the two-pass text rows (m = 3)
    (600, 40, 600, 600),     # a whole chunk's rows in one subgroup
    (2000, 9, 2000, 2000),   # a cap wider than the output tile: the serial kernel
])
def test_compact_rows(k, lanes, sub, cap, dev):
    rng = np.random.default_rng(k + lanes)
    wk = torch.from_numpy(rng.integers(-2**31, 2**31, (k, lanes)).astype(np.int32)).to(dev)
    ek = torch.from_numpy(rng.random((k, lanes)) < (0.5 if cap < sub // 4 else 0.3)).to(dev)
    ek[:, 0] = False  # all-dead lane
    if lanes > 1:
        ek[:, 1] = True  # full lane: truncated at cap
    before = cuda_compact.compact_rows.launches
    got = cuda_compact.compact_rows(wk, ek, sub, cap)
    want = cuda_compact.compact_rows_plain(wk, ek, sub, cap)
    torch.cuda.synchronize()
    assert cuda_compact.compact_rows.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if cap < sub:
        assert bool((want[1] > cap).any())  # some subgroup overflows its cap


def test_wrappers_reject_bad_operands(dev):
    xs = torch.zeros((8, 4), dtype=torch.uint8, device=dev)
    tbl = torch.zeros((128, 256), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        cuda_fsm8.sync_pass(xs, tbl, torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        cuda_fsm8.sync_pass(xs.t(), tbl, torch.zeros(8, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        cuda_compact.compact_rows(torch.zeros((8, 4), dtype=torch.int32, device=dev),
                                  torch.zeros((8, 4), dtype=torch.bool), 8, 8)
    with pytest.raises(ValueError):  # entries shorter than the lanes
        cuda_fsm8.emit_pass(xs, tbl, torch.zeros(3, dtype=torch.int32, device=dev))
    split = torch.zeros((256, 2 * 128 + 9 * 3), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):  # states not uint8
        cuda_fsm8.expand_pass_split(xs, xs.int(), split, 3, 2)
    with pytest.raises(ValueError):  # the split table of another mt
        cuda_fsm8.expand_pass_split(xs, xs, split, 3, 1)
    with pytest.raises(ValueError):  # a full table is (m + 1) * S wide
        cuda_fsm8.expand_pass(xs, xs, split, 3)
    full = torch.zeros((256, 10 * 128), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):  # m above 8: no kernel has ten rows
        cuda_fsm8.expand_pass(xs, xs, full, 9)
    with pytest.raises(ValueError):  # a full table of another dtype
        cuda_fsm8.expand_pass(xs, xs, full[:, :512].int(), 3)


@pytest.mark.parametrize("tile_lanes", [1, 7, 64])
@pytest.mark.parametrize("kind", ["text", "skewed"])
def test_tiled_decode(kind, tile_lanes, dev):
    """The streaming decode on the card equals the default route's single
    tile, packed rows (text) and unpacked rows through the compaction
    kernel (skewed), each tile's fetch overlapping the next tile's decode:
    one sync pass per tile."""
    data = _corpus(kind, 20000)
    blob = et.compress(data, backend="host")
    table, n, buf = body_for(blob)
    assert (decode_tables_for(blob, dev)[0].m <= 3) is (kind == "text")
    calls = decode8.decode_host.calls
    before = cuda_fsm8.sync_pass.launches
    one_tile = decode8.decode_body_device_full(buf, table, n, device=dev, chunk_bytes=64)
    assert cuda_fsm8.sync_pass.launches - before == 1
    before = cuda_fsm8.sync_pass.launches
    tiled = decode8.decode_body_device_tiled(buf, table, n, device=dev, chunk_bytes=64,
                                             tile_lanes=tile_lanes)
    lanes = -(-buf.size // 64)
    assert cuda_fsm8.sync_pass.launches - before == -(-lanes // tile_lanes)
    assert np.array_equal(tiled, one_tile) and bytes(tiled) == data
    assert decode8.decode_host.calls == calls


def test_tiled_encode(dev):
    from entreepy_tpu_torch.ops import encode

    data = _corpus("text", 50000)
    before = cuda_pack.pack_blocks.launches
    out = encode.compress_device(data, device=dev, block_bytes=256, tile_blocks=4)
    assert out == et.compress(data, backend="host")
    assert cuda_pack.pack_blocks.launches - before == -(-len(data) // 1024)


# --- the fuzz twin (tests/test_torch_fuzz.py) on the card ---

FUZZ_SEEDS = {"text": 11, "random": 12, "skewed": 13, "runheavy": 14}
ROUTES = ("onepass", "split", "fused", "host")


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return None


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ["text", "random", "skewed", "runheavy"])
def test_fuzz_card(kind, route, dev):
    """The bench's corpus families at random sizes through the device and
    sharded (one rank) backends on the card: the host codec's .et, exact
    round trips; an overlong stream rejected; a relaxed single-symbol file
    round-trips."""
    from entreepy_tpu_torch.bench.corpus import make_corpus

    rng = np.random.default_rng(FUZZ_SEEDS[kind])
    for _ in range(2):
        data = make_corpus(kind, int(rng.integers(5_000, 30_000)))
        ref = et.compress(data, backend="host")
        for backend in ("device", "sharded"):
            assert et.compress(data, backend=backend) == ref
            assert et.decompress(ref, backend=backend, expand=route) == data
            with pytest.raises(ValueError):
                et.decompress(ref + b"\x00" * 4, backend=backend, expand=route)
    relaxed = et.compress(b"a" * 1000, strict=False, backend="host")
    assert decode8.decompress_device(relaxed, device=dev, chunk_bytes=16,
                                     expand=route) == b"a" * 1000


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ["skewed", "runheavy"])
def test_fuzz_corruption_card(kind, route, dev):
    """Single-bit corruptions: accepted or rejected on the card as the host
    backend does it, and an accepted one decodes to the host's bytes."""
    from entreepy_tpu_torch.bench.corpus import make_corpus
    from entreepy_tpu_torch.format import parse_header

    rng = np.random.default_rng(FUZZ_SEEDS[kind] + 100)
    good = et.compress(make_corpus(kind, 10_000), backend="host")
    hdr = parse_header(good)
    for _ in range(4):
        pos = int(rng.integers(hdr.body_start + 2, len(good) - 8))
        bad = good[:pos] + bytes([good[pos] ^ (1 << int(rng.integers(8)))]) + good[pos + 1:]
        host = _outcome(lambda: et.decompress(bad, backend="host"))
        for backend in ("device", "sharded"):
            assert _outcome(lambda: et.decompress(bad, backend=backend, expand=route)) == host


# --- the bench (tests/test_torch_bench.py) on the card ---

def _bench(*argv: str) -> tuple[list[dict], str]:
    r = subprocess.run([sys.executable, "-m", "entreepy_tpu_torch.bench", *argv],
                       cwd=DATA.parent.parent, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")], r.stderr


def test_bench_headline_card(dev):
    """The headline at 1 MB on the card: its probe's figures positive, each
    bound share at most 100 %, every kernel launched by its device rows."""
    (line,), err = _bench("--bytes", "1000000")
    assert line["device"]["platform"] == "gpu" and line["corpus_bytes"] == 1_000_000
    probe = {k: v for k, v in line.items() if k.startswith("cuda_")}
    assert len(probe) == 13 and all(v > 0 for v in probe.values())
    assert all(v <= 100 for k, v in probe.items() if k.endswith("_bound_pct"))
    assert all(r["ok"] for r in line["rows"]) and all(line["launches"].values())
    assert "[bench] modules of jax or entreepy_tpu imported: []" in err


def test_bench_weak_card(dev):
    """Worlds 1 and 2 on cuda:0 (a gloo group), the .et and round trips exact."""
    rows, _ = _bench("weak", "--worlds", "1,2", "--per-rank-mb", "0.5")
    assert [r["processes"] for r in rows] == [1, 2]
    for r in rows:
        assert r["et_equals_host"] and r["round_trip"] and r["weak_eff_decode"] > 0
        assert r["launches"]["sync_pass"] > 0 and r["launches"]["pack_blocks"] > 0
