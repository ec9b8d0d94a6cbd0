"""The symbols kernel's plain versions (``ops/cuda_symbols``) and the decode
routes that end in them, on the CPU, against the numpy selection the host
made before the extraction moved to the device: the compacted plane
transposed lane-major, then one boolean selection over every slot. That
selection is kept here, as this file's own reference, over planes the JAX
package compacts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from entreepy_tpu.ops import decode8 as jd  # noqa: E402

from entreepy_tpu_torch import trace  # noqa: E402
from entreepy_tpu_torch.bench import make_corpus  # noqa: E402
from entreepy_tpu_torch.format import compress_host  # noqa: E402
from entreepy_tpu_torch.ops import cuda_symbols, decode8  # noqa: E402
from entreepy_tpu_torch.tables import body_for, decode_tables_for  # noqa: E402


def numpy_selection(plane, mini_tot) -> np.ndarray:
    """The host's former extraction: a compacted plane [rows, lanes] and its
    subgroup totals [Gs, lanes], transposed lane-major, then every slot
    below its subgroup's total, in (lane, subgroup, slot) order."""
    mt = np.ascontiguousarray(np.asarray(mini_tot, dtype=np.int64).T)  # [lanes, Gs]
    lanes, gs = mt.shape
    arr = np.ascontiguousarray(np.asarray(plane).T).reshape(lanes, gs, -1)
    mask = np.arange(arr.shape[2], dtype=np.int64)[None, None, :] < mt[:, :, None]
    return arr[mask]


def _words(rng, k: int, lanes: int, m: int, pad_lanes: int) -> np.ndarray:
    """MASKED packed words int32[k, lanes]: counts 0..m, about 1 in 40
    words invalid, random bytes in every slot (dead ones included), and the
    last ``pad_lanes`` lanes padding (all zero)."""
    raw = rng.integers(0, m + 1, (k, lanes))
    raw[rng.random((k, lanes)) < 0.025] = 16
    raw[:, lanes - pad_lanes:] = 0
    syms = rng.integers(0, 1 << (8 * m), (k, lanes))
    syms[:, lanes - pad_lanes:] = 0
    return (raw << (8 * m) | syms).astype(np.int32)


@pytest.mark.parametrize("k,lanes,pad", [(16, 37, 5), (64, 33, 1), (100, 3, 0)])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_packed_form_matches_numpy_selection(m, k, lanes, pad):
    """Packed words: the count launch's lane_tot and w_inv are the JAX
    dense compaction's, and the write launch's symbols its plane's numpy
    selection, stream order, padding lanes and invalid words included."""
    words = _words(np.random.default_rng(m * 1000 + k), k, lanes, m, pad)
    plane, mini, lane_tot, w_inv = jd.compact_symbols_dense(jnp.asarray(words), m)
    want = numpy_selection(plane, mini)
    tw = torch.from_numpy(words)
    got_tot, got_inv = cuda_symbols.symbol_counts(tw, m)
    assert np.array_equal(got_tot.numpy(), np.asarray(lane_tot))
    assert np.array_equal(got_inv.numpy(), np.asarray(w_inv))
    assert (got_inv.numpy() < decode8.NO_INVALID).any()
    ends = got_tot.cumsum(0, dtype=torch.int64)
    got = cuda_symbols.write_symbols(tw, ends, int(ends[-1]), m)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    syms, tot, inv = decode8.packed_symbols(tw, m)
    assert np.array_equal(syms.numpy(), want)
    assert torch.equal(tot, got_tot) and torch.equal(inv, got_inv)


@pytest.mark.parametrize("lanes", [1, 40])
@pytest.mark.parametrize("m", [4, 8])
def test_plane_form_matches_numpy_selection(m, lanes):
    """A subgroup plane (m > 3 and the two-pass routes): the write launch's
    symbols are the numpy selection of the JAX compaction's plane, and
    :func:`decode8.plane_symbols`, given those slots as unpacked rows,
    passes its lane_tot and w_inv through."""
    rng = np.random.default_rng(m + lanes)
    k = 64
    counts = rng.integers(0, m + 1, (k, lanes)).astype(np.int32)
    inv = rng.random((k, lanes)) < 0.02
    counts[inv] = 0
    syms = rng.integers(0, 256, (k, m, lanes), dtype=np.uint8)
    cap = decode8.sym_cap(torch.from_numpy(counts), m)
    plane, mini, lane_tot, w_inv = jd.compact_symbols_device(
        jnp.asarray(counts), jnp.asarray(inv), jnp.asarray(syms), m, cap)
    want = numpy_selection(plane, mini)
    tplane = torch.from_numpy(np.asarray(plane).astype(np.uint8))
    tmini = torch.from_numpy(np.asarray(mini).astype(np.int32))
    ends = tmini.sum(0).cumsum(0)
    got = cuda_symbols.write_symbols(tplane, ends, int(ends[-1]), 1, tmini, cap)
    assert np.array_equal(got.numpy(), want)
    # the same slots as unpacked rows (count | 16*invalid, then m slots), every byte real
    raw = (counts + 16 * inv).astype(np.uint8)
    vals = np.concatenate([raw[:, None], syms], axis=1)
    out, tot, winv = decode8.plane_symbols(torch.from_numpy(vals), m, k * lanes)
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(tot.numpy(), np.asarray(lane_tot))
    assert np.array_equal(winv.numpy(), np.asarray(w_inv))


def _fused_vals(et: bytes):
    """(fused-pass rows at the fixed point, m, packed, n_valid) of an .et on
    the CPU, as the one-pass route makes them."""
    tables, buf = decode_tables_for(et, "cpu")
    chunk = decode8.DEFAULT_CHUNK_BYTES
    lanes = -(-buf.size // chunk)
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: buf.size] = buf
    cols = decode8.bytes_to_cols(padded, lanes, chunk, "cpu")
    packed = tables.m <= 3
    vals, _, unconverged = decode8.fsm8_decode_fused(
        cols, tables.next_state, tables.fused, lanes, tables.m, tables.mt, tables.s,
        packed=packed, n_valid=buf.size)
    assert not unconverged
    return vals, tables.m, packed, buf.size


@pytest.mark.parametrize("kind", ["text", "skewed", "runheavy"])
def test_onepass_route_matches_numpy_selection(kind):
    """The one-pass route's symbols, from the fused pass's rows, are the
    numpy selection of the plane the route made before (the dense plane for
    m <= 3, the subgroup plane of the masked rows above), and the decode
    through the API returns the document."""
    import entreepy_tpu_torch as et

    data = make_corpus(kind, 30_000)
    blob = compress_host(data)
    vals, m, packed, n_valid = _fused_vals(blob)
    assert packed == (kind == "text")
    if packed:
        plane, mini, _, _ = cuda_symbols.compact_symbols_dense(vals, m)
    else:
        c, i, s = decode8._expand_mask(vals[:, 0], vals[:, 1:].to(torch.uint8), n_valid)
        plane, mini, _, _ = decode8.compact_symbols_device(c, i, s, m, decode8.sym_cap(c, m))
    want = numpy_selection(plane.numpy(), mini.numpy())
    got, _, _ = decode8.onepass_symbols(vals, m, packed, n_valid)
    assert np.array_equal(got.numpy(), want)
    assert bytes(want[: len(data)]) == data
    for route in decode8.EXPAND_MODES:
        assert et.decompress(blob, backend="device", device="cpu", expand=route) == data


@pytest.mark.parametrize("tile_lanes", [1, 3, 5])
@pytest.mark.parametrize("kind", ["text", "skewed"])
def test_tiles_keep_stream_order(kind, tile_lanes):
    """Several tiles (the ``tile_lanes`` hook): each tile's symbols land
    after the previous tile's, so the output is the document, packed (text)
    and through the plane form (skewed)."""
    data = make_corpus(kind, 8_000)
    table, n, buf = body_for(compress_host(data))
    lanes = -(-buf.size // 64)
    assert lanes > 2 * tile_lanes
    with trace.record_stages() as rec:
        got = decode8.decode_body_device_tiled(buf, table, n, device="cpu", chunk_bytes=64,
                                               tile_lanes=tile_lanes)
    assert bytes(got) == data
    assert rec.counts["d2h_bytes"] == rec.counts["symbols"] + 8 * lanes


def _pruned(at: int):
    """(body, table missing the symbol "g", n_symbols of the document) of a
    document whose one "g" sits at symbol ``at``: its bits walk a dead trie
    edge there."""
    from entreepy_tpu_torch.format import build_code_table, histogram, pack_body_host
    from entreepy_tpu_torch.format.huffman import CodeTable

    data = (b"abcdef" * 400)[:at] + b"g" + (b"abcdef" * 400)[at:]
    arr = np.frombuffer(data, np.uint8)
    table = build_code_table(histogram(arr))
    body, _ = pack_body_host(arr, table)
    lengths, codes = table.lengths.copy(), table.codes.copy()
    lengths[ord("g")] = codes[ord("g")] = 0
    return np.frombuffer(body, np.uint8), CodeTable(codes, lengths), arr.size


def _outcome(fn):
    try:
        return bytes(fn())
    except ValueError as e:
        return ("raised", str(e))


@pytest.mark.parametrize("expand", ["onepass", "split", "fused"])
@pytest.mark.parametrize("n", [1300, 1201, 1200, 600])
def test_invalid_transition_before_and_after_the_last_symbol(n, expand):
    """The document's "g" is symbol 1201. With n_symbols past it, the invalid
    transition is consumed: refused through the lane's w_inv (the count
    launch's, or the compaction's), as the serial walk refuses it. With
    n_symbols at or before symbol 1200 it lies after the last symbol: not
    consumed, so only the exact-bit check speaks, in the serial walk's
    words."""
    body, table, _ = _pruned(1200)
    want = _outcome(lambda: decode8.decode_host(body, table, n))
    got = _outcome(lambda: decode8.decode_body_device_tiled(body, table, n, device="cpu",
                                                            chunk_bytes=64, expand=expand))
    assert isinstance(got, tuple) and isinstance(want, tuple)
    if n > 1200:
        assert got[1] == "invalid bitstream: unreachable trie edge"
        assert want[1].startswith("invalid bitstream")
    else:
        assert got == want and "corrupt bitstream" in got[1]


@pytest.mark.parametrize("expand", ["onepass", "split"])
def test_cap_overflow_still_raises(expand, monkeypatch):
    """A subgroup cap below a subgroup's symbols (a sizing fault) poisons
    lane_tot to -1; the plane form writes only the slots the plane kept and
    the accept/reject refuses the decode."""
    data = make_corpus("skewed", 8_000) if expand == "onepass" else make_corpus("text", 8_000)
    table, n, buf = body_for(compress_host(data))
    monkeypatch.setattr(decode8, "sym_cap", lambda counts, m: 1)
    with pytest.raises(ValueError, match="ended early"):
        decode8.decode_body_device_tiled(buf, table, n, device="cpu", chunk_bytes=64,
                                         expand=expand)


def test_wrappers_reject_bad_operands():
    words = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):  # the packed form holds m <= 3
        cuda_symbols.symbol_counts(words, 4)
    with pytest.raises(ValueError):  # no lanes
        cuda_symbols.symbol_counts(torch.zeros((8, 0), dtype=torch.int32), 3)
    with pytest.raises(ValueError):  # ends of other lanes
        cuda_symbols.write_symbols(words, torch.zeros(3, dtype=torch.int64), 0, 3)
    with pytest.raises(ValueError):  # a plane of other rows than Gs * cap
        cuda_symbols.write_symbols(torch.zeros((8, 4), dtype=torch.uint8),
                                   torch.zeros(4, dtype=torch.int64), 0, 1,
                                   torch.zeros((3, 4), dtype=torch.int32), 2)
    with pytest.raises(ValueError):  # a total the counts do not give
        cuda_symbols.write_symbols(words | (1 << 24), torch.arange(1, 5) * 8, 5, 3)
