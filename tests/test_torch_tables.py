"""The port's device tables and constants against the JAX package's."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entreepy_tpu.format import (  # noqa: E402
    build_code_table, compress_host, histogram, parse_header,
)
from entreepy_tpu.format.fsm8 import build_byte_fsm, fused_decode_tensors  # noqa: E402
from entreepy_tpu.ops import bitpack as jax_bitpack  # noqa: E402
from entreepy_tpu.ops import decode8 as jax_decode8  # noqa: E402
from entreepy_tpu.ops import encode as jax_encode  # noqa: E402

from entreepy_tpu_torch import tables, trace  # noqa: E402
from entreepy_tpu_torch.format import fsm8 as port_fsm8  # noqa: E402
from entreepy_tpu_torch.ops import bitpack, cuda_tables, decode8, encode  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"


def _corpus(kind: str) -> bytes:
    rng = np.random.default_rng(3)
    if kind == "skewed":  # m = 4, s = 256: the widest fused table class
        p = 1.0 / np.arange(1, 257) ** 1.3
        return rng.choice(256, 20000, p=p / p.sum()).astype(np.uint8).tobytes()
    if kind == "runheavy":  # m = 8: 1-bit codes
        return (b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()) * 3
    if kind == "random":  # m = 1, all codes 8 bits
        return rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    raise ValueError(kind)


@pytest.fixture(params=["macbeth", "midsummer", "skewed", "runheavy", "random"])
def table(request):
    if request.param in ("macbeth", "midsummer"):
        data = request.getfixturevalue(request.param)
    else:
        data = _corpus(request.param)
    return build_code_table(histogram(np.frombuffer(data, np.uint8)))


def test_decode_tables_match_fsm8(table):
    fsm = build_byte_fsm(table)
    got = tables.decode_tables(fsm, "cpu")
    ref, m, mt, s = fused_decode_tensors(fsm)
    assert (got.m, got.mt, got.s) == (m, mt, s)
    assert got.fused.dtype == torch.uint8 and got.next_state.dtype == torch.uint8
    assert np.array_equal(got.fused.numpy(), ref)
    assert np.array_equal(got.next_state.numpy(), fsm.sync_table())


def test_code_tensors_match_code_table_cols(table):
    codes, lengths = tables.code_tensors(table, "cpu")
    cols = jax_bitpack.code_table_cols(table.codes, table.lengths).astype(np.int64)
    assert codes.dtype == torch.uint32 and lengths.dtype == torch.uint8
    assert np.array_equal(lengths.numpy(), cols[:, 0])
    limbs = (cols[:, 1] << 24) | (cols[:, 2] << 16) | (cols[:, 3] << 8) | cols[:, 4]
    assert np.array_equal(codes.numpy().astype(np.int64), limbs)


@pytest.mark.parametrize("name", ["macbeth", "skewed"])
def test_tables_for_et_file(name, request):
    data = request.getfixturevalue(name) if name == "macbeth" else _corpus(name)
    et = compress_host(data)
    hdr = parse_header(et)
    got, body = tables.decode_tables_for(et, "cpu")
    want = tables.decode_tables(build_byte_fsm(hdr.table), "cpu")
    assert (got.m, got.mt, got.s) == (want.m, want.mt, want.s)
    assert torch.equal(got.fused, want.fused) and torch.equal(got.next_state, want.next_state)
    assert body.tobytes() == et[hdr.body_start:]
    codes, lengths = tables.code_tensors_for(et, "cpu")
    assert np.array_equal(codes.numpy(), hdr.table.codes.astype(np.uint32))
    assert np.array_equal(lengths.numpy(), hdr.table.lengths.astype(np.uint8))


def test_constants_match_jax():
    pairs = [
        (decode8.DEFAULT_CHUNK_BYTES, jax_decode8.DEFAULT_CHUNK_BYTES, 512),
        (decode8.SYNC_WINDOW, jax_decode8.SYNC_WINDOW, 128),
        (decode8.MAX_SYNC_PASSES, jax_decode8.MAX_SYNC_PASSES, 24),
        (decode8.SUB_BYTES, jax_decode8.SUB_BYTES, 8),
        (decode8.CAP_SYM_ROUND, jax_decode8.CAP_SYM_ROUND, 16),
        (encode.DEFAULT_BLOCK_BYTES, jax_encode.DEFAULT_BLOCK_BYTES, 1024),
        (bitpack.CAP_G_ROUND, jax_bitpack.CAP_G_ROUND, 16),
        (bitpack.PLANE_SUB, jax_bitpack.PLANE_SUB, 256),
    ]
    for port, ref, value in pairs:
        assert port == ref == value


# --- the one-pass tables built from the code trie (ops/cuda_tables) ---

def _trie_table(name: str, request):
    """The code tables the card's table build is held to: the midsummer text
    (m = 3, s = 96), the three .et files of tests/data, Zipf-skewed (m = 4),
    run-heavy (m = 8), every byte (255 internal nodes, S = 256), two
    symbols, and the midsummer table pruned of two codes (dead edges)."""
    from entreepy_tpu.format.huffman import CodeTable

    if name.endswith(".et"):
        return parse_header((DATA / name).read_bytes()).table
    if name in ("skewed", "runheavy", "random"):
        data = _corpus(name)
    elif name == "two":
        data = b"ab" * 500 + b"a"
    else:
        data = request.getfixturevalue("midsummer")
    table = build_code_table(histogram(np.frombuffer(data, np.uint8)))
    if name == "pruned":
        lengths, codes = table.lengths.copy(), table.codes.copy()
        for sym in b"eq":
            lengths[sym] = codes[sym] = 0
        table = CodeTable(codes, lengths)
    return table


TRIE_TABLES = {  # name -> (S, m, mt, s)
    "midsummer": (128, 3, 2, 96),
    "a_midsummer_nights_dream.et": None,
    "nice.shakespeare.et": None,
    "test.et": None,
    "skewed": (256, 4, 3, 256),
    "runheavy": (256, 8, 7, 160),
    "random": (256, 1, 1, 256),
    "two": (128, 8, 7, 8),
    "pruned": None,
}


@pytest.mark.parametrize("name", list(TRIE_TABLES))
def test_card_build_matches_fsm8(name, request):
    """The tables kernel's plain version and the host's layout DP give the
    JAX package's next_state, fused_decode_tensors and (m, mt, s) byte for
    byte."""
    table = _trie_table(name, request)
    fsm = build_byte_fsm(table)
    want, m, mt, s = fused_decode_tensors(fsm)
    children, leaf_sym = port_fsm8._build_trie(table)
    layout = cuda_tables.trie_layout(children, leaf_sym)
    assert layout == (fsm.width, m, mt, s)
    if TRIE_TABLES[name] is not None:
        assert layout == TRIE_TABLES[name]
    if name == "pruned":
        assert (fsm.counts < 0).any() and (fsm.counts[: fsm.n_states] < 0).any()
    if name == "random":
        assert fsm.n_states == 255
    ns, fused = cuda_tables.fsm_tables_plain(cuda_tables.pack_trie(children, leaf_sym),
                                             fsm.width, s, mt, "cpu")
    assert ns.dtype == fused.dtype == torch.uint8
    assert np.array_equal(ns.numpy(), fsm.next_state)
    assert np.array_equal(fused.numpy(), want.astype(np.uint8))


@pytest.mark.parametrize("name", list(TRIE_TABLES))
def test_packed_trie_round_trips(name, request):
    """pack_trie: one 16-bit entry per edge (2 per internal node, at most
    1,020 B) that gives children and leaf_sym back: LEAF | symbol, CHILD |
    node, or 0 for a dead edge."""
    children, leaf_sym = port_fsm8._build_trie(_trie_table(name, request))
    edges = cuda_tables.pack_trie(children, leaf_sym)
    assert edges.dtype == np.uint16 and edges.shape == (2 * children.shape[0],)
    assert edges.nbytes <= 2 * 2 * 255
    e = edges.astype(np.int32).reshape(-1, 2)
    assert not ((e & cuda_tables.LEAF) & ((e & cuda_tables.CHILD) >> 1)).any()
    assert np.array_equal(np.where(e & cuda_tables.CHILD, e & 255, -1), children)
    assert np.array_equal(np.where(e & cuda_tables.LEAF, e & 255, -1), leaf_sym)


def test_card_decode_tables_stage_and_counts(midsummer):
    """code_trie, then card_decode_tables (the plain version off the card):
    decode_tables' tables, the stage fsm_build, one fsm_builds and one
    fsm_device_builds, and the ByteFsm cache untouched."""
    from entreepy_tpu_torch.format import build_code_table as port_code_table
    from entreepy_tpu_torch.format import histogram as port_histogram

    table = port_code_table(port_histogram(np.frombuffer(midsummer, np.uint8)))
    cache = dict(port_fsm8._FSM_CACHE)
    with trace.record_stages() as rec:
        got = tables.card_decode_tables(tables.code_trie(table), "cpu")
    assert list(rec) == ["fsm_build"]
    assert rec.counts == {"fsm_builds": 1, "fsm_device_builds": 1}
    assert port_fsm8._FSM_CACHE == cache
    want = tables.decode_tables(port_fsm8.build_byte_fsm(table), "cpu")
    assert (got.m, got.mt, got.s) == (want.m, want.mt, want.s)
    assert torch.equal(got.fused, want.fused) and torch.equal(got.next_state, want.next_state)


@pytest.mark.parametrize("device,expand,on_card", [
    ("cuda", "onepass", True), ("cuda:1", "onepass", True), ("cpu", "onepass", False),
    ("cuda", "split", False), ("cuda", "fused", False), ("cuda", "host", False),
])
def test_builds_on_card(device, expand, on_card):
    """Only the one-pass route on a CUDA device builds its tables on the card."""
    assert tables.builds_on_card(device, expand) is on_card
    assert tables.builds_on_card(torch.device(device), expand) is on_card


@pytest.mark.parametrize("expand", decode8.EXPAND_MODES)
def test_route_tables_on_cpu_keep_the_host_build(expand, midsummer):
    """On the CPU every route builds its ByteFsm on the host, as before: no
    device build is counted."""
    hdr = parse_header(compress_host(midsummer))
    with trace.record_stages() as rec:
        fsm, _ = decode8.route_tables(hdr.table, "cpu", expand,
                                      port_fsm8._build_byte_fsm(hdr.table))
    assert fsm is not None and "fsm_device_builds" not in rec.counts
    assert list(rec) == ["decode_tables"]
