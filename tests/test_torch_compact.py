"""The port's row compaction (plain version, CPU) against ``compact_rows_pallas``
in interpret mode, and the compaction callers against their JAX twins:
exact equality everywhere (dead slots are zeroed on both sides)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from entreepy_tpu.format import build_code_table, histogram, pack_body_host  # noqa: E402
from entreepy_tpu.format.fsm8 import build_byte_fsm  # noqa: E402
from entreepy_tpu.format.huffman import CodeTable  # noqa: E402
from entreepy_tpu.ops import bitpack as jb  # noqa: E402
from entreepy_tpu.ops import decode8 as jd  # noqa: E402
from entreepy_tpu.ops.pallas_compact import compact_rows_pallas  # noqa: E402

from entreepy_tpu_torch.ops import bitpack as tb  # noqa: E402
from entreepy_tpu_torch.ops import cuda_compact, cuda_symbols  # noqa: E402
from entreepy_tpu_torch.ops import decode8 as td  # noqa: E402


def _grid(rng, lanes=16, steps=512, sub=64, p=0.2):
    words = rng.integers(0, 1 << 32, (lanes, steps), dtype=np.uint64).astype(np.uint32)
    emitted = rng.random((lanes, steps)) < p
    emitted[0] = False          # all-dead lane
    emitted[1] = True           # full lane: count > cap truncates
    emitted[2, :sub] = False    # leading empty subgroup
    return words, emitted


@pytest.mark.parametrize("sub,cap", [(64, 16), (24, 16), (8, 8)])
def test_compact_rows_matches_pallas(sub, cap):
    words, emitted = _grid(np.random.default_rng(7), steps=sub * 8, sub=sub)
    wk = np.ascontiguousarray(words.view(np.int32).T)
    ek = np.ascontiguousarray(emitted.T)
    want_plane, want_counts = compact_rows_pallas(
        jnp.asarray(wk), jnp.asarray(ek.astype(np.int32)), sub, cap, interpret=True
    )
    plane, counts = cuda_compact.compact_rows(torch.from_numpy(wk), torch.from_numpy(ek),
                                              sub, cap)
    assert plane.dtype == counts.dtype == torch.int32
    assert np.array_equal(plane.numpy(), np.asarray(want_plane))
    assert np.array_equal(counts.numpy(), np.asarray(want_counts))


@pytest.mark.parametrize("cap", [16, 48, 4])
def test_compact_payload_plane_matches_jax(cap):
    """cap 4 is below the fullest subgroup: bit_lens poisoned to -1 on both."""
    rng = np.random.default_rng(13)
    lanes, steps = 16, 512  # plane_sub_for(512) = 256 -> two subgroups
    words, emitted = _grid(rng, lanes, steps, sub=256, p=0.02)
    emitted[1] = rng.random(steps) < 0.02  # keep every subgroup within cap 16
    acc = rng.integers(0, 1 << 32, lanes, dtype=np.uint64).astype(np.uint32)
    nbits = rng.integers(0, 32, lanes).astype(np.int32)
    args = (jnp.asarray(words), jnp.asarray(emitted), jnp.asarray(acc), jnp.asarray(nbits))
    want_sort = jb.compact_payload_plane(*args, cap)
    want_kernel = jb.compact_payload_plane(*args, cap, interpret=True)
    got = tb.compact_payload_plane(
        torch.from_numpy(words), torch.from_numpy(emitted), torch.from_numpy(acc),
        torch.from_numpy(nbits), cap,
    )
    assert got[0].dtype == torch.uint32
    assert (got[2].numpy() == -1).all() == (cap == 4)
    for want in (want_sort, want_kernel):
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    counts = tb.grouped_counts_plane(torch.from_numpy(emitted))
    assert np.array_equal(counts.numpy(), np.asarray(jb.grouped_counts_plane(args[1])))
    flat, nwords = tb.assemble_plane_payload(got[0].numpy(), got[1].numpy())
    want_flat, want_nwords = jb.assemble_plane_payload(np.asarray(want_sort[0]),
                                                       np.asarray(want_sort[1]))
    assert np.array_equal(flat, want_flat) and np.array_equal(nwords, want_nwords)


@pytest.mark.parametrize("k,m", [(64, 3), (32, 4), (32, 8)])
@pytest.mark.parametrize("cap_sym", [16, 32])
def test_compact_symbols_device_matches_jax(k, m, cap_sym):
    rng = np.random.default_rng(17 + k + m)
    lanes = 16
    counts = rng.integers(0, m + 1, (k, lanes)).astype(np.int32)
    counts[:, 0] = 0
    counts[:, 1] = m
    inv = rng.random((k, lanes)) < 0.02
    syms = rng.integers(0, 256, (k, m, lanes)).astype(np.uint8)
    want = jd.compact_symbols_device(jnp.asarray(counts), jnp.asarray(inv),
                                     jnp.asarray(syms), m, cap_sym, sub=td.SUB_BYTES)
    got = td.compact_symbols_device(torch.from_numpy(counts), torch.from_numpy(inv),
                                    torch.from_numpy(syms), m, cap_sym)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert td.sym_cap(torch.from_numpy(counts), m) == jd.sym_cap(jnp.asarray(counts), m)


def test_compact_symbols_overflow_poisons_lane_tot():
    sb = td.SUB_BYTES
    k, m, lanes = 2 * sb, 2, 8
    counts = np.zeros((k, lanes), np.int32)
    counts[:sb, 2] = 2  # subgroup 0 of lane 2 emits 2*sb symbols > cap sb
    args = (counts, np.zeros((k, lanes), bool), np.zeros((k, m, lanes), np.uint8))
    want = jd.compact_symbols_device(*(jnp.asarray(a) for a in args), m, sb)
    got = td.compact_symbols_device(*(torch.from_numpy(a) for a in args), m, sb)
    assert (got[2].numpy() == -1).all()
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pruned", [False, True])
def test_compact_symbols_dense_matches_jax(pruned, midsummer):
    """Same packed fused words in, same dense plane and lane metadata out —
    also under a table missing a symbol, whose bits walk a dead trie edge
    (w_inv then marks a lane's first invalid transition)."""
    if pruned:
        data = b"abcdefgh" * 300 + b"z" + b"abcdefgh" * 300
    else:
        data = midsummer[:20000]
    arr = np.frombuffer(data, np.uint8)
    table = build_code_table(histogram(arr))
    body = np.frombuffer(pack_body_host(arr, table)[0], np.uint8)
    if pruned:
        lengths, codes = table.lengths.copy(), table.codes.copy()
        lengths[ord("z")] = codes[ord("z")] = 0
        table = CodeTable(codes, lengths)
    fsm = build_byte_fsm(table)
    chunk = 64
    lanes = -(-body.size // chunk)
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: body.size] = body
    t_fused, m, mt, s = jd.build_fused(fsm)
    words, _, _ = jd.fsm8_decode_fused(
        jd.bytes_to_cols(padded, lanes, chunk), jd._table_T_bf16(fsm), t_fused,
        jnp.int32(lanes), m, mt, s, packed=True, n_valid=jnp.int32(body.size),
    )
    want = jd.compact_symbols_dense(words, m)
    got = cuda_symbols.compact_symbols_dense(torch.from_numpy(np.array(words)), m)
    assert (got[3].numpy() < td.NO_INVALID).any() == pruned
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
