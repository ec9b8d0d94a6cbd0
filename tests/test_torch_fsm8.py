"""The port's byte-FSM passes (plain versions, CPU) against the JAX scan twins
and the Pallas kernels in interpret mode: exact equality on every integer,
symbol slots compared where the byte's count makes them live."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from entreepy_tpu.format import compress_host, parse_header  # noqa: E402
from entreepy_tpu.format.fsm8 import build_byte_fsm  # noqa: E402
from entreepy_tpu.ops import decode8 as jd  # noqa: E402
from entreepy_tpu.ops.pallas_fsm8 import fused_pass_pallas8, sync_pass_pallas8  # noqa: E402

from entreepy_tpu_torch.ops import cuda_fsm8  # noqa: E402
from entreepy_tpu_torch.ops import decode8 as td  # noqa: E402
from entreepy_tpu_torch.tables import decode_tables  # noqa: E402

SKEWED = (b"a" * 500 + b"bcd") * 9  # m > 3: multi-symbol bytes


def _prep(data: bytes, chunk: int, lanes: int = 16):
    """A body's [K, lanes] byte rows (zero lanes past the body) as numpy,
    plus the FSM and the real lane count."""
    et = compress_host(data)
    hdr = parse_header(et)
    buf = np.frombuffer(et, np.uint8)[hdr.body_start:]
    n_real = -(-buf.size // chunk)
    assert n_real <= lanes
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: buf.size] = buf
    return padded.reshape(lanes, chunk), build_byte_fsm(hdr.table), n_real, buf.size


def _entries(fsm, lanes: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, fsm.n_states, lanes).astype(np.int32)


def _split(vals: np.ndarray, m: int, packed: bool):
    """(row0 [K, lanes], slots [K, m, lanes], live [K, m, lanes])."""
    vals = vals.astype(np.int64)
    if packed:
        row0 = vals >> (8 * m)
        shifts = 8 * (m - 1 - np.arange(m))[None, :, None]
        slots = (vals[:, None, :] >> shifts) & 255
    else:
        row0, slots = vals[:, 0], vals[:, 1:]
    live = np.arange(m)[None, :, None] < (row0 & 15)[:, None, :]
    return row0, slots, live


def _assert_rows_equal(a, b, m: int, packed: bool):
    r0a, sa, live = _split(np.asarray(a), m, packed)
    r0b, sb, _ = _split(np.asarray(b), m, packed)
    assert np.array_equal(r0a, r0b)
    assert np.array_equal(np.where(live, sa, 0), np.where(live, sb, 0))


@pytest.mark.parametrize("name,chunk", [("macbeth", 32), ("skewed", 64), ("midsummer_head", 16)])
@pytest.mark.parametrize("seed", [None, 1])
def test_sync_pass_matches_jax(name, chunk, seed, request):
    data = {"skewed": SKEWED}.get(name) or (
        request.getfixturevalue("midsummer")[:300] if name == "midsummer_head"
        else request.getfixturevalue(name)
    )
    cols, fsm, _, _ = _prep(data, chunk)
    lanes, k = cols.shape
    entries = np.zeros(lanes, np.int32) if seed is None else _entries(fsm, lanes, seed)
    w = min(td.SYNC_WINDOW, k)
    xs = np.ascontiguousarray(cols.T[k - w:])
    tbl = jd._table_T_bf16(fsm)
    want_scan, _ = jd._scan_pass(jnp.asarray(xs, jnp.int32), tbl, jnp.asarray(entries), False)
    want_pallas = sync_pass_pallas8(jnp.asarray(xs, jnp.int32), tbl, jnp.asarray(entries),
                                    interpret=True)
    got = cuda_fsm8.sync_pass(torch.from_numpy(xs), decode_tables(fsm, "cpu").next_state,
                              torch.from_numpy(entries))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want_scan))
    assert np.array_equal(got.numpy(), np.asarray(want_pallas))


@pytest.mark.parametrize("name,chunk,packed", [("macbeth", 32, False), ("macbeth", 32, True),
                                               ("skewed", 64, False)])
def test_fused_pass_matches_jax(name, chunk, packed, request):
    data = SKEWED if name == "skewed" else request.getfixturevalue(name)
    cols, fsm, _, n_body = _prep(data, chunk)
    t = decode_tables(fsm, "cpu")
    m, mt, s = t.m, t.mt, t.s
    assert packed <= (m <= 3)
    lanes, k = cols.shape
    entries = _entries(fsm, lanes, 7)
    xs = np.ascontiguousarray(cols.T)
    xs_j = jnp.asarray(xs, jnp.int32)
    t_fused, *_ = jd.build_fused(fsm)
    n_valid = n_body - 5  # short of the body: the padding mask bites mid-lane
    raw, syms, exits_scan = jd._fused_scan_pass(xs_j, t_fused, jnp.asarray(entries), m, mt, s)
    if packed:
        want_scan = jd.pack_fused_rows_masked(raw, syms, jnp.int32(n_valid), m)
    else:
        want_scan = jnp.concatenate([raw[:, None, :], syms.astype(jnp.int32)], axis=1)
    want_pallas, exits_pallas = fused_pass_pallas8(
        xs_j, t_fused, jnp.asarray(entries), m, mt, s, packed=packed,
        n_valid=jnp.int32(n_valid) if packed else None, interpret=True,
    )
    got, exits = cuda_fsm8.fused_pass(torch.from_numpy(xs), t.fused, torch.from_numpy(entries),
                                      m, mt, s, packed=packed, n_valid=n_valid)
    assert got.dtype == exits.dtype == torch.int32
    assert got.shape == ((k, lanes) if packed else (k, m + 1, lanes))
    assert np.array_equal(exits.numpy(), np.asarray(exits_scan))
    assert np.array_equal(exits.numpy(), np.asarray(exits_pallas))
    _assert_rows_equal(got.numpy(), want_scan, m, packed)
    _assert_rows_equal(got.numpy(), want_pallas, m, packed)


@pytest.mark.parametrize("name,chunk,packed", [("macbeth", 16, True), ("macbeth", 16, False),
                                               ("skewed", 32, False)])
@pytest.mark.parametrize("entry0", [0, 2])
def test_fixed_point_driver_matches_jax(name, chunk, packed, entry0, request):
    data = SKEWED if name == "skewed" else request.getfixturevalue(name)
    cols, fsm, n_real, n_body = _prep(data, chunk, lanes=64)
    assert n_real < cols.shape[0]  # padding lanes stay out of the convergence test
    t = decode_tables(fsm, "cpu")
    m, mt, s = t.m, t.mt, t.s
    t_fused, *_ = jd.build_fused(fsm)
    want, want_exits, want_unconv = jd.fsm8_decode_fused(
        jnp.asarray(cols, jnp.int32), jd._table_T_bf16(fsm), t_fused, jnp.int32(n_real),
        m, mt, s, packed=packed, entry0=jnp.int32(entry0),
        n_valid=jnp.int32(n_body) if packed else None,
    )
    got, exits, unconv = td.fsm8_decode_fused(
        torch.from_numpy(cols), t.next_state, t.fused, n_real, m, mt, s,
        packed=packed, n_valid=n_body if packed else None, entry0=entry0,
    )
    assert unconv is bool(want_unconv) is False
    assert np.array_equal(exits.numpy(), np.asarray(want_exits))
    _assert_rows_equal(got.numpy(), want, m, packed)


def _chain_table_case(name: str, request):
    """A corpus's code table, or a random one with symbols pruned (their bits
    then walk dead trie edges: invalid transitions)."""
    from entreepy_tpu.format import build_code_table, histogram
    from entreepy_tpu.format.huffman import CodeTable

    if not name.startswith("pruned"):
        data = SKEWED if name == "skewed" else request.getfixturevalue(name)
        return build_code_table(histogram(np.frombuffer(data, np.uint8)))
    rng = np.random.default_rng(int(name[-1]))
    counts = np.zeros(256, np.int64)
    syms = rng.choice(256, int(rng.integers(3, 256)), replace=False)
    counts[syms] = rng.integers(1, 10_000, syms.size) ** 2
    table = build_code_table(counts)
    lengths, codes = table.lengths.copy(), table.codes.copy()
    for sym in rng.choice(syms, min(3, syms.size - 2), replace=False):
        lengths[sym] = codes[sym] = 0
    return CodeTable(codes, lengths)


@pytest.mark.parametrize("name", ["macbeth", "midsummer", "skewed", "pruned0", "pruned1",
                                  "pruned2"])
def test_fused_chain_table_identity(name, request):
    """The fused kernel steps the state through fused_chain_table: for every
    (byte, state) it equals the next state of the plain fused step (p > 0 ?
    tail_end : merged), the FSM's own next state on every valid transition,
    and a walk through it ends where the plain pass ends, invalid
    transitions included."""
    fsm = build_byte_fsm(_chain_table_case(name, request))
    t = decode_tables(fsm, "cpu")
    m, mt, s = t.m, t.mt, t.s
    chain = cuda_fsm8.fused_chain_table(t.fused, s, mt)
    assert chain.shape == (256, s) and chain.dtype == torch.uint8
    xs = torch.arange(256, dtype=torch.uint8).repeat_interleave(s)[None, :]
    _, nxt = cuda_fsm8.fused_pass_plain(xs, t.fused, torch.arange(s, dtype=torch.int32).repeat(256),
                                        m, mt, s)
    assert torch.equal(nxt.reshape(256, s).to(torch.uint8), chain)
    valid = fsm.counts[:s].T >= 0
    assert np.array_equal(chain.numpy()[valid], fsm.next_state[:s].T[valid])
    assert int(chain.max()) < s
    rng = np.random.default_rng(len(name))
    rows = torch.from_numpy(rng.integers(0, 256, (96, 40), dtype=np.uint8))
    entries = torch.from_numpy(_entries(fsm, 40, 5))
    vals, exits = cuda_fsm8.fused_pass_plain(rows, t.fused, entries, m, mt, s)
    state = entries.long()
    for row in rows.long():
        state = chain[row, state].long()
    assert torch.equal(state.int(), exits)
    if name.startswith("pruned"):  # the random streams hit invalid transitions
        assert not valid[:, :fsm.n_states].all() and bool((vals[:, 0] >= 16).any())
