"""The port's two-pass decode on ``device="cpu"`` (the kernels' plain
versions) against the JAX package: the emit pass, the fixed point of emit
passes and both expansions against the XLA scan twins and the Pallas
kernels in interpret mode, and the ``split``, ``fused`` and ``host`` routes
against the matching JAX routes. Exact equality on every integer; symbol slots are compared where
the byte's count makes them live."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import entreepy_tpu  # noqa: E402
from entreepy_tpu.format import compress_host, parse_header  # noqa: E402
from entreepy_tpu.format.fsm8 import (  # noqa: E402
    build_byte_fsm,
    expand_tensors,
    split_expand_tensors,
)
from entreepy_tpu.ops import decode8 as jd  # noqa: E402
from entreepy_tpu.ops.pallas_fsm8 import (  # noqa: E402
    emit_pass_pallas8,
    expand_pass_pallas8,
    expand_pass_split_pallas8,
    fsm8_decode_pallas,
    unpack_states_packed,
)

import entreepy_tpu_torch  # noqa: E402
from entreepy_tpu_torch import trace  # noqa: E402
from entreepy_tpu_torch.format import fsm8 as port_fsm8  # noqa: E402
from entreepy_tpu_torch.ops import cuda_fsm8  # noqa: E402
from entreepy_tpu_torch.ops import decode8 as td  # noqa: E402
from entreepy_tpu_torch.parallel import decompress_sharded, make_mesh  # noqa: E402
from entreepy_tpu_torch.tables import expand_tables  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SKEWED = (b"a" * 500 + b"bcd") * 9  # m = 8: 'a' has a 1-bit code
ALPHABET = bytes(range(256)) * 9  # m = 1, S = 256
ROUTES = ("split", "fused", "host")


def _data(name: str, request) -> bytes:
    """Test fixtures, the two strings above, and ~30 KB of the
    benchmarks/scale.py corpus families plus NUL symbols."""
    if name in ("tiny_text", "macbeth", "midsummer"):
        return request.getfixturevalue(name)
    if name == "skewed_str":
        return SKEWED
    if name == "alphabet":
        return ALPHABET
    rng = np.random.default_rng(1234)
    n = 30_000
    if name == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if name == "skewed":
        p = 1.0 / np.arange(1, 257) ** 1.3
        return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()
    if name == "runheavy":
        unit = b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        return (unit * (-(-n // len(unit))))[:n]
    if name == "nul":
        return b"\x00" * 500 + bytes(range(1, 40)) * 10 + b"\x00" * 3
    raise ValueError(name)


def _prep(data: bytes, chunk: int, lanes: int | None = None):
    """(cols uint8[lanes, K] zero-padded past the body, FSM, real lanes,
    body bytes) of a body; ``lanes`` adds padding lanes."""
    et = compress_host(data)
    hdr = parse_header(et)
    buf = np.frombuffer(et, np.uint8)[hdr.body_start:]
    n_real = -(-buf.size // chunk)
    lanes = lanes or n_real
    assert n_real <= lanes
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: buf.size] = buf
    return padded.reshape(lanes, chunk), build_byte_fsm(hdr.table), n_real, buf.size


@pytest.mark.parametrize("name,chunk", [("macbeth", 32), ("skewed_str", 64)])
@pytest.mark.parametrize("seed", [None, 1])
def test_emit_pass_matches_jax(name, chunk, seed, request):
    cols, fsm, _, _ = _prep(_data(name, request), chunk)
    lanes = cols.shape[0]
    entries = (np.zeros(lanes, np.int32) if seed is None else
               np.random.default_rng(seed).integers(0, fsm.n_states, lanes).astype(np.int32))
    xs = np.ascontiguousarray(cols.T)
    xs_j, tbl = jnp.asarray(xs, jnp.int32), jd._table_T_bf16(fsm)
    exits_scan, states_scan = jd._scan_pass(xs_j, tbl, jnp.asarray(entries), True)
    packed, exits_pallas = emit_pass_pallas8(xs_j, tbl, jnp.asarray(entries), interpret=True)
    states, exits = cuda_fsm8.emit_pass(torch.from_numpy(xs),
                                        torch.from_numpy(np.ascontiguousarray(fsm.next_state)),
                                        torch.from_numpy(entries))
    assert states.dtype == torch.uint8 and exits.dtype == torch.int32
    assert states.shape == xs.shape
    assert np.array_equal(states.numpy(), np.asarray(states_scan))
    assert np.array_equal(states.numpy(), np.asarray(unpack_states_packed(packed, xs.shape[0])))
    assert np.array_equal(exits.numpy(), np.asarray(exits_scan))
    assert np.array_equal(exits.numpy(), np.asarray(exits_pallas))


@pytest.mark.parametrize("name,chunk", [("macbeth", 16), ("skewed_str", 32), ("alphabet", 64)])
def test_two_pass_states_match_jax(name, chunk, request):
    cols, fsm, n_real, _ = _prep(_data(name, request), chunk, lanes=64)
    assert n_real < cols.shape[0]  # padding lanes stay out of the convergence test
    cols_j, tbl = jnp.asarray(cols, jnp.int32), jd._table_T_bf16(fsm)
    want_scan, unconv_scan = jd.fsm8_decode(cols_j, tbl, jnp.int32(n_real))
    want_pallas, unconv_pallas = fsm8_decode_pallas(cols_j, tbl, jnp.int32(n_real),
                                                    interpret=True)
    next_state = torch.from_numpy(np.ascontiguousarray(fsm.next_state))
    states, unconv = td.fsm8_decode(torch.from_numpy(np.ascontiguousarray(cols.T)),
                                    next_state, n_real)
    assert unconv is bool(unconv_scan) is bool(unconv_pallas) is False
    assert states.dtype == torch.uint8 and states.shape == cols.T.shape
    assert np.array_equal(states.t().numpy(), np.asarray(want_scan))
    assert np.array_equal(states.t().numpy(), np.asarray(want_pallas))


def _expansion_inputs(name: str, request, chunk: int = 32):
    """Converged JAX states uint8[lanes, K] of a body, with n_valid short of
    the body so the padding mask bites mid-lane."""
    cols, fsm, n_real, n_body = _prep(_data(name, request), chunk)
    states, unconv = jd.fsm8_decode(jnp.asarray(cols, jnp.int32), jd._table_T_bf16(fsm),
                                    jnp.int32(n_real))
    assert not bool(unconv)
    return cols, np.array(states), fsm, n_body - 5


def _run_expand(cols, states, tables, n_valid):
    """The port's expansion on the JAX layout's inputs, transposed to the
    kernels' [K, lanes]."""
    vals = td.expand_rows(torch.from_numpy(np.ascontiguousarray(cols.T)),
                          torch.from_numpy(np.ascontiguousarray(states.T)), tables)
    return td._expand_mask(vals[:, 0], vals[:, 1:], n_valid)


def _assert_masked_equal(got, want, m: int):
    """(counts, inv, syms) triples equal; syms where j < count."""
    counts, inv, syms = (np.asarray(a) for a in got)
    w_counts, w_inv, w_syms = (np.asarray(a) for a in want)
    assert np.array_equal(counts, w_counts) and np.array_equal(inv, w_inv)
    live = np.arange(m)[None, :, None] < w_counts[:, None, :]
    assert syms.shape == w_syms.shape
    assert np.array_equal(np.where(live, syms, 0), np.where(live, w_syms, 0))


def _assert_rows_hold_pallas(got, want, m: int):
    """uint8 rows [K, m+1, lanes] hold the Pallas kernel's int32 values: row
    0 (count | 16*invalid) exact, symbol slots where live."""
    assert got.dtype == torch.uint8 and got.shape == want.shape
    got = got.numpy().astype(np.int32)
    assert np.array_equal(got[:, 0], want[:, 0])
    live = np.arange(m)[None, :, None] < (want[:, 0] & 15)[:, None, :]
    assert live.any()
    assert np.array_equal(np.where(live, got[:, 1:], 0), np.where(live, want[:, 1:], 0))


@pytest.mark.parametrize("name,m", [("alphabet", 1), ("macbeth", 3), ("skewed_str", 8)])
def test_expand_pass_split_matches_jax(name, m, request):
    cols, states, fsm, n_valid = _expansion_inputs(name, request)
    ts, m_, mt = split_expand_tensors(fsm)
    assert m_ == m
    tables = expand_tables(fsm, "cpu", split=True)
    assert (tables.m, tables.mt, tables.s) == (m, mt, fsm.width)
    assert np.array_equal(tables.table.numpy(), ts.astype(np.uint8))
    cols_j, states_j = jnp.asarray(cols, jnp.int32), jnp.asarray(states)
    ts_j = jnp.asarray(ts, jnp.bfloat16)
    raw, syms = jd._expand_scan_split(cols_j, states_j, ts_j, m, mt)
    want_scan = jd._expand_mask(raw, syms, jnp.int32(n_valid), m)
    vals = expand_pass_split_pallas8(cols_j.T, states_j.T.astype(jnp.int32), ts_j, m, mt,
                                     interpret=True)
    want_pallas = jd._expand_mask(vals[:, 0, :], vals[:, 1:, :].astype(jnp.uint8),
                                  jnp.int32(n_valid), m)
    got = _run_expand(cols, states, tables, n_valid)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.uint8
    _assert_masked_equal(got, want_scan, m)
    _assert_masked_equal(got, want_pallas, m)


@pytest.mark.parametrize("name,m", [("alphabet", 1), ("macbeth", 3), ("skewed_str", 8)])
def test_expand_pass_split_rows_match_pallas(name, m, request):
    """The plain split expansion's uint8 rows hold the Pallas kernel's int32
    values: row 0 (count | 16*invalid) exact, symbol slots where live."""
    cols, states, fsm, _ = _expansion_inputs(name, request)
    ts, m_, mt = split_expand_tensors(fsm)
    assert m_ == m
    want = np.asarray(expand_pass_split_pallas8(
        jnp.asarray(cols.T, jnp.int32), jnp.asarray(states.T, jnp.int32),
        jnp.asarray(ts, jnp.bfloat16), m, mt, interpret=True))
    got = cuda_fsm8.expand_pass_split_plain(
        torch.from_numpy(np.ascontiguousarray(cols.T)),
        torch.from_numpy(np.ascontiguousarray(states.T)),
        torch.from_numpy(ts.astype(np.uint8)), m, mt)
    assert want.shape == (cols.shape[1], m + 1, cols.shape[0])
    _assert_rows_hold_pallas(got, want, m)


@pytest.mark.parametrize("name,m", [("alphabet", 1), ("macbeth", 3), ("skewed_str", 8)])
def test_expand_pass_matches_jax(name, m, request):
    cols, states, fsm, n_valid = _expansion_inputs(name, request)
    t_exp, m_ = expand_tensors(fsm)
    assert m_ == m
    tables = expand_tables(fsm, "cpu", split=False)
    assert (tables.m, tables.mt, tables.s) == (m, None, fsm.width)
    assert np.array_equal(tables.table.numpy(), t_exp.astype(np.uint8))
    cols_j, states_j = jnp.asarray(cols, jnp.int32), jnp.asarray(states)
    te_j = jnp.asarray(t_exp, jnp.bfloat16)
    raw, syms = jd._expand_scan(cols_j, states_j, te_j, m)
    want_scan = jd._expand_mask(raw, syms, jnp.int32(n_valid), m)
    vals = expand_pass_pallas8(cols_j.T, states_j.T.astype(jnp.int32), te_j, m, interpret=True)
    want_pallas = jd._expand_mask(vals[:, 0, :], vals[:, 1:, :].astype(jnp.uint8),
                                  jnp.int32(n_valid), m)
    got = _run_expand(cols, states, tables, n_valid)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.uint8
    _assert_masked_equal(got, want_scan, m)
    _assert_masked_equal(got, want_pallas, m)


@pytest.mark.parametrize("name,m", [("alphabet", 1), ("macbeth", 3), ("skewed_str", 8)])
def test_expand_pass_rows_match_pallas(name, m, request):
    """The plain full-table expansion's uint8 rows hold the Pallas kernel's
    int32 values: row 0 exact, symbol slots where live."""
    cols, states, fsm, _ = _expansion_inputs(name, request)
    t_exp, m_ = expand_tensors(fsm)
    assert m_ == m
    want = np.asarray(expand_pass_pallas8(
        jnp.asarray(cols.T, jnp.int32), jnp.asarray(states.T, jnp.int32),
        jnp.asarray(t_exp, jnp.bfloat16), m, interpret=True))
    got = cuda_fsm8.expand_pass_plain(
        torch.from_numpy(np.ascontiguousarray(cols.T)),
        torch.from_numpy(np.ascontiguousarray(states.T)),
        torch.from_numpy(t_exp.astype(np.uint8)), m)
    assert want.shape == (cols.shape[1], m + 1, cols.shape[0])
    _assert_rows_hold_pallas(got, want, m)


@pytest.mark.parametrize("lanes", [1, 7, 9])
def test_expand_pass_odd_lanes(lanes, macbeth):
    """Lane counts off the kernel's groups of 8: the plain full-table
    expansion's uint8 [K, m+1, lanes] rows hold the Pallas kernel's values
    on random bytes and states below S."""
    fsm = build_byte_fsm(parse_header(compress_host(macbeth)).table)
    t_exp, m = expand_tensors(fsm)
    rng = np.random.default_rng(lanes)
    xs = rng.integers(0, 256, (16, lanes), dtype=np.uint8)
    states = rng.integers(0, fsm.width, (16, lanes)).astype(np.uint8)
    want = np.asarray(expand_pass_pallas8(
        jnp.asarray(xs, jnp.int32), jnp.asarray(states, jnp.int32),
        jnp.asarray(t_exp, jnp.bfloat16), m, interpret=True))
    got = cuda_fsm8.expand_pass_plain(torch.from_numpy(xs), torch.from_numpy(states),
                                      torch.from_numpy(t_exp.astype(np.uint8)), m)
    assert got.shape == (16, m + 1, lanes)
    _assert_rows_hold_pallas(got, want, m)


@pytest.mark.parametrize("name,m,p", [("alphabet", 1, 4), ("macbeth", 3, 4), ("skewed", 4, 8),
                                      ("skewed_str", 8, 16)])
def test_expand_vector_table_entries(name, m, p, request):
    """The kernel's relaid full table: entry (byte, state) is one aligned
    P-byte vector holding the byte's m + 1 values in order, so a lookup at
    ``(x*S + state) * P + j`` reads ``expand_tensors``' value of row j."""
    fsm = build_byte_fsm(parse_header(compress_host(_data(name, request))).table)
    t_exp, m_ = expand_tensors(fsm)
    assert m_ == m
    s = fsm.width
    vec = cuda_fsm8.expand_vector_table(torch.from_numpy(t_exp.astype(np.uint8)), m)
    assert vec.dtype == torch.uint8 and vec.shape == (256, s, p) and vec.is_contiguous()
    flat = vec.reshape(-1).numpy()
    x, st = np.meshgrid(np.arange(256), np.arange(s), indexing="ij")
    for j in range(m + 1):
        assert np.array_equal(flat[(x * s + st) * p + j], t_exp[:, j * s:(j + 1) * s])


@pytest.fixture
def jax_route(monkeypatch):
    """Set the JAX package's environment to the route of the port's
    ``expand`` argument: ENTREEPY_EXPAND under ENTREEPY_DEVICE_E2E=1 for the
    two-pass device routes, ENTREEPY_DEVICE_E2E=0 for host expansion."""
    def use(mode: str):
        if mode == "host":
            monkeypatch.setenv("ENTREEPY_DEVICE_E2E", "0")
        else:
            monkeypatch.setenv("ENTREEPY_DEVICE_E2E", "1")
            monkeypatch.setenv("ENTREEPY_EXPAND", mode)
    return use


@pytest.mark.parametrize("mode", ROUTES)
@pytest.mark.parametrize("chunk", [16, 64, 512])
@pytest.mark.parametrize("name", ["tiny_text", "midsummer", "random", "skewed", "runheavy",
                                  "nul"])
def test_route_matches_jax(name, chunk, mode, request, jax_route):
    data = _data(name, request)
    et = compress_host(data)
    jax_route(mode)
    got = td.decompress_device(et, device="cpu", chunk_bytes=chunk, expand=mode)
    assert got == jd.decompress_device(et, chunk_bytes=chunk) == data


def _outcome(fn, et: bytes):
    try:
        return fn(et)
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("mode", ROUTES)
@pytest.mark.parametrize("cut", [10, 600])
def test_truncated_body_same_error(cut, mode, midsummer, jax_route):
    et = compress_host(midsummer)
    bad = et[: parse_header(et).body_start + cut]
    jax_route(mode)
    got = _outcome(lambda b: entreepy_tpu_torch.decompress(b, backend="device", device="cpu",
                                                           expand=mode), bad)
    want = _outcome(lambda b: entreepy_tpu.decompress(b, backend="device"), bad)
    assert isinstance(got, tuple) and "ended early" in got[1]
    assert got == want


@pytest.mark.parametrize("mode", ROUTES)
@pytest.mark.parametrize("name,seed", [("midsummer", 5), ("skewed", 11)])
def test_corrupt_body_same_outcome(name, seed, mode, request, jax_route):
    """Flipped body bytes: accepted with the same bytes or rejected with the
    same error as the matching JAX route; at least one flip is caught."""
    et = bytearray(compress_host(_data(name, request)))
    start = parse_header(bytes(et)).body_start
    rng = np.random.default_rng(seed)
    jax_route(mode)
    rejected = 0
    for _ in range(8):
        pos = int(rng.integers(start + 5, len(et) - 16))
        bad = bytes(et[:pos]) + bytes([et[pos] ^ 0xFF]) + bytes(et[pos + 1:])
        got = _outcome(
            lambda b: entreepy_tpu_torch.decompress(b, backend="device", device="cpu",
                                                    expand=mode), bad)
        assert got == _outcome(lambda b: entreepy_tpu.decompress(b, backend="device"), bad)
        rejected += isinstance(got, tuple)
    assert rejected >= 1


@pytest.mark.parametrize("mode", ROUTES)
def test_unconverged_state_pass_uses_host_decoder(mode, monkeypatch, midsummer):
    data = midsummer[:20000]
    et = compress_host(data)
    real = td.fsm8_decode
    monkeypatch.setattr(td, "fsm8_decode", lambda *a: (real(*a)[0], True))
    before = td.decode_host.calls
    assert td.decompress_device(et, device="cpu", expand=mode) == data
    assert td.decode_host.calls == before + 1


# the compaction's stage ``plane_compact`` nests in ``device_expand``, so it ends first
DEVICE_STAGES = ["parse_header", "fsm_build", "decode_tables", "body_upload",
                 "device_fsm8_decode", "plane_compact", "device_expand", "device_sym_fetch",
                 "host_extract", "host_validate", "host_check_bits", "join_output"]


@pytest.mark.parametrize("mode,stages", [
    ("split", DEVICE_STAGES), ("fused", DEVICE_STAGES),
    ("host", ["parse_header", "fsm_build", "decode_tables", "body_upload",
              "device_fsm8_decode", "device_state_fetch", "host_expand", "join_output"]),
])
def test_record_stages_per_route(mode, stages, midsummer):
    et = compress_host(midsummer)
    port_fsm8._FSM_CACHE.clear()  # so the call builds its byte automaton
    with trace.record_stages() as got:
        assert entreepy_tpu_torch.decompress(et, backend="device", device="cpu",
                                             expand=mode) == midsummer
    assert list(got) == stages
    assert all(ms >= 0 for ms in got.values())


@pytest.mark.parametrize("mode", ROUTES)
def test_route_leaves_jax_out(mode):
    code = (
        "import sys, entreepy_tpu_torch as et\n"
        "data = b'jax-free two-pass round trip ' * 50\n"
        "p = et.compress(data, backend='host')\n"
        f"assert et.decompress(p, backend='device', device='cpu', expand={mode!r}) == data\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_unknown_route_raises(macbeth):
    et = compress_host(macbeth)
    for call in (lambda: entreepy_tpu_torch.decompress(et, backend="device", device="cpu",
                                                       expand="bogus"),
                 lambda: entreepy_tpu_torch.decompress(et, backend="host", expand="bogus"),
                 lambda: td.decompress_device(et, device="cpu", expand="bogus"),
                 lambda: decompress_sharded(et, make_mesh(devices=["cpu"]), expand="bogus")):
        with pytest.raises(ValueError, match="expand route"):
            call()
    assert entreepy_tpu_torch.decompress(et, backend="device", device="cpu",
                                         expand="onepass") == macbeth
