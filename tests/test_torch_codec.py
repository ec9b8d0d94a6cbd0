"""The whole port on ``device="cpu"`` (the kernels' plain versions) against
the JAX package: byte-identical .et files, exact round trips, and the same
accept/reject on truncated and corrupt streams."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import entreepy_tpu  # noqa: E402
from entreepy_tpu.format import compress_host, parse_header  # noqa: E402
from entreepy_tpu.ops import decode8 as jax_decode8  # noqa: E402

import entreepy_tpu_torch  # noqa: E402
from entreepy_tpu_torch import trace  # noqa: E402
from entreepy_tpu_torch.format import fsm8 as port_fsm8  # noqa: E402
from entreepy_tpu_torch.ops import decode8, encode  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"


def _stats_corpus(kind: str) -> bytes:
    """~100 KB of the benchmarks/scale.py corpus families, plus NUL symbols."""
    rng = np.random.default_rng(1234)
    n = 100_000
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "skewed":
        p = 1.0 / np.arange(1, 257) ** 1.3
        return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()
    if kind == "runheavy":
        unit = b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        return (unit * (-(-n // len(unit))))[:n]
    if kind == "nul":
        return b"\x00" * 500 + bytes(range(1, 40)) * 10 + b"\x00" * 3
    raise ValueError(kind)


def _data(name: str, request) -> bytes:
    if name in ("tiny_text", "macbeth", "midsummer"):
        return request.getfixturevalue(name)
    return _stats_corpus(name)


@pytest.mark.parametrize(
    "name", ["tiny_text", "macbeth", "midsummer", "random", "skewed", "runheavy", "nul"]
)
def test_roundtrip_matches_jax(name, request):
    data = _data(name, request)
    et = entreepy_tpu_torch.compress(data, backend="device", device="cpu")
    assert et == compress_host(data)
    assert et == entreepy_tpu.compress(data, backend="device")
    assert entreepy_tpu_torch.decompress(et, backend="device", device="cpu") == data


@pytest.mark.parametrize("block_bytes", [64, 256, 1024, 4096])
def test_block_size_invariance(block_bytes, midsummer):
    data = midsummer[:30000]
    ref = entreepy_tpu.compress(data, backend="device")
    assert ref == compress_host(data)
    assert encode.compress_device(data, device="cpu", block_bytes=block_bytes) == ref


@pytest.mark.parametrize("chunk_bytes", [16, 64, 512])
@pytest.mark.parametrize("name", ["midsummer", "skewed"])
def test_chunk_size_invariance(chunk_bytes, name, request):
    data = _data(name, request)
    et = compress_host(data)
    got = decode8.decompress_device(et, device="cpu", chunk_bytes=chunk_bytes)
    assert got == jax_decode8.decompress_device(et, chunk_bytes=chunk_bytes) == data


def test_golden_fixture(macbeth):
    golden = (DATA / "nice.shakespeare.et").read_bytes()
    assert len(golden) == 374
    assert entreepy_tpu_torch.compress(macbeth, backend="device", device="cpu") == golden
    assert entreepy_tpu_torch.decompress(golden, backend="device", device="cpu") == macbeth


def _outcome(fn, et: bytes):
    try:
        return fn(et)
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.fixture
def jax_full_route(monkeypatch):
    """The JAX device backend's fully on-device route (its pod default),
    the route the port carries: same checks, same error messages."""
    monkeypatch.setenv("ENTREEPY_DEVICE_E2E", "1")


@pytest.mark.parametrize("cut", [10, 600])
def test_truncated_body_same_error(cut, midsummer, jax_full_route):
    et = compress_host(midsummer)
    bad = et[: parse_header(et).body_start + cut]
    got = _outcome(lambda b: entreepy_tpu_torch.decompress(b, backend="device", device="cpu"), bad)
    want = _outcome(lambda b: entreepy_tpu.decompress(b, backend="device"), bad)
    assert isinstance(got, tuple) and "ended early" in got[1]
    assert got == want


@pytest.mark.parametrize("name,seed", [("midsummer", 5), ("skewed", 11)])
def test_corrupt_body_same_outcome(name, seed, request, jax_full_route):
    """Flipped body bytes: accepted with the same bytes or rejected with the
    same error as the JAX device backend; at least one flip is caught."""
    et = bytearray(compress_host(_data(name, request)))
    start = parse_header(bytes(et)).body_start
    rng = np.random.default_rng(seed)
    rejected = 0
    for _ in range(8):
        pos = int(rng.integers(start + 5, len(et) - 16))
        bad = bytes(et[:pos]) + bytes([et[pos] ^ 0xFF]) + bytes(et[pos + 1:])
        got = _outcome(
            lambda b: entreepy_tpu_torch.decompress(b, backend="device", device="cpu"), bad)
        assert got == _outcome(lambda b: entreepy_tpu.decompress(b, backend="device"), bad)
        rejected += isinstance(got, tuple)
    assert rejected >= 1


def test_invalid_edge_rejected():
    """A table missing a symbol: its bits walk a dead trie edge."""
    from entreepy_tpu.format import build_code_table, histogram, pack_body_host
    from entreepy_tpu.format.huffman import CodeTable

    data = (b"abcdef" * 200) + b"g" + (b"abcdef" * 200)
    arr = np.frombuffer(data, np.uint8)
    table = build_code_table(histogram(arr))
    body, _ = pack_body_host(arr, table)
    lengths, codes = table.lengths.copy(), table.codes.copy()
    lengths[ord("g")] = codes[ord("g")] = 0
    pruned = CodeTable(codes, lengths)
    with pytest.raises(ValueError, match="invalid bitstream|corrupt|ended early"):
        decode8.decode_body_device_tiled(body, pruned, arr.size, device="cpu")


def test_unconverged_self_sync_uses_host_decoder(monkeypatch, midsummer):
    data = midsummer[:20000]
    et = compress_host(data)
    real = decode8.fsm8_decode_fused
    monkeypatch.setattr(decode8, "fsm8_decode_fused",
                        lambda *a, **k: (*real(*a, **k)[:2], True))
    before = decode8.decode_host.calls
    assert decode8.decompress_device(et, device="cpu") == data
    assert decode8.decode_host.calls == before + 1


def test_device_backend_needs_cuda(monkeypatch):
    """No CUDA device and no explicit device: raise, never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def ran(*a, **k):
        raise AssertionError("the device path ran without a CUDA device")

    monkeypatch.setattr(encode, "compress_device", ran)
    monkeypatch.setattr(decode8, "decompress_device", ran)
    et = compress_host(b"abracadabra")
    for call in (lambda: entreepy_tpu_torch.compress(b"abracadabra", backend="device"),
                 lambda: entreepy_tpu_torch.decompress(et, backend="device"),
                 lambda: entreepy_tpu_torch.compress(b"abracadabra", backend="device",
                                                     device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


def test_backends_and_helpers(tmp_path, macbeth):
    assert entreepy_tpu_torch.compress(macbeth, backend="host") == compress_host(macbeth)
    et = compress_host(macbeth)
    assert entreepy_tpu_torch.decompress(et, backend="host") == macbeth
    assert entreepy_tpu_torch.inspect(et) == entreepy_tpu.inspect(et)
    # backend=None routes (auto: the host codec for a small input)
    assert entreepy_tpu_torch.compress(macbeth, backend=None) == et
    assert entreepy_tpu_torch.decompress(et, backend=None) == macbeth
    with pytest.raises(ValueError):
        entreepy_tpu_torch.compress(macbeth, backend="tpu")
    # backend="sharded" runs: one rank without a process group
    assert entreepy_tpu_torch.compress(macbeth, backend="sharded", device="cpu") == et
    assert entreepy_tpu_torch.decompress(et, backend="sharded", device="cpu") == macbeth
    src = tmp_path / "m.txt"
    src.write_bytes(macbeth)
    out = entreepy_tpu_torch.compress_file(src, backend="device", device="cpu")
    assert out == str(src) + ".et"
    back = entreepy_tpu_torch.decompress_file(out, backend="device", device="cpu")
    assert Path(back).read_bytes() == macbeth


def test_record_stages_times_every_stage(midsummer):
    """Stage recording sees each pipeline stage once per call (the byte
    automaton's build on a miss of its cache, nested in ``decode_tables``,
    ends first) and leaves the output unchanged; outside the block nothing
    is recorded."""
    et = compress_host(midsummer)
    port_fsm8._FSM_CACHE.clear()
    with trace.record_stages() as enc:
        assert entreepy_tpu_torch.compress(midsummer, backend="device", device="cpu") == et
    with trace.record_stages() as dec:
        assert entreepy_tpu_torch.decompress(et, backend="device", device="cpu") == midsummer
    assert list(enc) == ["input_upload", "device_histogram", "code_table", "join_tiles",
                         "device_pack", "sizing_fetch", "device_compact", "device_stitch",
                         "device_fetch", "serialize"]
    assert list(dec) == ["parse_header", "fsm_build", "decode_tables", "body_upload",
                         "device_fsm8_decode", "device_expand", "device_sym_fetch",
                         "host_extract", "host_validate", "host_check_bits", "join_output"]
    assert all(ms >= 0 for ms in [*enc.values(), *dec.values()])
    entreepy_tpu_torch.decompress(et, backend="device", device="cpu")
    assert len(dec) == 11


def test_import_leaves_jax_out():
    code = (
        "import sys, entreepy_tpu_torch as et\n"
        "import entreepy_tpu_torch.ops.decode8, entreepy_tpu_torch.ops.encode\n"
        "p = et.compress(b'jax-free round trip', backend='device', device='cpu')\n"
        "assert et.decompress(p, backend='device', device='cpu') == b'jax-free round trip'\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [n for n in sys.modules if n.split('.')[0] == 'entreepy_tpu']\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr


# --- auto-routing (backend=None) against the JAX package's rule ---

POD, DMIN = entreepy_tpu_torch.api.POD_DEVICE_MIN, entreepy_tpu_torch.api.DEVICE_MIN_BYTES


@pytest.fixture
def apis(monkeypatch):
    """Both packages' api modules under the same patches, with a CUDA device
    present for the port (the JAX package always has a device; its
    multi-device test mesh says "sharded" where the port says "device")."""
    from entreepy_tpu import api as japi
    from entreepy_tpu_torch import api as tapi

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("ENTREEPY_DEVICE_MIN", raising=False)
    return japi, tapi


def _boom():
    raise AssertionError("calibration probe ran for a small input")


@pytest.mark.parametrize("env,runtime_ok,fast,n,want", [
    ("1024", True, None, 1 << 20, "device"),
    ("1024", True, None, 10, "host"),
    (None, True, None, POD - 1, "host"),
    (None, True, True, POD, "device"),
    (None, True, False, POD, "host"),
    (None, False, None, DMIN, "device"),
    (None, False, None, 10, "host"),
])
def test_pick_backend_matches_jax(env, runtime_ok, fast, n, want, apis, monkeypatch):
    from entreepy_tpu import runtime as jruntime

    from entreepy_tpu_torch import runtime as truntime

    japi, tapi = apis
    assert (tapi.POD_DEVICE_MIN, tapi.DEVICE_MIN_BYTES, tapi.H2D_MIN_BYTES_PER_S) == (
        japi.POD_DEVICE_MIN, japi.DEVICE_MIN_BYTES, japi.H2D_MIN_BYTES_PER_S)
    if env is not None:
        monkeypatch.setenv("ENTREEPY_DEVICE_MIN", env)
    for runtime in (jruntime, truntime):  # each package asks its own host runtime
        monkeypatch.setattr(runtime, "available", lambda: runtime_ok)
    for mod in (japi, tapi):
        monkeypatch.setattr(mod, "_h2d_fast", _boom if fast is None else (lambda: fast))
    jax_pick = japi._pick_backend(None, n)
    assert {"sharded": "device"}.get(jax_pick, jax_pick) == tapi._pick_backend(None, n) == want


@pytest.mark.parametrize("world,want", [(None, "device"), (1, "device"), (2, "sharded"),
                                        (4, "sharded")])
def test_auto_picks_sharded_in_a_group(world, want, apis, monkeypatch):
    """Where the JAX package picks "sharded" (more than one device), the
    port picks it in a process group of more than one rank: one rank drives
    one card. A process that sees one card, without a group of more than
    one rank, stays on "device" (more cards: test_torch_localmesh.py)."""
    _, tapi = apis
    monkeypatch.setattr(tapi, "_h2d_fast", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: world is not None)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: world)
    assert tapi._pick_backend(None, POD) == want
    assert tapi._pick_backend(None, POD - 1) == "host"


@pytest.mark.parametrize("name", ["macbeth", "midsummer", "skewed"])
def test_sharded_backend_matches_jax(name, request):
    """backend="sharded" on the CPU gives the JAX package's sharded bytes
    (its 8-device test mesh) and round-trips on every route."""
    from entreepy_tpu.parallel import compress_sharded, make_mesh

    data = _data(name, request)
    et = entreepy_tpu_torch.compress(data, backend="sharded", device="cpu")
    assert et == compress_sharded(data, make_mesh(8)) == compress_host(data)
    for route in decode8.EXPAND_MODES:
        assert entreepy_tpu_torch.decompress(et, backend="sharded", device="cpu",
                                             expand=route) == data


def test_device_min_env_warns(apis, monkeypatch):
    japi, tapi = apis
    monkeypatch.setenv("ENTREEPY_DEVICE_MIN", "not-a-number")
    for mod in (japi, tapi):
        with pytest.warns(UserWarning, match="ENTREEPY_DEVICE_MIN"):
            assert mod._pick_backend(None, 10) == "host"


def test_h2d_calibration_deadline(monkeypatch):
    """A hung probe leaves auto on the host within the deadline; the answer
    is cached per process."""
    import time

    from entreepy_tpu_torch import api as tapi

    monkeypatch.setattr(tapi, "_h2d_fast_cache", [])
    monkeypatch.setattr(tapi, "_h2d_probe", lambda: (time.sleep(5), True)[1])
    t0 = time.perf_counter()
    assert tapi._h2d_fast(deadline_s=0.2) is False
    assert time.perf_counter() - t0 < 2
    assert tapi._h2d_fast(deadline_s=0.2) is False  # cached: no second probe
    monkeypatch.setattr(tapi, "_h2d_fast_cache", [])
    monkeypatch.setattr(tapi, "_h2d_probe", lambda: True)
    assert tapi._h2d_fast() is True


@pytest.mark.parametrize("stalls,want", [((1.0, 1e-4, 1e-4), True), ((1e-4, 1.0, 1.0), True),
                                         ((1.0, 1.0, 1.0), False)])
def test_h2d_probe_takes_fastest_copy(stalls, want, monkeypatch):
    """The probe times three 1 MiB copies and judges the link by the
    fastest: one stalled copy (100 ms or more) does not route auto to the
    host; three do."""
    import time

    from entreepy_tpu_torch import api as tapi

    clock = iter(t for d in stalls for t in (0.0, d))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    assert tapi._h2d_probe() is want


def test_auto_without_cuda_routes_host(monkeypatch):
    """No CUDA device: the probe says slow and auto never picks the device
    backend, at any size; an explicit backend="device" still raises."""
    from entreepy_tpu_torch import api as tapi

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("ENTREEPY_DEVICE_MIN", raising=False)
    assert tapi._h2d_probe() is False
    for n in (10, DMIN, POD, 1 << 40):
        assert tapi._pick_backend(None, n) == "host"
    monkeypatch.setenv("ENTREEPY_DEVICE_MIN", "0")
    assert tapi._pick_backend(None, 1 << 40) == "host"
    with pytest.raises(tapi.NoCudaDeviceError):
        tapi.compress(b"abracadabra", backend="device")


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Names of the kernel wrappers called (on the CPU a wrapper runs its
    plain version and counts no launch, so the calls are spied)."""
    from entreepy_tpu_torch.ops import bitpack, cuda_fsm8

    calls = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(name)
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    for mod, names in ((encode, ["pack_blocks"]), (bitpack, ["compact_rows"]),
                       (decode8, ["sync_pass", "fused_pass", "emit_pass", "compact_rows"]),
                       (cuda_fsm8, ["expand_pass", "expand_pass_split"])):
        for name in names:
            spy(mod, name)
    return calls


def test_auto_small_call_launches_no_kernel(wrapper_calls, macbeth):
    """The default moved to auto: a small call with neither backend= nor
    device= runs the host codec; one that names the device backend, or
    only its device, runs the kernels; a device with backend="host" is an
    error, not dropped."""
    et = compress_host(macbeth)
    assert entreepy_tpu_torch.compress(macbeth) == et
    assert entreepy_tpu_torch.decompress(et) == macbeth
    assert wrapper_calls == []
    for kw in ({"backend": "device", "device": "cpu"}, {"device": "cpu"}):
        assert entreepy_tpu_torch.compress(macbeth, **kw) == et
        assert "pack_blocks" in wrapper_calls and "compact_rows" in wrapper_calls
        wrapper_calls.clear()
        assert entreepy_tpu_torch.decompress(et, **kw) == macbeth
        assert "sync_pass" in wrapper_calls and "fused_pass" in wrapper_calls
        wrapper_calls.clear()
    for call in (lambda: entreepy_tpu_torch.compress(macbeth, backend="host", device="cpu"),
                 lambda: entreepy_tpu_torch.decompress(et, backend="host", device="cpu")):
        with pytest.raises(ValueError, match="backend='host'"):
            call()
    assert wrapper_calls == []
