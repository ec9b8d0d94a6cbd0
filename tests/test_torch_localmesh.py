"""The port's local mesh (one process, one rank per device, each rank in a
thread of its own) against the JAX package's single-process mesh
(``entreepy_tpu.parallel.make_mesh(n)`` over the virtual CPU devices of
tests/conftest.py) and the host codec, on the CPU: meshes of 1, 2 and 4
ranks of ``["cpu"] * n`` run the kernels' plain versions. Tolerance: exact
equality of every byte. Also the threads' shared state (launch counts,
stage records), auto's rule against the JAX package's, the hybrid mesh
refused, and ``--backend sharded`` in one process.
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entreepy_tpu_torch import _build, api, cli, trace  # noqa: E402
from entreepy_tpu_torch.format import compress_host as port_compress_host  # noqa: E402
from entreepy_tpu_torch.format import fsm8 as port_fsm8  # noqa: E402
from entreepy_tpu_torch.format import parse_header  # noqa: E402
from entreepy_tpu_torch.ops import decode8  # noqa: E402
from entreepy_tpu_torch.parallel import compress_sharded, decompress_sharded, make_mesh  # noqa: E402
from entreepy_tpu_torch.parallel import dist as pdist  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
ROUTES = ("onepass", "split", "fused", "host")
WORLDS = (1, 2, 4)
BLOCK = 2048
# An exchange's barrier timeout for the error tests: far above what they take
TEST_TIMEOUT_S = 60.0


def _skewed(n: int = 40_000) -> bytes:
    """Zipf-like bytes (m > 3: the unpacked one-pass rows)."""
    p = 1.0 / np.arange(1, 257) ** 1.3
    rng = np.random.default_rng(11)
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


def _corpus(name: str) -> bytes:
    if name == "skewed":
        return _skewed()
    return (DATA / "a_midsummer_nights_dream.txt").read_bytes()[:60_000]


def _local(n: int):
    return make_mesh(devices=["cpu"] * n)


def _rank_threads() -> list[str]:
    return [t.name for t in threading.enumerate() if t.name.startswith("entreepy-rank-")]


@pytest.fixture(scope="module")
def host_ets():
    return {name: port_compress_host(_corpus(name)) for name in ("text", "skewed")}


# --- the mesh ---

@pytest.mark.parametrize("n", WORLDS)
def test_make_mesh_of_cpu_devices(n):
    mesh = _local(n)
    assert (mesh.world, mesh.local, mesh.group) == (n, n > 1, None)
    assert mesh.devices == ((torch.device("cpu"),) * n if n > 1 else ())


@pytest.mark.parametrize("cards,n_devices,want", [(4, None, 4), (4, 2, 2), (1, None, 1),
                                                   (2, 1, 1)])
def test_make_mesh_takes_the_first_cards(cards, n_devices, want, monkeypatch):
    """The JAX make_mesh(n_devices): the first n cards, all by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    mesh = make_mesh(n_devices)
    assert mesh.world == want
    assert mesh.devices == (tuple(torch.device(f"cuda:{i}") for i in range(want))
                            if want > 1 else ())
    assert mesh.device == torch.device("cuda:0")


def test_make_mesh_too_many_devices_like_jax(monkeypatch):
    from entreepy_tpu.parallel import make_mesh as jax_make_mesh

    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(9)  # tests/conftest.py's 8 virtual devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError) as err:
        make_mesh(9)
    assert str(err.value) == str(jax_err.value)


def test_make_mesh_device_is_one_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_mesh(device="cuda:2")
    assert (mesh.world, mesh.local, mesh.device) == (1, False, torch.device("cuda:2"))
    with pytest.raises(ValueError, match="pass device"):
        make_mesh(2, device="cuda:2")


@pytest.mark.parametrize("kw,n", [({"n_devices": 2}, 2), ({"devices": ["cpu"] * 3}, 3)])
def test_hybrid_raises(kw, n, monkeypatch):
    """A group of several ranks asked for several devices per process: not
    ported, and the error names both counts."""
    group = object()  # a group of two ranks, this process rank 0
    monkeypatch.setattr(torch.distributed, "get_rank", lambda g: 0 if g is group else -1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda g: 2 if g is group else -1)
    with pytest.raises(ValueError, match=f"a process group of 2 ranks, and {n} devices"):
        make_mesh(group=group, **kw)


# --- the codec against the JAX package's mesh ---

@pytest.mark.parametrize("corpus", ["text", "skewed"])
@pytest.mark.parametrize("n", WORLDS)
def test_compress_matches_jax(n, corpus, host_ets):
    from entreepy_tpu.parallel import compress_sharded as jax_compress_sharded
    from entreepy_tpu.parallel import make_mesh as jax_make_mesh

    data = _corpus(corpus)
    et = compress_sharded(data, _local(n), block_bytes=BLOCK)
    assert et == jax_compress_sharded(data, jax_make_mesh(n), block_bytes=BLOCK) == host_ets[corpus]
    st = pdist.last_encode_stats
    assert len(st.get("ranks", [st])) == n
    assert (st["payload_bits"] + 7) // 8 == len(et) - parse_header(et).body_start


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("corpus", ["text", "skewed"])
@pytest.mark.parametrize("n", WORLDS)
def test_round_trip(n, corpus, route, host_ets):
    data = _corpus(corpus)
    assert decompress_sharded(host_ets[corpus], _local(n), expand=route) == data
    passes = [r["passes"] for r in pdist.last_decode_stats.get("ranks", [pdist.last_decode_stats])]
    assert len(passes) == n and len(set(passes)) == 1 and passes[0] >= 1
    assert _rank_threads() == []


@pytest.mark.parametrize("n", [2, 4])
def test_fewer_blocks_than_ranks(n):
    data = b"hello hello hello"
    et = compress_sharded(data, _local(n), block_bytes=1024)  # one block
    assert et == port_compress_host(data)
    for route in ("onepass", "host"):
        assert decompress_sharded(et, _local(n), expand=route) == data


@pytest.mark.parametrize("n", [2, 4])
def test_big_body_escape(n, monkeypatch, host_ets):
    """A rank slice at or past _INT32_SAFE_BODY: the process decodes the
    whole body once through the tiled decode, on the mesh's first device,
    with no rank thread (lowered to run at test scale)."""
    calls = []
    real = decode8.decode_body_device_tiled
    monkeypatch.setattr(decode8, "decode_body_device_tiled",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(pdist, "_INT32_SAFE_BODY", 1024)
    assert decompress_sharded(host_ets["text"], _local(n)) == _corpus("text")
    assert len(calls) == 1
    assert pdist.last_decode_stats == {}


@pytest.mark.parametrize("n", [2, 4])
def test_unconverged_uses_host_decoder(n, monkeypatch, host_ets):
    """Decided on gathered values, so every rank agrees, and the process
    takes the serial decoder once."""
    real = decode8.fsm8_decode_fused
    monkeypatch.setattr(decode8, "fsm8_decode_fused",
                        lambda *a, **k: (*real(*a, **k)[:2], True))
    before = decode8.decode_host.calls
    assert decompress_sharded(host_ets["text"], _local(n)) == _corpus("text")
    assert decode8.decode_host.calls == before + 1
    assert len(pdist.last_decode_stats["ranks"]) == n


@pytest.mark.parametrize("n", [2, 4])
def test_host_route_fetches_own_states(n, host_ets):
    """Each rank fetches at most 1/world of the states and expands only its
    own symbols (the JAX package's 1/N multi-host fetch)."""
    assert decompress_sharded(host_ets["text"], _local(n), expand="host") == _corpus("text")
    ranks = pdist.last_decode_stats["ranks"]
    assert len(ranks) == n
    for st in ranks:
        assert 0 < st["fetched_states_bytes"] <= st["total_states_bytes"] / n, st
    assert sum(st["local_symbols"] for st in ranks) == ranks[0]["n_symbols"]


# --- errors: in the caller, once, and no thread left ---

def _truncated() -> bytes:
    et = port_compress_host((DATA / "nice.shakespeare.txt").read_bytes() * 8)
    hdr = parse_header(et)
    return et[: hdr.body_start + (len(et) - hdr.body_start) // 2]


@pytest.fixture(scope="module")
def jax_truncated_error():
    from entreepy_tpu.parallel import decompress_sharded as jax_decompress_sharded
    from entreepy_tpu.parallel import make_mesh as jax_make_mesh

    with pytest.raises(ValueError) as e:
        jax_decompress_sharded(_truncated(), jax_make_mesh(4), device_expand=True)
    return str(e.value)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", [2, 4])
def test_truncated_raises_jax_message(n, route, jax_truncated_error, monkeypatch):
    monkeypatch.setattr(pdist, "LOCAL_TIMEOUT_S", TEST_TIMEOUT_S)
    t0 = time.monotonic()
    with pytest.raises(ValueError) as e:
        decompress_sharded(_truncated(), _local(n), expand=route)
    assert time.monotonic() - t0 < TEST_TIMEOUT_S
    assert str(e.value).split(":")[0] == jax_truncated_error.split(":")[0]
    assert _rank_threads() == []


def _on_rank(r: int, fn):
    """``fn`` wrapped to act only in the thread of rank ``r``."""
    def wrapped(*a, **k):
        if threading.current_thread().name == f"entreepy-rank-{r}":
            return fn(*a, **k)
        return real(*a, **k)
    real = pdist.histogram_device
    return wrapped


def test_one_rank_error_aborts_the_others(monkeypatch):
    """Rank 1 raises before the histogram's all-reduce: the other ranks stop
    at that exchange (the barrier is aborted) instead of waiting out the
    timeout, and the caller gets rank 1's error."""
    def boom(*a, **k):
        raise ValueError("boom on rank 1")

    monkeypatch.setattr(pdist, "LOCAL_TIMEOUT_S", TEST_TIMEOUT_S)
    monkeypatch.setattr(pdist, "histogram_device", _on_rank(1, boom))
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="boom on rank 1"):
        compress_sharded(_corpus("text"), _local(4), block_bytes=BLOCK)
    assert time.monotonic() - t0 < TEST_TIMEOUT_S / 4
    assert _rank_threads() == []


def test_barrier_timeout_bounds_a_hang(monkeypatch):
    """A rank that does not reach an exchange in LOCAL_TIMEOUT_S breaks the
    barrier: every rank stops and the call raises TimeoutError."""
    real = pdist.histogram_device

    def slow(*a, **k):
        time.sleep(2.0)
        return real(*a, **k)

    monkeypatch.setattr(pdist, "LOCAL_TIMEOUT_S", 0.5)
    monkeypatch.setattr(pdist, "histogram_device", _on_rank(0, slow))
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="waited more than 0.5 s"):
        compress_sharded(_corpus("text"), _local(2), block_bytes=BLOCK)
    assert time.monotonic() - t0 < 10
    assert _rank_threads() == []


# --- what the ranks' threads share ---

def test_launch_counts_exact_under_threads():
    """_build.count_launch from more threads than cores, with a short switch
    interval: no count is lost (``+= 1`` alone loses some)."""
    @_build.counted
    def wrapper():
        pass

    per_thread, threads = 2000, 4 * 8
    devices = [torch.device(f"cuda:{i}") for i in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda d=devices[i % 4]: [
            _build.count_launch(wrapper, d) for _ in range(per_thread)]) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == threads * per_thread
    assert wrapper.launches_on == {i: threads * per_thread // 4 for i in range(4)}


def test_stage_records_are_per_thread():
    """Each thread's record_stages sees its own stages only."""
    got, barrier = {}, threading.Barrier(2, timeout=30)

    def work(name: str):
        with trace.record_stages() as stages:
            barrier.wait()
            with trace.phase(name):
                barrier.wait()
        got[name] = stages

    workers = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    assert not any(w.is_alive() for w in workers)
    assert {k: list(v) for k, v in got.items()} == {"a": ["a"], "b": ["b"]}
    assert trace.current() is None


def test_local_mesh_stages(host_ets):
    """Under the caller's record, each rank records its own stages, and the
    caller's record gets the byte automaton's build (the caller's, on a miss
    of its cache), each stage's slowest rank, then the host tail's stages,
    which only the caller runs."""
    port_fsm8._FSM_CACHE.clear()
    with trace.record_stages() as stages:
        assert decompress_sharded(host_ets["text"], _local(2)) == _corpus("text")
    ranks = pdist.last_decode_stats["ranks"]
    tail = ["host_validate", "host_join", "host_check_bits"]
    assert list(stages)[0] == "fsm_build"
    assert [list(r["stages"]) for r in ranks] == [list(stages)[1: -len(tail)]] * 2
    assert list(stages)[-len(tail):] == tail
    assert "allgather_exits" in stages and "gather_symbols" in stages
    for name in list(stages)[1: -len(tail)]:
        assert stages[name] == max(r["stages"][name] for r in ranks)


@pytest.mark.parametrize("op", ["compress", "decompress"])
@pytest.mark.parametrize("n", [2, 4])
def test_host_tail_runs_once(n, op, monkeypatch, host_ets):
    """The whole-input host work runs once in the caller, never in a rank
    thread: the block split, the stitch and the serialize of a compress;
    the validation, the join and the exact-bit check of a decompress."""
    where = []

    def spy(module, name):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: where.append(
            (name, threading.current_thread().name)) or real(*a, **k))

    data = _corpus("text")
    if op == "compress":
        names = ["split_blocks", "stitch_flat_payload", "serialize_header"]
        for name in names:
            spy(pdist, name)
        assert compress_sharded(data, _local(n), block_bytes=BLOCK) == host_ets["text"]
    else:
        names = ["validate_chunk_meta", "_check_stream_bits"]
        for name in names:
            spy(decode8, name)
        assert decompress_sharded(host_ets["text"], _local(n)) == data
    main = threading.main_thread().name
    assert where == [(name, main) for name in names]


@pytest.mark.parametrize("route", ["onepass", "split", "fused"])
def test_card_and_mesh_run_one_route_step(route, monkeypatch, host_ets):
    """One device and each rank of a local mesh decode through the same
    route step of ``decode8``: its passes half, then its symbols half, for
    the route asked for, so the two paths cannot fork again."""
    import inspect

    steps = []

    def spy(name):
        real = getattr(decode8, name)
        sig = inspect.signature(real)

        def step(*a, **k):
            expand = sig.bind(*a, **k).arguments["expand"]
            steps.append((name, expand, threading.current_thread().name))
            return real(*a, **k)

        monkeypatch.setattr(decode8, name, step)

    for name in ("route_passes", "route_symbols"):
        spy(name)
    halves = [("route_passes", route), ("route_symbols", route)]
    assert decode8.decompress_device(host_ets["text"], device="cpu", expand=route) == _corpus("text")
    assert steps == [(*h, threading.main_thread().name) for h in halves]
    steps.clear()
    assert decompress_sharded(host_ets["text"], _local(2), expand=route) == _corpus("text")
    for r in range(2):
        assert [s[:2] for s in steps if s[2] == f"entreepy-rank-{r}"] == halves
    assert len(steps) == 2 * len(halves)


# --- auto and the CLI ---

@pytest.mark.parametrize("n_bytes", [999, 1000])
@pytest.mark.parametrize("cards", [1, 2])
def test_auto_picks_like_jax(cards, n_bytes, monkeypatch):
    """At or above the threshold, more than one device picks sharded, one
    picks device; below it, host: the JAX package's rule."""
    import jax

    from entreepy_tpu import api as jax_api

    monkeypatch.setenv("ENTREEPY_DEVICE_MIN", "1000")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(jax, "device_count", lambda: cards)
    got = api._pick_backend(None, n_bytes)
    assert got == jax_api._pick_backend(None, n_bytes)
    assert got == ("host" if n_bytes < 1000 else "sharded" if cards > 1 else "device")


@pytest.fixture
def two_rank_default_mesh(monkeypatch):
    """make_mesh() as the API calls it, on a machine of two cards: a local
    mesh of two ranks, here of the plain versions on the CPU. Records each
    call's arguments."""
    import entreepy_tpu_torch.parallel as par

    calls = []
    real = par.make_mesh

    def fake(*a, **k):
        calls.append((a, k))
        return real(devices=["cpu", "cpu"]) if not a and k.get("device") is None else real(*a, **k)

    monkeypatch.setattr(par, "make_mesh", fake)
    return calls


def test_api_sharded_defaults_to_every_card(two_rank_default_mesh, host_ets):
    data = _corpus("text")
    assert api.compress(data, backend="sharded") == host_ets["text"]
    assert len(pdist.last_encode_stats["ranks"]) == 2
    assert api.decompress(host_ets["text"], backend="sharded", expand="host") == data
    assert len(pdist.last_decode_stats["ranks"]) == 2
    assert two_rank_default_mesh == [((), {"device": None})] * 2


def test_cli_backend_sharded_in_one_process(two_rank_default_mesh, tmp_path, host_ets):
    src = tmp_path / "m.txt"
    src.write_bytes(_corpus("text"))
    assert cli.main(["--backend", "sharded", "c", str(src)]) == 0
    assert len(pdist.last_encode_stats["ranks"]) == 2
    assert (tmp_path / "m.txt.et").read_bytes() == host_ets["text"]
    assert cli.main(["--backend", "sharded", "d", str(tmp_path / "m.txt.et")]) == 0
    assert len(pdist.last_decode_stats["ranks"]) == 2
    assert (tmp_path / "decoded_m.txt").read_bytes() == _corpus("text")
    assert two_rank_default_mesh == [((), {"device": None})] * 2
