"""The port's sharded codec (``entreepy_tpu_torch.parallel``) against the JAX
package's (``entreepy_tpu.parallel``) and the host codec, on the CPU.

World 1 runs in this process, with no process group (``device="cpu"``: the
kernels' plain versions). Worlds of 2 and 4 ranks run as gloo process
groups: this file is also the worker (``python tests/test_torch_parallel.py
WORLD RANK PORT OUT``), which runs every case on its rank, imports no JAX,
and writes one JSON of results that the parametrised tests below read.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entreepy_tpu_torch import trace  # noqa: E402
from entreepy_tpu_torch.format import compress_host as port_compress_host  # noqa: E402
from entreepy_tpu_torch.format import parse_header  # noqa: E402
from entreepy_tpu_torch.parallel import (  # noqa: E402
    compress_sharded, decompress_sharded, make_mesh, multihost,
)
from entreepy_tpu_torch.parallel import dist as pdist  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
ROUTES = ("onepass", "split", "fused", "host")
WORKER_TIMEOUT_S = 240


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _skewed(n: int = 50_000) -> bytes:
    """Zipf-like bytes (m > 3: the unpacked one-pass rows)."""
    p = 1.0 / np.arange(1, 257) ** 1.3
    rng = np.random.default_rng(7)
    return rng.choice(256, n, p=p / p.sum()).astype(np.uint8).tobytes()


def _cases():
    """name -> (data, block_bytes, chunk_bytes, decode routes) of the round
    trips every world runs."""
    midsummer = (DATA / "a_midsummer_nights_dream.txt").read_bytes()
    rng = np.random.default_rng(3)
    return {
        "midsummer": (midsummer, 4096, 512, ROUTES),
        "skewed": (_skewed(), 1024, 512, ("onepass", "fused", "host")),
        "hello": (b"hello hello hello", 1024, 512, ("onepass", "host")),  # 1 block
        "random": (rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(), 16384, 256,
                   ("onepass", "host")),
    }


def _truncated() -> bytes:
    et = port_compress_host((DATA / "nice.shakespeare.txt").read_bytes() * 8)
    hdr = parse_header(et)
    return et[: hdr.body_start + (len(et) - hdr.body_start) // 2]


# --- the worker: one rank of a gloo group, no JAX ---

def _worker(world: int, rank: int, port: int, out: str) -> None:
    multihost.init(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                   world_size=world, rank=rank)
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world) == (rank, world), mesh
    res = {}
    for name, (data, block, chunk, routes) in _cases().items():
        et = compress_sharded(data, mesh, block_bytes=block)
        res[name] = {"et": _sha(et), "encode": dict(pdist.last_encode_stats), "routes": {}}
        for route in routes:
            ok = decompress_sharded(et, mesh, chunk_bytes=chunk, expand=route) == data
            res[name]["routes"][route] = {"ok": ok, "stats": dict(pdist.last_decode_stats)}
    midsummer = _cases()["midsummer"][0]
    with trace.record_stages() as rec:
        ok = decompress_sharded(port_compress_host(midsummer), mesh) == midsummer
    res["exchanges"] = {"ok": ok, "stages": sorted(rec), "counts": dict(rec.counts),
                        **pdist.last_decode_stats}
    fetch = midsummer * 10
    res["fetch"] = {"et": _sha(compress_sharded(fetch, mesh, block_bytes=4096)),
                    "size": len(fetch), **pdist.last_encode_stats}
    macbeth = (DATA / "nice.shakespeare.txt").read_bytes()
    res["host_stream"] = all(
        decompress_sharded(port_compress_host(macbeth), mesh, chunk_bytes=16,
                           expand=r) == macbeth
        for r in ("onepass", "host"))
    try:
        decompress_sharded(_truncated(), mesh)
        res["truncated"] = None
    except ValueError as e:
        res["truncated"] = str(e)
    safe = pdist._INT32_SAFE_BODY
    pdist._INT32_SAFE_BODY = 1024
    try:
        res["big_body"] = decompress_sharded(port_compress_host(midsummer), mesh) == midsummer
    finally:
        pdist._INT32_SAFE_BODY = safe
    et = multihost.compress(midsummer, device="cpu", block_bytes=8192)
    res["multihost"] = {"et": _sha(et),
                        "ok": multihost.decompress(et, device="cpu") == midsummer}
    res["jax_modules"] = sorted(n for n in sys.modules
                                if n.split(".")[0] in ("jax", "entreepy_tpu"))
    Path(out).write_text(json.dumps(res))
    torch.distributed.destroy_process_group()


# --- the parent: JAX references and the spawned worlds ---

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh8():
    import jax

    from entreepy_tpu.parallel import make_mesh as jax_make_mesh

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def jax_refs(mesh8):
    """Each compressed case's .et digest from the JAX package's sharded
    codec (8-device mesh, same block size), which must equal its host
    codec's, and the JAX error on the truncated stream."""
    from entreepy_tpu.format import compress_host
    from entreepy_tpu.parallel import compress_sharded, decompress_sharded

    inputs = {name: (data, block) for name, (data, block, _, _) in _cases().items()}
    midsummer = inputs["midsummer"][0]
    inputs.update(fetch=(midsummer * 10, 4096), multihost=(midsummer, 8192))
    refs = {}
    for name, (data, block) in inputs.items():
        et = compress_sharded(data, mesh8, block_bytes=block)
        assert et == compress_host(data)
        refs[name] = _sha(et)
    with pytest.raises(ValueError) as e:
        decompress_sharded(_truncated(), mesh8, device_expand=True)
    refs["truncated"] = str(e.value)
    return refs


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    """(world, per-rank results) of one gloo world run in processes of its own."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"world{n}")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, __file__, str(n), str(r), str(port),
                               str(tmp / f"rank{r}.json")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append((p.returncode, err.decode()[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, err) in enumerate(outs):
        assert rc == 0, f"rank {r} of {n} failed (rc={rc}):\n{err}"
    return n, [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(n)]


def _leading_words(msg: str) -> str:
    return msg.split(":")[0]


@pytest.mark.parametrize("case", ["midsummer", "skewed", "hello", "random", "fetch", "multihost"])
def test_ranks_compress_matches_jax(case, world, jax_refs):
    _, ranks = world
    assert [r[case]["et"] for r in ranks] == [jax_refs[case]] * len(ranks)


@pytest.mark.parametrize("case,route", [(c, r) for c, (_, _, _, routes) in _cases().items()
                                        for r in routes])
def test_ranks_round_trip(case, route, world):
    """Every rank gets the input back, and every rank ran the same number
    of fixed-point passes."""
    _, ranks = world
    got = [r[case]["routes"][route] for r in ranks]
    assert all(g["ok"] for g in got)
    passes = {g["stats"]["passes"] for g in got}
    assert len(passes) == 1 and 1 <= passes.pop() <= 24, got


def test_ranks_host_route_fetches_own_states(world):
    """The host route: each rank fetches at most 1/world of the states and
    expands only its own symbols (the JAX package's 1/N multi-host fetch)."""
    n, ranks = world
    for name in ("midsummer", "random"):
        stats = [r[name]["routes"]["host"]["stats"] for r in ranks]
        for st in stats:
            assert st["fetched_states_bytes"] <= st["total_states_bytes"] / n, st
        assert sum(st["local_symbols"] for st in stats) >= stats[0]["n_symbols"]


def test_ranks_encode_fetch_tracks_compressed_size(world):
    n, ranks = world
    for r in ranks:
        st = r["fetch"]
        compressed = (st["payload_bits"] + 7) // 8
        assert st["fetched_bytes"] <= 1.1 * compressed + n * 4096 + 65536, st
        assert st["fetched_bytes"] < st["size"]
        assert st["dense_bytes"] > 4 * st["fetched_bytes"]


def test_ranks_truncated_same_error(world, jax_refs):
    """A truncated stream raises on every rank (none hangs: the spawn has a
    timeout), with the JAX package's message."""
    _, ranks = world
    msgs = [r["truncated"] for r in ranks]
    assert None not in msgs and len(set(msgs)) == 1
    assert _leading_words(msgs[0]) == _leading_words(jax_refs["truncated"])


def test_ranks_other_paths(world):
    """A host codec stream at 16-byte chunks, the big-body escape, and the
    multihost entry points round-trip on every rank."""
    _, ranks = world
    for r in ranks:
        assert r["host_stream"] and r["big_body"] and r["multihost"]["ok"]


def test_ranks_count_their_exchanges(world):
    """A group's rank times its collectives (``mesh_wait``) and the copies
    back (``mesh_copy``), and counts each exchange and the other ranks'
    bytes it took: one all-gather of int32 exit states per pass and the
    suffix sync, then the int64 lane metadata and the symbols."""
    n, ranks = world
    ex = [r["exchanges"] for r in ranks]
    every_symbol = sum(e["local_symbols"] for e in ex)
    for e in ex:
        assert e["ok"] and {"mesh_wait", "mesh_copy"} <= set(e["stages"])
        exits = e["passes"] + 1
        assert e["counts"]["mesh_exchanges"] == exits + 2
        others = (n - 1) * (exits * 4 * e["lanes"] + 16 * e["lanes"])
        assert e["counts"]["p2p_bytes"] == others + every_symbol - e["local_symbols"]


def test_ranks_import_no_jax(world):
    _, ranks = world
    assert all(r["jax_modules"] == [] for r in ranks)


# --- world 1, in this process ---

@pytest.fixture(scope="module")
def one():
    return make_mesh(device="cpu")


def test_make_mesh_without_group(one):
    assert (one.group, one.rank, one.world, one.device) == (None, 0, 1, torch.device("cpu"))


def test_make_mesh_needs_cuda(monkeypatch):
    from entreepy_tpu_torch.api import NoCudaDeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="backend='sharded' needs a CUDA device"):
        make_mesh()


def test_compress_matches_jax(one, midsummer, mesh8):
    from entreepy_tpu.format import compress_host
    from entreepy_tpu.parallel import compress_sharded as jax_compress_sharded

    et = compress_sharded(midsummer, one, block_bytes=4096)
    assert et == jax_compress_sharded(midsummer, mesh8, block_bytes=4096) == compress_host(midsummer)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("corpus", ["midsummer", "skewed"])
def test_round_trip(route, corpus, one, request):
    from entreepy_tpu.format import compress_host

    data = request.getfixturevalue("midsummer") if corpus == "midsummer" else _skewed()
    et = compress_sharded(data, one, block_bytes=8192)
    assert et == compress_host(data)
    assert decompress_sharded(et, one, expand=route) == data
    assert pdist.last_decode_stats["passes"] >= 1


def test_host_stream_small_chunks(one, macbeth):
    from entreepy_tpu.format import compress_host

    assert decompress_sharded(compress_host(macbeth), one, chunk_bytes=16) == macbeth


def test_fewer_blocks_than_ranks(one):
    from entreepy_tpu.format import compress_host

    data = b"hello hello hello"
    et = compress_sharded(data, one, block_bytes=1024)  # one block
    assert et == compress_host(data)
    assert decompress_sharded(et, one) == data


def test_random(one):
    from entreepy_tpu.format import compress_host

    data = np.random.default_rng(3).integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    et = compress_sharded(data, one, block_bytes=16384)
    assert et == compress_host(data)
    assert decompress_sharded(et, one, chunk_bytes=256) == data


def test_encode_fetch_tracks_compressed_size(one, midsummer):
    from entreepy_tpu.format import compress_host

    data = midsummer * 10
    assert compress_sharded(data, one, block_bytes=4096) == compress_host(data)
    st = pdist.last_encode_stats
    compressed = (st["payload_bits"] + 7) // 8
    assert st["fetched_bytes"] <= 1.1 * compressed + 4096 + 65536, st
    assert st["fetched_bytes"] < len(data)
    assert st["dense_bytes"] > 4 * st["fetched_bytes"]


@pytest.mark.parametrize("route", ROUTES)
def test_truncated_same_error_as_jax(route, one, jax_refs):
    with pytest.raises(ValueError) as e:
        decompress_sharded(_truncated(), one, expand=route)
    assert _leading_words(str(e.value)) == _leading_words(jax_refs["truncated"])


def test_big_body_routes_to_tiled(monkeypatch, one, midsummer):
    """A rank slice at or past _INT32_SAFE_BODY decodes through the
    tile-local streaming decode; threshold shrunk to run at test scale."""
    from entreepy_tpu.format import compress_host
    from entreepy_tpu_torch.ops import decode8

    calls = []
    real = decode8.decode_body_device_tiled
    monkeypatch.setattr(decode8, "decode_body_device_tiled",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(pdist, "_INT32_SAFE_BODY", 1024)
    assert decompress_sharded(compress_host(midsummer), one) == midsummer
    assert calls == [1]


def test_unconverged_uses_host_decoder(monkeypatch, one, midsummer):
    from entreepy_tpu.format import compress_host
    from entreepy_tpu_torch.ops import decode8

    real = decode8.fsm8_decode_fused
    monkeypatch.setattr(decode8, "fsm8_decode_fused",
                        lambda *a, **k: (*real(*a, **k)[:2], True))
    before = decode8.decode_host.calls
    data = midsummer[:20000]
    assert decompress_sharded(compress_host(data), one) == data
    assert decode8.decode_host.calls == before + 1


def test_multihost_single_process(midsummer, monkeypatch):
    """No arguments and no torchrun variables: a single process, no group,
    and the entry points run as one rank."""
    from entreepy_tpu.format import compress_host

    for var in multihost.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    multihost.init()
    assert not torch.distributed.is_initialized()
    et = multihost.compress(midsummer, device="cpu", block_bytes=8192)
    assert et == compress_host(midsummer)
    assert multihost.decompress(et, device="cpu") == midsummer


def test_multihost_init_propagates_explicit_errors():
    with pytest.raises((ValueError, RuntimeError)):
        multihost.init(backend="gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                       world_size=-3, rank=0)
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    _worker(*map(int, sys.argv[1:4]), sys.argv[4])
