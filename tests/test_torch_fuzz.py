"""The port's twin of ``tests/test_fuzz.py``, on the CPU (``device="cpu"``:
the kernels' plain versions).

The bench's four corpus families (``bench.corpus.make_corpus``) at random
sizes go through the ``device`` and ``sharded`` backends (one rank, no
process group) on every decode route and must give the JAX package's host
``.et`` bytes and the input back; an overlong stream is rejected by every
backend and route; a relaxed (``strict=False``) single-symbol file, whose
tree is not full, round-trips everywhere; single-bit corruptions are
accepted or rejected as the JAX package's host backend does it (the serial
walk ``format.unpack_body_host`` plus the exact-bit check), never accepted
where the serial walk rejects, and an accepted one decodes to the serial
walk's bytes. Every generator is seeded with a fixed integer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import entreepy_tpu as jet  # noqa: E402
from entreepy_tpu.format import (  # noqa: E402
    build_decode_lut,
    compress_host,
    parse_header,
    unpack_body_host,
)

import entreepy_tpu_torch as et  # noqa: E402
from entreepy_tpu_torch.bench.corpus import KINDS, make_corpus  # noqa: E402
from entreepy_tpu_torch.ops.decode8 import EXPAND_MODES, decompress_device  # noqa: E402
from entreepy_tpu_torch.parallel import decompress_sharded, make_mesh  # noqa: E402

BACKENDS = ("device", "sharded")
SEEDS = {"text": 11, "random": 12, "skewed": 13, "runheavy": 14}
TRIALS = 2
CORRUPTIONS = 4
# every backend and route of the port: the host codec, then each device route
EVERYWHERE = [("host", None)] + [(b, r) for b in BACKENDS for r in EXPAND_MODES]


def _outcome(fn):
    """fn()'s bytes, or None if it raises ValueError (a rejected stream)."""
    try:
        return fn()
    except ValueError:
        return None


def _kwargs(backend: str, route: str | None) -> dict:
    if backend == "host":
        return {"backend": "host"}
    return {"backend": backend, "device": "cpu", "expand": route}


def _fuzz_corpora(kind: str):
    """TRIALS corpora of the family ``kind`` at random sizes."""
    rng = np.random.default_rng(SEEDS[kind])
    return [make_corpus(kind, int(rng.integers(5_000, 30_000))) for _ in range(TRIALS)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", KINDS)
def test_fuzz_compress_agrees(kind, backend):
    for data in _fuzz_corpora(kind):
        assert et.compress(data, backend=backend, device="cpu") == compress_host(data)


@pytest.mark.parametrize("route", EXPAND_MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_fuzz_backends_agree(kind, route):
    for data in _fuzz_corpora(kind):
        ref = compress_host(data)
        for backend in BACKENDS:
            assert et.decompress(ref, **_kwargs(backend, route)) == data


@pytest.mark.parametrize("backend,route", EVERYWHERE)
def test_overlong_stream_rejected_everywhere(backend, route):
    good = compress_host(b"ab" * 500)
    with pytest.raises(ValueError):
        et.decompress(good + b"\x00" * 4, **_kwargs(backend, route))
    assert et.decompress(good, **_kwargs(backend, route)) == b"ab" * 500


@pytest.mark.parametrize("backend,route", EVERYWHERE)
def test_relaxed_single_symbol_all_backends(backend, route):
    """16-byte chunks: the non-full tree's unreachable edges meet the
    self-sync of many lanes."""
    data = b"a" * 1000
    ref = compress_host(data, strict=False)
    kw = _kwargs(backend, route)
    assert et.compress(data, strict=False, **{k: v for k, v in kw.items() if k != "expand"}) == ref
    if backend == "host":
        out = et.decompress(ref, backend="host")
    elif backend == "device":
        out = decompress_device(ref, device="cpu", chunk_bytes=16, expand=route)
    else:
        out = decompress_sharded(ref, make_mesh(device="cpu"), chunk_bytes=16, expand=route)
    assert out == data


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("route", EXPAND_MODES)
@pytest.mark.parametrize("kind", ["skewed", "runheavy"])
def test_fuzz_corruption_consistency(kind, route, backend):
    rng = np.random.default_rng(SEEDS[kind] + 100)
    good = compress_host(make_corpus(kind, 10_000))
    hdr = parse_header(good)
    lut = build_decode_lut(hdr.table)
    for _ in range(CORRUPTIONS):
        pos = int(rng.integers(hdr.body_start + 2, len(good) - 8))
        bad = good[:pos] + bytes([good[pos] ^ (1 << int(rng.integers(8)))]) + good[pos + 1:]
        serial = _outcome(lambda: unpack_body_host(bad[hdr.body_start:], lut,
                                                   hdr.body_len).tobytes())
        host = _outcome(lambda: jet.decompress(bad, backend="host"))
        got = _outcome(lambda: et.decompress(bad, **_kwargs(backend, route)))
        assert got == host
        if serial is None:
            assert got is None, "the serial walk rejected but a port route accepted"
        elif got is not None:
            assert got == serial
