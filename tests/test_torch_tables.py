"""The port's device tables and constants against the JAX package's."""

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

from entreepy_tpu_torch import tables  # noqa: E402
from entreepy_tpu_torch.ops import bitpack, decode8, encode  # noqa: E402


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
