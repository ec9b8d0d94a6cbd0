"""The port's block pack (plain version, CPU) against ``pack_blocks_scan`` and
``pack_blocks_pallas`` in interpret mode, and its bincount histogram against
``histogram_device``: exact equality, dense words compared where emitted."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from entreepy_tpu.format import build_code_table, histogram  # noqa: E402
from entreepy_tpu.ops.bitpack import (  # noqa: E402
    HIST_COLS, code_table_cols, histogram_device, pack_blocks_scan,
)
from entreepy_tpu.ops.pallas_pack import pack_blocks_pallas  # noqa: E402

from entreepy_tpu_torch.ops import bitpack, cuda_pack  # noqa: E402
from entreepy_tpu_torch.tables import code_tensors  # noqa: E402


def _fib_table():
    """32 symbols with Fibonacci counts: a 31-bit-deep code, so the
    accumulator crosses the 32-bit boundary with long codes."""
    counts = np.zeros(256, np.int64)
    a, b = 1, 1
    for sym in range(32):
        counts[sym] = a
        a, b = b, a + b
    return build_code_table(counts)


def _zipf_table(rng):
    p = 1.0 / np.arange(1, 257) ** 1.3
    data = rng.choice(256, 50000, p=p / p.sum()).astype(np.uint8)
    return build_code_table(histogram(data))


@pytest.mark.parametrize("kind", ["text", "zipf", "fib"])
def test_pack_blocks_matches_jax(kind, midsummer):
    rng = np.random.default_rng(5)
    lanes, steps = 16, 128
    if kind == "text":
        table = build_code_table(histogram(np.frombuffer(midsummer, np.uint8)))
        blocks = np.frombuffer(midsummer[: lanes * steps], np.uint8).reshape(lanes, steps)
    else:
        table = _fib_table() if kind == "fib" else _zipf_table(rng)
        present = np.flatnonzero(table.lengths)
        blocks = rng.choice(present, (lanes, steps)).astype(np.uint8)
    valid = rng.integers(0, steps + 1, lanes).astype(np.int32)
    valid[:3] = [0, steps, 1]  # empty, full and one-byte blocks
    blocks = np.where(np.arange(steps)[None, :] < valid[:, None], blocks, 0).astype(np.uint8)

    codetbl = jnp.asarray(code_table_cols(table.codes, table.lengths), jnp.bfloat16)
    want_scan = pack_blocks_scan(jnp.asarray(blocks), jnp.asarray(valid), codetbl)
    want_pallas = pack_blocks_pallas(jnp.asarray(blocks), jnp.asarray(valid), codetbl,
                                     interpret=True)
    codes, lengths = code_tensors(table, "cpu")
    words, emitted, acc, nbits = cuda_pack.pack_blocks(
        torch.from_numpy(blocks), torch.from_numpy(valid), codes, lengths
    )
    assert (words.dtype, emitted.dtype, acc.dtype, nbits.dtype) == (
        torch.uint32, torch.bool, torch.uint32, torch.int32)
    assert emitted.numpy().any()
    for want in (want_scan, want_pallas):
        w_words, w_emitted, w_acc, w_nbits = (np.asarray(x) for x in want)
        assert np.array_equal(emitted.numpy(), w_emitted)
        assert np.array_equal(np.where(w_emitted, words.numpy(), 0),
                              np.where(w_emitted, w_words, 0))
        assert np.array_equal(acc.numpy(), w_acc)
        assert np.array_equal(nbits.numpy(), w_nbits)


@pytest.mark.parametrize("size", [0, 1, 4095, 20000])
def test_histogram_matches_jax(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8)
    padded = np.zeros(max(HIST_COLS, -(-size // HIST_COLS) * HIST_COLS), np.uint8)
    padded[:size] = data
    want = histogram_device(jnp.asarray(padded), jnp.int32(size))
    got = bitpack.histogram_device(torch.from_numpy(data))
    assert np.array_equal(got.numpy(), np.asarray(want))
