"""The port's block pack (plain version, CPU) and the pack kernel's
decomposition (``pack_blocks_scan_plain``) against ``pack_blocks_scan`` and
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


def _pack_inputs(kind, lanes, steps, midsummer):
    """(blocks uint8[lanes, steps] zero past valid, valid, CodeTable): the
    text corpus's bytes or a table's present symbols drawn at random, with
    an empty, a full and a one-byte block first."""
    rng = np.random.default_rng(5)
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
    return blocks, valid, table


def _jax_packs(blocks, valid, table):
    """The JAX package's scan and its Pallas kernel (interpret mode)."""
    codetbl = jnp.asarray(code_table_cols(table.codes, table.lengths), jnp.bfloat16)
    return (pack_blocks_scan(jnp.asarray(blocks), jnp.asarray(valid), codetbl),
            pack_blocks_pallas(jnp.asarray(blocks), jnp.asarray(valid), codetbl,
                               interpret=True))


def _assert_pack_equal(got, want):
    """emitted, acc and nbits exact; words where emitted."""
    words, emitted, acc, nbits = (np.asarray(x) for x in got)
    w_words, w_emitted, w_acc, w_nbits = (np.asarray(x) for x in want)
    assert np.array_equal(emitted, w_emitted)
    assert np.array_equal(np.where(w_emitted, words, 0), np.where(w_emitted, w_words, 0))
    assert np.array_equal(acc, w_acc)
    assert np.array_equal(nbits, w_nbits)


@pytest.mark.parametrize("kind", ["text", "zipf", "fib"])
def test_pack_blocks_matches_jax(kind, midsummer):
    blocks, valid, table = _pack_inputs(kind, 16, 128, midsummer)
    codes, lengths = code_tensors(table, "cpu")
    words, emitted, acc, nbits = cuda_pack.pack_blocks(
        torch.from_numpy(blocks), torch.from_numpy(valid), codes, lengths
    )
    assert (words.dtype, emitted.dtype, acc.dtype, nbits.dtype) == (
        torch.uint32, torch.bool, torch.uint32, torch.int32)
    assert emitted.numpy().any()
    for want in _jax_packs(blocks, valid, table):
        _assert_pack_equal((words, emitted, acc, nbits), want)


@pytest.mark.parametrize("steps", [64, 256, 1024, 100])
@pytest.mark.parametrize("kind", ["text", "zipf", "fib"])
def test_pack_blocks_scan_plain_matches_jax(kind, steps, midsummer):
    """The kernel's decomposition (prefix sums of the live code lengths,
    stream words built with index_add) against the JAX scan, the Pallas
    kernel in interpret mode and the port's serial plain version."""
    blocks, valid, table = _pack_inputs(kind, 16, steps, midsummer)
    codes, lengths = code_tensors(table, "cpu")
    args = (torch.from_numpy(blocks), torch.from_numpy(valid), codes, lengths)
    got = cuda_pack.pack_blocks_scan_plain(*args)
    assert tuple(x.dtype for x in got) == (torch.uint32, torch.bool, torch.uint32, torch.int32)
    assert tuple(got[0].shape) == tuple(got[1].shape) == (16, steps)
    assert got[1].numpy().sum(1).max() >= steps // 8  # several words per block
    for want in (*_jax_packs(blocks, valid, table), cuda_pack.pack_blocks_plain(*args)):
        _assert_pack_equal(got, want)


@pytest.mark.parametrize("size", [0, 1, 4095, 20000])
def test_histogram_matches_jax(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8)
    padded = np.zeros(max(HIST_COLS, -(-size // HIST_COLS) * HIST_COLS), np.uint8)
    padded[:size] = data
    want = histogram_device(jnp.asarray(padded), jnp.int32(size))
    got = bitpack.histogram_device(torch.from_numpy(data))
    assert np.array_equal(got.numpy(), np.asarray(want))
