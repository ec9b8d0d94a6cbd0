"""The encode's stitch on the device (``ops/cuda_stitch``), through its plain
PyTorch version on the CPU: the tile's big-endian bytes against the host
stitch (``utils/stitch.py``) over random plane layouts at every base shift,
the tiled device encode against the JAX package and the host codec, and
which paths still stitch on the host."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import entreepy_tpu  # noqa: E402
from entreepy_tpu.format import compress_host as jax_compress_host  # noqa: E402

import entreepy_tpu_torch  # noqa: E402
from entreepy_tpu_torch import trace  # noqa: E402
from entreepy_tpu_torch.format import compress_host  # noqa: E402
from entreepy_tpu_torch.ops import bitpack, cuda_stitch, encode  # noqa: E402
from entreepy_tpu_torch.utils import stitch as host_stitch  # noqa: E402

M32 = 0xFFFFFFFF


def _layout(kind: str, seed: int, lanes: int = 37, groups: int = 3, cap: int = 16):
    """A compaction's plane int32[groups*cap, lanes] with its counts
    int32[groups, lanes], and each block's partial word uint32[lanes] (bits
    past nbits set, which the stitch must ignore) with nbits int32[lanes]:
    ``random`` fills; ``one_word`` blocks of one word (one live word, or a
    partial word alone); ``full`` every subgroup full; ``partial_byte`` a
    stream that ends inside a byte."""
    rng = np.random.default_rng(seed)
    plane = rng.integers(-(2**31), 2**31, (groups * cap, lanes)).astype(np.int32)
    counts = rng.integers(0, cap + 1, (groups, lanes)).astype(np.int32)
    nbits = rng.integers(0, 32, lanes).astype(np.int32)
    if kind == "one_word":
        counts[:] = 0
        words = rng.random(lanes) < 0.5
        counts[rng.integers(0, groups, lanes)[words], np.flatnonzero(words)] = 1
        nbits[words] = 0
        nbits[~words] = rng.integers(1, 32, int((~words).sum()))
    elif kind == "full":
        counts[:] = cap
    elif kind == "partial_byte":
        nbits[-1] = 8 * rng.integers(0, 4) + rng.integers(1, 8)
        nbits[:-1] = 8 * (nbits[:-1] // 8)
    acc = rng.integers(0, 2**32, lanes, dtype=np.uint32)
    return plane, counts, acc, nbits


def _host_bytes(plane, counts, acc, nbits, shift: int, carry: int) -> bytes:
    """The same stream through the host path: the plane sliced on the host
    (``assemble_plane_payload``), stitched by ``stitch_flat_payload`` behind
    a first block of ``shift`` bits holding ``carry``, and
    ``words_to_bytes``."""
    groups, lanes = counts.shape
    cap = plane.shape[0] // groups
    lane_major = plane.reshape(groups, cap, lanes).transpose(2, 0, 1).reshape(lanes, -1)
    tail = np.where(nbits > 0, acc & (M32 << (32 - nbits.astype(np.int64))) & M32, 0)
    flat, nwords = bitpack.assemble_plane_payload(
        np.concatenate([lane_major.view(np.uint32), tail.astype(np.uint32)[:, None]], axis=1),
        counts.T)
    bit_lens = counts.sum(0).astype(np.int64) * 32 + nbits
    words, total = host_stitch.stitch_flat_payload(
        np.concatenate([[np.uint32(carry)], flat]).astype(np.uint32),
        np.concatenate([[1], nwords]), np.concatenate([[shift], bit_lens]))
    return host_stitch.words_to_bytes(words, total)


def _check(kind: str, shift: int, seed: int):
    plane, counts, acc, nbits = _layout(kind, seed)
    rng = np.random.default_rng(seed + 1)
    carry = int(rng.integers(1, 2**32)) & ~(M32 >> shift) & M32 if shift else 0
    bits = int(counts.sum()) * 32 + int(nbits.sum())
    n_words = (shift + bits + 31) >> 5
    got = cuda_stitch.stitch_tile(
        torch.from_numpy(plane), torch.from_numpy(counts), torch.from_numpy(acc),
        torch.from_numpy(nbits), shift, n_words,
        torch.tensor(list(carry.to_bytes(4, "big")), dtype=torch.uint8) if shift else None)
    want = _host_bytes(plane, counts, acc, nbits, shift, carry)
    assert got.dtype == torch.uint8 and got.numel() == 4 * n_words
    out = got.numpy().tobytes()
    assert out[: len(want)] == want
    assert not any(out[len(want):])
    return bits


@pytest.mark.parametrize("shift", range(32))
def test_stitch_matches_the_host_stitch_at_every_shift(shift):
    _check("random", shift, 100 + shift)


@pytest.mark.parametrize("shift", [0, 5, 31])
@pytest.mark.parametrize("kind", ["one_word", "full", "partial_byte"])
def test_stitch_matches_the_host_stitch_on_edge_layouts(kind, shift):
    bits = _check(kind, shift, 7 * shift + len(kind))
    if kind == "partial_byte":
        assert (shift + bits) % 8


def test_stitch_rejects_bad_operands():
    plane, counts, acc, nbits = (torch.from_numpy(a) for a in _layout("random", 1))
    with pytest.raises(ValueError, match="stitch_tile"):
        cuda_stitch.stitch_tile(plane, counts[:, :-1], acc, nbits, 0, 10)
    with pytest.raises(ValueError, match="stitch_tile"):
        cuda_stitch.stitch_tile(plane, counts, acc, nbits, 32, 10)
    with pytest.raises(ValueError, match="stitch_tile"):
        cuda_stitch.stitch_tile(plane[:-1], counts, acc, nbits, 0, 10)


@pytest.fixture(scope="module")
def midsummer_et(midsummer):
    et = compress_host(midsummer)
    assert et == jax_compress_host(midsummer) == entreepy_tpu.compress(midsummer,
                                                                        backend="device")
    return et


@pytest.mark.parametrize("tiles", [2, 3, 5, 7])
def test_tiled_device_compress_matches_jax_and_host(tiles, monkeypatch, midsummer,
                                                    midsummer_et):
    """The public API's device encode at 2, 3 and an odd number of tiles:
    the same .et as the host codec and the JAX package, and one stitch on
    the device per tile; some tile starts inside a word."""
    n_blocks = -(-len(midsummer) // encode.DEFAULT_BLOCK_BYTES)
    monkeypatch.setattr(encode, "TILE_BLOCKS", -(-n_blocks // tiles))
    bits, real = [], encode.encode_blocks_device

    def spy(*args):
        out = real(*args)
        bits.append(out[1])
        return out

    monkeypatch.setattr(encode, "encode_blocks_device", spy)
    with trace.record_stages() as rec:
        got = entreepy_tpu_torch.compress(midsummer, backend="device", device="cpu")
    assert got == midsummer_et
    assert len(bits) == rec.counts["device_stitches"] == tiles
    assert any(int(at) % 32 for at in np.cumsum(bits)[:-1])


def _spies(monkeypatch, fn) -> list:
    """Every binding of ``fn`` in the port's modules replaced by a spy;
    returns the list its calls append to."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] == "entreepy_tpu_torch" and mod is not None:
            for attr, value in list(vars(mod).items()):
                if value is fn:
                    monkeypatch.setattr(mod, attr, spy)
    return calls


def test_only_the_sharded_encode_stitches_on_the_host(monkeypatch, midsummer, midsummer_et):
    """The single-device encode neither slices the plane nor stitches on
    the host; the sharded encode still stitches there."""
    from entreepy_tpu_torch.parallel import dist  # noqa: F401  (its bindings spied too)

    assembled = _spies(monkeypatch, bitpack.assemble_plane_payload)
    stitched = _spies(monkeypatch, host_stitch.stitch_flat_payload)
    assert entreepy_tpu_torch.compress(midsummer, backend="device", device="cpu") == midsummer_et
    assert assembled == [] and stitched == []
    assert entreepy_tpu_torch.compress(midsummer, backend="sharded",
                                       device="cpu") == midsummer_et
    assert stitched and assembled == []


def test_device_stitches_count_one_per_tile(midsummer):
    """One tile below TILE_BLOCKS blocks, one stitch; nothing outside a
    record."""
    with trace.record_stages() as rec:
        encode.compress_device(midsummer[:5000], device="cpu")
    assert rec.counts["device_stitches"] == 1
    assert "host_assemble" not in rec and "stitch" not in rec
