"""Sharded compress and decompress over the ranks of a process group.

Counterpart of ``entreepy_tpu/parallel/dist.py``: the JAX package's 1-D mesh
(``shard_map`` over one axis) is the ranks of a ``torch.distributed`` group
(:class:`~.mesh.Mesh`), one device per rank; ``psum`` is :func:`_all_reduce`
and ``all_gather``/``process_allgather`` are :func:`_all_gather`, in rank
order. Every rank passes the same input and gets the same output (SPMD).

Encode (:func:`compress_sharded`): the input's blocks are dealt round-robin
over the ranks (rank r's lane j holds block ``j * world + r``), so every
rank's share of real bytes is about equal. Each rank takes the histogram of
its blocks on its device; one all-reduce makes it global, and every rank
builds the same code table. Each rank packs its blocks (the pack kernel)
and compacts the words into one flat stream on its device
(``bitpack.compact_payload_flat``); the flat streams, word counts and bit
lengths are gathered and every rank stitches them back in block order.

Decode (:func:`decompress_sharded`): the body's chunks (lanes) are padded to
a multiple of the world, and rank r owns lanes ``[r*L, (r+1)*L)``. The
suffix sync pass and the fixed-point passes run on each rank's lanes, with
one all-gather of the exit states per pass, so the entry chain spans every
lane (``decode8._fixed_point``'s ``gather``). Then each rank expands and
compacts its own lanes by the ``expand`` route, as ``decompress_device``
does on one device, extracts its symbols on the host, and the per-lane
metadata and the symbols are gathered in rank order. The routes are the
single-device ones; the JAX package's ``ENTREEPY_SHARDED_DEVICE_EXPAND``,
``ENTREEPY_EXPAND`` and ``ENTREEPY_FUSED_PACKED`` become the ``expand``
argument and the one-pass rule m <= 3.

No rank raises before a collective that the others enter: a local fault
(a compaction overflow poisons ``lane_tot`` to -1, a chunk's first invalid
byte is its ``w_inv``) travels as gathered data, and the checks that raise
run on the gathered values, on every rank alike.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..format.etformat import parse_header, serialize_header
from ..format.fsm8 import ByteFsm, build_byte_fsm
from ..format.hostcodec import _check_stream_bits
from ..format.huffman import build_code_table
from ..ops import decode8
from ..ops.bitpack import (
    compact_payload_flat,
    grouped_counts_plane,
    histogram_device,
    plane_cap_g,
)
from ..ops.cuda_pack import pack_blocks
from ..ops.encode import DEFAULT_BLOCK_BYTES, upload
from ..tables import code_tensors, decode_tables, expand_tables, next_state_tensor
from ..trace import phase
from ..utils.stitch import split_blocks, stitch_flat_payload, words_to_bytes
from .mesh import Mesh, make_mesh

# A rank's decode masks real bytes by lane-linear int32 positions within its
# slice; a slice at or past this would wrap, so every rank then decodes the
# whole body through the tile-local streaming decode instead.
_INT32_SAFE_BODY = 1 << 31

# Diagnostics of the last call on this rank (the tests hold the encode's
# fetch to the compressed size and the host route's state fetch to 1/world).
last_encode_stats: dict = {}
last_decode_stats: dict = {}


# --- collectives: the only calls into torch.distributed ---

def _comm_device(mesh: Mesh) -> torch.device:
    """The device the group's collectives take tensors on: the mesh's device
    where the group runs NCCL for its type, else the host (gloo's
    all_gather takes CPU tensors only, so a gloo group with CUDA tensors
    copies through the host; the kernels still run on the card)."""
    config = dict(item.split(":") for item in dist.get_backend_config(mesh.group).split(","))
    return mesh.device if config.get(mesh.device.type) == "nccl" else torch.device("cpu")


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks, in place; at one rank ``t`` as it is."""
    if mesh.group is None or mesh.world == 1:
        return t
    comm = _comm_device(mesh)
    buf = t.to(comm)
    dist.all_reduce(buf, group=mesh.group)
    return t if buf is t else t.copy_(buf)


def _all_gather(t: torch.Tensor, mesh: Mesh, *, ragged: bool = False) -> list[torch.Tensor]:
    """Every rank's 1-D ``t``, in rank order, on ``t``'s device; at one rank
    ``[t]``. ``ragged``: the lengths differ per rank, so they are gathered
    first and each rank's ``t`` is padded to the largest."""
    if mesh.group is None or mesh.world == 1:
        return [t]
    comm = _comm_device(mesh)
    buf = t.to(comm)
    sizes = [t.numel()] * mesh.world
    if ragged:
        n = torch.tensor([t.numel()], dtype=torch.int64, device=comm)
        got = [torch.empty_like(n) for _ in range(mesh.world)]
        dist.all_gather(got, n, group=mesh.group)
        sizes = [int(g) for g in got]
        buf = torch.cat([buf, buf.new_zeros(max(*sizes, 1) - t.numel())])
    parts = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(parts, buf, group=mesh.group)
    return [p[:n].to(t.device) for p, n in zip(parts, sizes)]


# --- encode ---

def compress_sharded(data: bytes, mesh: Mesh | None = None, *, strict: bool = True,
                     block_bytes: int = DEFAULT_BLOCK_BYTES) -> bytes:
    """bytes -> complete .et file, block-parallel over the mesh's ranks;
    byte-identical to the single-device and host codecs. Every rank passes
    the same ``data`` and gets the same file."""
    mesh = mesh or make_mesh()
    world, dev = mesh.world, mesh.device
    arr = np.frombuffer(data, dtype=np.uint8)
    blocks, valid = split_blocks(arr, block_bytes)
    n_pad = -(-blocks.shape[0] // world) * world  # empty blocks even out the ranks
    blocks = np.concatenate([blocks, np.zeros((n_pad - blocks.shape[0], block_bytes), np.uint8)])
    valid = np.concatenate([valid, np.zeros(n_pad - valid.size, np.int32)])
    lanes = n_pad // world
    with phase("input_upload", lanes * block_bytes):
        mine = upload(np.ascontiguousarray(blocks[mesh.rank::world]), dev)
        my_valid = valid[mesh.rank::world]
    with phase("device_histogram", mine.numel()):
        hist = histogram_device(mine.reshape(-1))
        hist[0] -= mine.numel() - int(my_valid.sum())  # the blocks' zero padding
        counts = _all_reduce(hist, mesh).cpu().numpy()
    with phase("code_table"):
        table = build_code_table(counts, strict=strict)
    with phase("device_pack", mine.numel()):
        codes, lengths = code_tensors(table, dev)
        words, emitted, acc, nbits = pack_blocks(mine, torch.from_numpy(my_valid).to(dev),
                                                 codes, lengths)
    with phase("sizing_fetch"):
        cap_g = plane_cap_g(int(grouped_counts_plane(emitted).max()), block_bytes)
    with phase("device_compact"):
        flat, nwords, bit_lens = compact_payload_flat(words, emitted, acc, nbits, cap_g)
    with phase("gather_payload"):
        flats = [f.cpu().numpy().view(np.uint32)
                 for f in _all_gather(flat.view(torch.int32), mesh, ragged=True)]
        nw = torch.stack(_all_gather(nwords, mesh)).cpu().numpy().astype(np.int64)
        bl = torch.stack(_all_gather(bit_lens, mesh)).cpu().numpy().astype(np.int64)
    sizes = np.array([f.size for f in flats], dtype=np.int64)
    last_encode_stats.clear()
    last_encode_stats.update(
        fetched_bytes=int(sizes.sum()) * 4 + nw.size * 4 + bl.size * 4,
        dense_bytes=world * (words.numel() * 4 + emitted.numel()),
        payload_bits=int(bl.sum()),
    )
    with phase("stitch"):
        # nw/bl are [rank, lane]: rank r's words start where the ranks before
        # it end, its lanes back to back; block j*world + r is entry [r, j],
        # so the transpose puts them in block order
        offs = (np.cumsum(sizes) - sizes)[:, None] + np.cumsum(nw, axis=1) - nw
        words_out, total_bits = stitch_flat_payload(
            np.concatenate(flats), nw.T.reshape(-1), bl.T.reshape(-1), offs=offs.T.reshape(-1))
    with phase("serialize"):
        return serialize_header(table, arr.size) + words_to_bytes(words_out, total_bits)


# --- decode ---

class _ExitGather:
    """``decode8._fixed_point``'s ``gather`` over the mesh: one all-gather of
    the exit states per call (the suffix sync's, then one per pass)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.calls = 0

    def __call__(self, exits: torch.Tensor):
        self.calls += 1
        with phase("allgather_exits"):
            return torch.cat(_all_gather(exits, self.mesh)), self.mesh.rank * exits.numel()


def _plane_symbols(plane):
    """A compacted plane's fetch and host extraction -> (lane_tot, w_inv with
    -1 for none, this rank's symbols)."""
    syms, lane_tot, w_inv = decode8.fetch_symbols(plane)
    w_inv = w_inv.astype(np.int64)
    w_inv[w_inv >= decode8.NO_INVALID] = -1
    return lane_tot.astype(np.int64), w_inv, syms


def _expand_chunks(states: np.ndarray, body: np.ndarray, fsm: ByteFsm, chunk_bytes: int,
                   lanes: int):
    """This rank's (state, byte) pairs -> (symbols per lane int64[lanes], w_inv
    int64[lanes]: symbols before the lane's first invalid byte, -1 if none,
    the lanes' symbols in stream order): the C++ runtime's walk, else numpy.
    Validation is the caller's, on the gathered values."""
    per_lane = np.zeros(lanes, dtype=np.int64)
    w_inv = np.full(lanes, -1, dtype=np.int64)
    n = states.size
    if n == 0:  # every lane of this rank is padding
        return per_lane, w_inv, np.zeros(0, dtype=np.uint8)
    m = max(1, int(fsm.counts.max(initial=1)))
    native = runtime.fsm8_expand_chunks(states, body, fsm.counts, fsm.syms, chunk_bytes, m)
    if native is not None:
        rows, pc, wi = native
        per_lane[: pc.size] = pc
        w_inv[: wi.size] = wi
        # one slice per chunk: a mask over the rows would read every slot
        return per_lane, w_inv, np.concatenate([rows[c, :k] for c, k in enumerate(pc)])
    cnt = np.zeros(lanes * chunk_bytes, dtype=np.int64)
    cnt[:n] = fsm.counts[states, body]  # padding bytes past the stream emit nothing
    valid_cnt = np.maximum(cnt, 0)
    per_lane = valid_cnt.reshape(lanes, chunk_bytes).sum(axis=1)
    inv = np.flatnonzero(cnt < 0)
    if inv.size:
        lanes_inv, first = np.unique(inv // chunk_bytes, return_index=True)
        for c, j in zip(lanes_inv, inv[first]):
            w_inv[c] = int(valid_cnt[c * chunk_bytes : j].sum())
    sy = fsm.syms[states, body]  # [n, 8]
    live = np.arange(8, dtype=np.int64)[None, :] < cnt[:n, None]
    return per_lane, w_inv, sy[live]


def _assemble(mesh: Mesh, lane_tot, w_inv, syms, n_symbols: int, table, n_body: int):
    """Every rank's (lane_tot, w_inv) and symbols gathered in rank order: the
    serial-exact accept/reject over every lane, the symbols joined and
    trimmed to ``n_symbols``, the exact-bit check."""
    with phase("host_validate"):
        meta = torch.from_numpy(np.concatenate([lane_tot, w_inv]))
        parts = [p.reshape(2, -1) for p in _all_gather(meta, mesh)]
        g = torch.cat(parts, dim=1).numpy()
        decode8.validate_chunk_meta(g[0], g[1], n_symbols)
    with phase("gather_symbols"):
        out = torch.cat(_all_gather(torch.from_numpy(syms), mesh, ragged=True)).numpy()
    out = out[:n_symbols]
    if out.size < n_symbols:
        raise ValueError(f"bitstream ended early: decoded {out.size} of {n_symbols} symbols")
    with phase("host_check_bits"):
        _check_stream_bits(out, table.lengths, n_body)
    return out


def decompress_sharded(et: bytes, mesh: Mesh | None = None, *,
                       chunk_bytes: int = decode8.DEFAULT_CHUNK_BYTES,
                       expand: str = "onepass") -> bytes:
    """Complete .et file -> original bytes, chunk-parallel over the mesh's
    ranks through the ``expand`` route (``decode8.EXPAND_MODES``: "onepass",
    the two-pass "split" and "fused", or "host": each rank fetches only its
    own lanes' states, 1/world of the body, and expands them on the host).
    Every rank passes the same file and gets the same bytes."""
    decode8.check_expand(expand)
    mesh = mesh or make_mesh()
    dev = mesh.device
    hdr = parse_header(et)
    table, n = hdr.table, hdr.body_len
    if n == 0:
        return b""
    buf = np.frombuffer(et, dtype=np.uint8)[hdr.body_start:]
    n_real_lanes = max(1, -(-buf.size // chunk_bytes))
    lanes = -(-n_real_lanes // mesh.world)  # this rank's lanes; the rest is padding
    if lanes * chunk_bytes >= _INT32_SAFE_BODY:
        return decode8.decode_body_device_tiled(buf, table, n, device=dev,
                                                chunk_bytes=chunk_bytes).tobytes()
    lo = mesh.rank * lanes * chunk_bytes
    seg = buf[lo : lo + lanes * chunk_bytes]  # rank-local positions: seg.size bytes are real
    fsm = build_byte_fsm(table)
    gather = _ExitGather(mesh)
    last_decode_stats.clear()
    with phase("decode_tables"):
        if expand == "host":
            next_state = next_state_tensor(fsm, dev)
        else:
            tables = (decode_tables(fsm, dev) if expand == "onepass"
                      else expand_tables(fsm, dev, split=expand == "split"))
            next_state = tables.next_state
    cols = decode8._upload_body(seg, lanes, chunk_bytes, dev)
    with phase("device_fsm8_decode", n):
        if expand == "onepass":
            packed = tables.m <= 3
            vals, _, unconverged = decode8.fsm8_decode_fused(
                cols, next_state, tables.fused, n_real_lanes, tables.m, tables.mt, tables.s,
                packed=packed, n_valid=seg.size, gather=gather)
        else:
            xs = cols.t().contiguous()
            states, unconverged = decode8.fsm8_decode(xs, next_state, n_real_lanes, gather)
    last_decode_stats["passes"] = gather.calls - 1
    if unconverged:  # decided on gathered values: every rank takes the serial decoder
        return decode8.decode_host(buf, table, n).tobytes()
    if expand == "host":
        with phase("device_state_fetch", seg.size):
            st = states.t().contiguous().reshape(-1)[: seg.size].cpu().numpy()
        with phase("host_expand", n):
            lane_tot, w_inv, syms = _expand_chunks(st, seg, fsm, chunk_bytes, lanes)
        last_decode_stats.update(
            fetched_states_bytes=st.nbytes,
            total_states_bytes=mesh.world * lanes * chunk_bytes,
            local_symbols=int(syms.size),
            n_symbols=n,
        )
    else:
        with phase("device_expand", n):
            if expand == "onepass":
                plane = decode8.onepass_plane(vals, tables.m, packed, seg.size)
            else:
                plane = decode8._rows_plane(*decode8.run_expand(xs, states, tables, seg.size),
                                            tables.m)
            plane = decode8.lane_major(*plane)
        lane_tot, w_inv, syms = _plane_symbols(plane)
    return _assemble(mesh, lane_tot, w_inv, syms, n, table, buf.size).tobytes()
