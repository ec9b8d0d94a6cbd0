"""Sharded compress and decompress over the ranks of a mesh.

Counterpart of ``entreepy_tpu/parallel/dist.py``: the JAX package's 1-D mesh
(``shard_map`` over one axis) is a :class:`~.mesh.Mesh`, one device per
rank: the ranks of a ``torch.distributed`` group, or a local mesh of one
process's devices. ``psum`` is :func:`_all_reduce` and
``all_gather``/``process_allgather`` are :func:`_all_gather`, in rank
order. Every rank passes the same input and gets the same output (SPMD).

One rank program serves both kinds; it ends where every rank's part (the
payloads, the symbols) is on the host, and the host tail that turns the
parts into the result runs once per process, in the caller. On a group's
mesh each process runs the rank program once and gathers every rank's part
(:func:`_to_host`). On a local mesh :func:`compress_sharded` and
:func:`decompress_sharded` run it once per rank, each rank in a host thread
of its own, bound to its card (``torch.cuda.set_device``), each fetching
its own part; the two collectives inside it meet at a barrier
(:class:`_Meet`), a CPU tensor exchanged on the host and a CUDA tensor
copied card to card, and the caller joins the parts (:func:`_join`).

Encode (:func:`compress_sharded`): the input's blocks are dealt round-robin
over the ranks (rank r's lane j holds block ``j * world + r``), so every
rank's share of real bytes is about equal. Each rank takes the histogram of
its blocks on its device; one all-reduce makes it global, and every rank
builds the same code table. Each rank packs its blocks (the pack kernel)
and compacts the words into one flat stream on its device
(``bitpack.compact_payload_flat``); the flat streams, word counts and bit
lengths reach the host, and the process stitches them back in block order.

Decode (:func:`decompress_sharded`): the body's chunks (lanes) are padded to
a multiple of the world, and rank r owns lanes ``[r*L, (r+1)*L)``. Each rank
runs the single-device route step of ``ops/decode8.py`` on its lanes
(``route_tables``, ``route_passes``, ``route_symbols``), its fixed point
with one all-gather of the exit states per pass (:class:`_ExitGather`), so
the entry chain spans every lane, and fetches its symbols in stream order;
the process runs ``decode8``'s host tail once over every rank's metadata
and symbols, in rank order. The JAX package's
``ENTREEPY_SHARDED_DEVICE_EXPAND``, ``ENTREEPY_EXPAND`` and
``ENTREEPY_FUSED_PACKED`` become the ``expand`` argument and the one-pass
rule m <= 3.

No rank raises before a collective that the others enter: a local fault
(a compaction overflow poisons ``lane_tot`` to -1, a chunk's first invalid
byte is its ``w_inv``) travels as gathered data, and the checks that raise
run on the gathered values, in the host tail. On a local mesh a rank
that raises all the same aborts the barrier: every other rank stops at its
next exchange instead of waiting, and the caller gets the first rank's
error. ``LOCAL_TIMEOUT_S`` bounds any wait at the barrier.

The exchanges are timed and counted where a record is open
(``trace.record_stages``), on every kind of mesh, at the collectives
(:func:`_all_gather`, :func:`_all_reduce`). Stage ``mesh_wait`` is the time
a rank waits for the others: a local mesh's two barriers of an exchange, a
group's collective calls. Stage ``mesh_copy`` is what the rank then does to
take the others' tensors: on a local mesh their copies onto its device,
``combine`` and the synchronize after it; on a group's mesh the copy back
from the collective's device. A rank alone records both around an empty
exchange (about 0 ms). They nest in the stage that calls the collective:
``allgather_exits`` (one exchange per pass), the encode's
``device_histogram`` (the all-reduce), and on a group's mesh also
``gather_symbols`` / ``gather_payload`` (a local mesh's ranks fetch their
own parts there and exchange nothing). Counts, per rank where something is
exchanged (a mesh of one rank counts none), summed over a local mesh's
ranks for the caller as every count is: ``mesh_exchanges``, one per
exchange, and ``p2p_bytes``, the bytes of the other ranks' tensors the rank
takes in it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime, trace
from ..format.etformat import parse_header, serialize_header
from ..format.fsm8 import ByteFsm, build_byte_fsm
from ..format.huffman import build_code_table
from ..ops import decode8
from ..ops.bitpack import (
    compact_payload_flat,
    grouped_counts_plane,
    histogram_device,
    plane_cap_g,
)
from ..ops.cuda_pack import pack_blocks
from ..ops.encode import DEFAULT_BLOCK_BYTES
from ..tables import CodeTrie, builds_on_card, code_trie, code_tensors, fetch, to_device
from ..trace import phase
from ..utils.stitch import split_blocks, stitch_flat_payload, words_to_bytes
from .mesh import Mesh, make_mesh

# A rank's decode masks real bytes by lane-linear int32 positions within its
# slice; a slice at or past this would wrap, so the process then decodes the
# whole body through the tile-local streaming decode instead, on its device
# (a local mesh's first), once.
_INT32_SAFE_BODY = 1 << 31

# A rank of a local mesh waits at most this long at an exchange for the
# others (a text-1GB rank's host tail takes tens of seconds between two).
LOCAL_TIMEOUT_S = 600.0

# Diagnostics of the last call: this rank's on a group's mesh; on a local
# mesh rank 0's, with every rank's in rank order under "ranks" (each rank
# returns its own; only the caller's thread writes these); empty after the
# tiled escape. The tests hold the encode's fetch to the compressed size and
# the host route's state fetch to 1/world.
last_encode_stats: dict = {}
last_decode_stats: dict = {}


# --- the local mesh: one thread per rank ---

class _Meet:
    """Where the ranks of a local mesh exchange tensors: one slot per rank
    and a barrier. :meth:`exchange` is the only place a rank waits for the
    others."""

    def __init__(self, world: int, timeout: float):
        self.barrier = threading.Barrier(world, timeout=timeout)
        self.slots: list = [None] * world

    def exchange(self, t: torch.Tensor, rank: int, combine):
        """``combine`` of every rank's ``t``, in rank order, each on this
        rank's ``t``'s device: a CPU tensor as it is (no copy), a CUDA
        tensor copied card to card where it lies on another card. Each
        side's stream is synchronized before the barrier it meets: the
        producer's, so that no copy reads ``t`` early, then this rank's
        (the copies and ``combine``), so that no rank frees or overwrites
        its ``t`` while another still reads it. Stages ``mesh_wait`` (both
        barriers) and ``mesh_copy`` (the copies, ``combine`` and the
        synchronize after them); counts as :func:`_count_exchange`."""
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        self.slots[rank] = t
        with phase("mesh_wait"):
            self.barrier.wait()
        with phase("mesh_copy"):
            out = combine([p.to(t.device) for p in self.slots])
            if t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
        _count_exchange(sum(p.numel() * p.element_size()
                            for r, p in enumerate(self.slots) if r != rank))
        with phase("mesh_wait"):
            self.barrier.wait()
        self.slots[rank] = None
        return out


def _spmd(mesh: Mesh, rank_fn, *args, **kwargs):
    """``rank_fn(mesh, *args, **kwargs)`` -> (part, stats) as this process's
    part of the mesh -> (the parts of this process's ranks in rank order,
    the stats). On a group's mesh ``rank_fn`` runs once, and its part holds
    every rank's data (it gathers them). On a local mesh it runs once per
    rank, each in a thread bound to its device, each part holding that
    rank's own data, for the caller to join (:func:`_join`); the stats are
    rank 0's with every rank's under ``"ranks"`` (each with its
    ``"stages"`` where the caller records them, the caller's record getting
    each stage's slowest rank and each count summed over the ranks). A
    rank's error aborts the barrier and is raised here, the lowest rank's
    first; no rank thread outlives the call."""
    if not mesh.local:
        part, stats = rank_fn(mesh, *args, **kwargs)
        return [part], stats
    meet = _Meet(mesh.world, LOCAL_TIMEOUT_S)
    caller = trace.current()
    recording = caller is not None
    results, errors = [None] * mesh.world, [None] * mesh.world

    def rank_main(r: int) -> None:
        dev = mesh.devices[r]
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            view = dataclasses.replace(mesh, rank=r, device=dev, devices=(), meet=meet)
            with trace.record_stages() if recording else contextlib.nullcontext() as stages:
                part, stats = rank_fn(view, *args, **kwargs)
            results[r] = (part, {**stats, "stages": stages} if recording else stats)
        except BaseException as e:  # handed to the caller, which raises it
            errors[r] = e
            meet.barrier.abort()

    threads = [threading.Thread(target=rank_main, args=(r,), name=f"entreepy-rank-{r}",
                                daemon=True) for r in range(mesh.world)]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    except BaseException:  # an interrupt of the caller: the ranks stop at their next exchange
        meet.barrier.abort()
        for t in threads:
            t.join()
        raise
    first = next((e for e in errors
                  if e is not None and not isinstance(e, threading.BrokenBarrierError)), None)
    if first is not None:
        raise first
    if any(e is not None for e in errors):
        raise TimeoutError(f"local mesh of {mesh.world} ranks: a rank waited more than "
                           f"{LOCAL_TIMEOUT_S} s at an exchange")
    ranks = [res[1] for res in results]
    if recording:
        for name in dict.fromkeys(k for st in ranks for k in st["stages"]):
            caller[name] = caller.get(name, 0.0) + max(st["stages"].get(name, 0.0)
                                                       for st in ranks)
        for st in ranks:
            for name, n in st["stages"].counts.items():
                trace.count(name, n)
    return [res[0] for res in results], {**ranks[0], "ranks": ranks}


def _join(parts: list) -> tuple:
    """The parts of :func:`_spmd`, each a tuple of per-rank lists, joined
    into one tuple of lists over every rank, in rank order."""
    return tuple([x for part in parts for x in part[i]] for i in range(len(parts[0])))


def _publish(stats: dict, got: dict) -> None:
    stats.clear()
    stats.update(got)


# --- collectives: the only calls into torch.distributed ---

def _count_exchange(taken: int) -> None:
    """One exchange of this rank with the others, in which it took
    ``taken`` bytes of their tensors (counts ``mesh_exchanges`` and
    ``p2p_bytes``; whatever the device, as the other counts)."""
    trace.count("mesh_exchanges", 1)
    trace.count("p2p_bytes", taken)


def _lone_exchange() -> None:
    """A rank alone exchanges nothing: its stages are recorded around the
    empty exchange, as every mesh records them, and it counts none."""
    with phase("mesh_wait"):
        pass
    with phase("mesh_copy"):
        pass


def _comm_device(mesh: Mesh) -> torch.device:
    """The device the group's collectives take tensors on: the mesh's device
    where the group runs NCCL for its type, else the host (gloo's
    all_gather takes CPU tensors only, so a gloo group with CUDA tensors
    copies through the host; the kernels still run on the card)."""
    config = dict(item.split(":") for item in dist.get_backend_config(mesh.group).split(","))
    return mesh.device if config.get(mesh.device.type) == "nccl" else torch.device("cpu")


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks, in place; at one rank ``t`` as it is."""
    if mesh.meet is not None:
        return t.copy_(mesh.meet.exchange(
            t, mesh.rank, lambda parts: torch.stack(parts).sum(0, dtype=t.dtype)))
    if mesh.group is None or mesh.world == 1:
        _lone_exchange()
        return t
    comm = _comm_device(mesh)
    buf = t.to(comm)
    with phase("mesh_wait"):
        dist.all_reduce(buf, group=mesh.group)
    _count_exchange((mesh.world - 1) * t.numel() * t.element_size())
    with phase("mesh_copy"):
        return t if buf is t else t.copy_(buf)


def _all_gather(t: torch.Tensor, mesh: Mesh, *, ragged: bool = False) -> list[torch.Tensor]:
    """Every rank's 1-D ``t``, in rank order, on ``t``'s device; at one rank
    ``[t]``. ``ragged``: the lengths differ per rank, so they are gathered
    first and each rank's ``t`` is padded to the largest (a local mesh
    exchanges each as it is)."""
    if mesh.meet is not None:
        return mesh.meet.exchange(t, mesh.rank, list)
    if mesh.group is None or mesh.world == 1:
        _lone_exchange()
        return [t]
    comm = _comm_device(mesh)
    buf = t.to(comm)
    sizes = [t.numel()] * mesh.world
    if ragged:
        n = torch.tensor([t.numel()], dtype=torch.int64, device=comm)
        got = [torch.empty_like(n) for _ in range(mesh.world)]
        with phase("mesh_wait"):
            dist.all_gather(got, n, group=mesh.group)
        sizes = [int(g) for g in got]
        buf = torch.cat([buf, buf.new_zeros(max(*sizes, 1) - t.numel())])
    parts = [torch.empty_like(buf) for _ in range(mesh.world)]
    with phase("mesh_wait"):
        dist.all_gather(parts, buf, group=mesh.group)
    _count_exchange((sum(sizes) - t.numel()) * t.element_size())
    with phase("mesh_copy"):
        return [p[:n].to(t.device) for p, n in zip(parts, sizes)]


def _to_host(t: torch.Tensor, mesh: Mesh, *, ragged: bool = False) -> list[np.ndarray]:
    """Every rank's 1-D ``t`` on the host, in rank order, through
    :func:`_all_gather`; on a local mesh's rank only its own, fetched in its
    thread (the caller joins the ranks' with :func:`_join`)."""
    parts = [t] if mesh.meet is not None else _all_gather(t, mesh, ragged=ragged)
    return [p.cpu().numpy() for p in parts]


# --- encode ---

def compress_sharded(data: bytes, mesh: Mesh | None = None, *, strict: bool = True,
                     block_bytes: int = DEFAULT_BLOCK_BYTES) -> bytes:
    """bytes -> complete .et file, block-parallel over the mesh's ranks
    (default: :func:`~.mesh.make_mesh`, every card of this process outside a
    group); byte-identical to the single-device and host codecs. Every rank
    passes the same ``data`` and gets the same file. The blocks are split,
    and the payloads stitched and serialized, once per process."""
    mesh = mesh or make_mesh()
    world = mesh.world
    arr = np.frombuffer(data, dtype=np.uint8)
    blocks, valid = split_blocks(arr, block_bytes)
    n_pad = -(-blocks.shape[0] // world) * world  # empty blocks even out the ranks
    if n_pad > blocks.shape[0]:
        blocks = np.concatenate([blocks, np.zeros((n_pad - blocks.shape[0], block_bytes),
                                                  np.uint8)])
        valid = np.concatenate([valid, np.zeros(n_pad - valid.size, np.int32)])
    parts, stats = _spmd(mesh, _compress_rank, blocks, valid, strict=strict)
    tables, flats, nw, bl = _join(parts)
    flats = [f.view(np.uint32) for f in flats]
    nw, bl = np.stack(nw).astype(np.int64), np.stack(bl).astype(np.int64)
    sizes = np.array([f.size for f in flats], dtype=np.int64)
    stats.update(fetched_bytes=int(sizes.sum()) * 4 + nw.size * 4 + bl.size * 4,
                 payload_bits=int(bl.sum()))
    with phase("stitch"):
        # nw/bl are [rank, lane]: rank r's words start where the ranks before
        # it end, its lanes back to back; block j*world + r is entry [r, j],
        # so the transpose puts them in block order
        offs = (np.cumsum(sizes) - sizes)[:, None] + np.cumsum(nw, axis=1) - nw
        words_out, total_bits = stitch_flat_payload(
            np.concatenate(flats), nw.T.reshape(-1), bl.T.reshape(-1), offs=offs.T.reshape(-1))
    with phase("serialize"):
        out = serialize_header(tables[0], arr.size) + words_to_bytes(words_out, total_bits)
    _publish(last_encode_stats, stats)
    return out


def _compress_rank(mesh: Mesh, blocks: np.ndarray, valid: np.ndarray, *, strict: bool):
    """One rank's :func:`compress_sharded` over the dealt ``blocks`` ->
    (([code table], flat payloads, word counts, bit lengths: each a list
    per rank, :func:`_to_host`), its stats)."""
    world, dev = mesh.world, mesh.device
    block_bytes = blocks.shape[1]
    lanes = blocks.shape[0] // world
    with phase("input_upload", lanes * block_bytes):
        mine = to_device(np.ascontiguousarray(blocks[mesh.rank::world]), dev)
        my_valid = valid[mesh.rank::world]
    with phase("device_histogram", mine.numel()):
        hist = histogram_device(mine.reshape(-1))
        hist[0] -= mine.numel() - int(my_valid.sum())  # the blocks' zero padding
        (counts,) = fetch(_all_reduce(hist, mesh))
    with phase("code_table"):
        table = build_code_table(counts, strict=strict)
    with phase("device_pack", mine.numel()):
        codes, lengths = code_tensors(table, dev)
        words, emitted, acc, nbits = pack_blocks(mine, to_device(my_valid, dev),
                                                 codes, lengths)
    with phase("sizing_fetch"):
        cap_g = plane_cap_g(int(grouped_counts_plane(emitted).max()), block_bytes)
    with phase("device_compact"):
        flat, nwords, bit_lens = compact_payload_flat(words, emitted, acc, nbits, cap_g)
    with phase("gather_payload"):
        part = ([table], _to_host(flat.view(torch.int32), mesh, ragged=True),
                _to_host(nwords, mesh), _to_host(bit_lens, mesh))
        trace.count("d2h_bytes", sum(a.nbytes for arrays in part[1:] for a in arrays))
    return part, dict(payload_bytes=flat.numel() * 4,
                      dense_bytes=world * (words.numel() * 4 + emitted.numel()))


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


def decompress_sharded(et: bytes, mesh: Mesh | None = None, *,
                       chunk_bytes: int = decode8.DEFAULT_CHUNK_BYTES,
                       expand: str = "onepass") -> bytes:
    """Complete .et file -> original bytes, chunk-parallel over the mesh's
    ranks through the ``expand`` route (``decode8.EXPAND_MODES``: "onepass",
    the two-pass "split" and "fused", or "host": each rank fetches only its
    own lanes' states, 1/world of the body, and expands them on the host).
    The mesh defaults as in :func:`compress_sharded`. Every rank passes the
    same file and gets the same bytes. The symbols are validated, joined
    and checked once per process."""
    decode8.check_expand(expand)
    mesh = mesh or make_mesh()
    hdr = parse_header(et)
    table, n = hdr.table, hdr.body_len
    _publish(last_decode_stats, {})
    if n == 0:
        return b""
    buf = np.frombuffer(et, dtype=np.uint8)[hdr.body_start:]
    n_real_lanes = max(1, -(-buf.size // chunk_bytes))
    lanes = -(-n_real_lanes // mesh.world)  # each rank's lanes; the rest is padding
    if lanes * chunk_bytes >= _INT32_SAFE_BODY:
        return decode8.decode_body_device_tiled(buf, table, n, device=mesh.device,
                                                chunk_bytes=chunk_bytes).tobytes()
    # what the ranks' tables are built from, built once here: the one-pass route's on cards
    # each rank builds on its own card from one packed trie; every other route's from one ByteFsm
    on_card = all(builds_on_card(d, expand) for d in mesh.devices or (mesh.device,))
    fsm = code_trie(table) if on_card else build_byte_fsm(table)
    parts, stats = _spmd(mesh, _decompress_rank, buf, table, n, fsm, n_real_lanes, lanes,
                         chunk_bytes=chunk_bytes, expand=expand)
    if parts[0] is None:  # decided on gathered values: every rank takes the serial decoder
        out = decode8.decode_host(buf, table, n)
    else:
        metas, syms = _join(parts)
        decode8.host_validate([m.reshape(2, -1) for m in metas], n)
        with phase("host_join"):
            out = np.concatenate(syms)[:n]
        decode8.host_check_bits(out, out.size, n, table, buf.size)
    _publish(last_decode_stats, stats)
    return out.tobytes()


def _decompress_rank(mesh: Mesh, buf: np.ndarray, table, n: int, fsm: ByteFsm | CodeTrie,
                     n_real_lanes: int, lanes: int, *, chunk_bytes: int, expand: str):
    """One rank's :func:`decompress_sharded` of the body ``buf`` (``n``
    symbols) over its ``lanes`` -> ((lane metadata, symbols: each a list
    per rank, :func:`_to_host`), or None where the fixed point did not
    converge; its stats)."""
    dev, lo, gather = mesh.device, mesh.rank * lanes * chunk_bytes, _ExitGather(mesh)
    seg = buf[lo : lo + lanes * chunk_bytes]  # rank-local positions: seg.size bytes are real
    _, tables = decode8.route_tables(table, dev, expand, fsm)
    rows, _, unconverged = decode8.route_passes(seg, lanes, chunk_bytes, dev, tables, expand, n,
                                                n_real_lanes=n_real_lanes, gather=gather)
    stats = {"passes": gather.calls - 1, "lanes": lanes}
    if unconverged:
        return None, stats
    if expand == "host":
        with phase("device_state_fetch", seg.size):
            (st,) = fetch(rows[1].t().contiguous().reshape(-1)[: seg.size])
        with phase("host_expand", n):
            lane_tot, w_inv, syms = _expand_chunks(st, seg, fsm, chunk_bytes, lanes)
        stats.update(fetched_states_bytes=st.nbytes,
                     total_states_bytes=mesh.world * lanes * chunk_bytes)
    else:
        syms, lane_tot, w_inv = decode8.take_symbols(
            decode8.route_symbols(rows, tables, expand, seg.size, n))
    stats.update(local_symbols=int(syms.size), n_symbols=n)
    with phase("gather_symbols"):
        meta = np.concatenate([lane_tot, w_inv], dtype=np.int64)
        part = (_to_host(torch.from_numpy(meta), mesh),
                _to_host(torch.from_numpy(syms), mesh, ragged=True))
    return part, stats
