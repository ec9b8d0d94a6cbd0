#!/usr/bin/env python3
"""Smoke test of the PyTorch port (entreepy_tpu_torch) on one CUDA card.

Run from the root of a checkout, on a machine with an H100:

    [ENTREEPY_PROFILE=<dir>] python3 chip_smoke.py
    python3 chip_smoke.py --only multicard   # phases 1, 2 and [multicard] alone

Phases, one or more lines each; any failure raises and the exit code is not 0:

1. device  — the card's name and power limit (nvidia-smi), CUDA version,
             capability (must be 9.0), nvcc;
2. build   — compile the kernels of entreepy_tpu_torch/csrc with nvcc;
3. kernels — each of the eleven kernels against its plain PyTorch version at
             the shapes of the 5.2 MB text corpus (and of the skewed and
             run-heavy corpora for the unpacked fused pass, the sync pass's
             and the emit pass's 256-state tables and the expansions' wider
             tables; the
             compaction also on each expansion's rows, as the two-pass
             routes give them), bit-identical on every live value;
             the sync and fused passes and the symbols kernel's two launches
             (symbol_counts, write_symbols: the packed form at the text's
             tiles, the plane form at the skewed and run-heavy bodies') also
             at a full 65,536-lane tile of the
             100 MB text body, the pack at a full 32 MiB encode tile of the
             100 MB text, the stitch at the 5.2 MB text's tile and a 32 MiB tile of
             the 100 MB text, at several base shifts with a carried word, the
             tables kernel (fsm_tables) at the code tables of the text, skewed,
             run-heavy and random corpora against the host's NumPy build, whose
             time is printed beside the card build's host and device times; a kernel's
             time is a run of back-to-back launches between
             one CUDA-event pair, divided by the count; a plain version's is
             the median CUDA-event time of single calls; each kernel's bound
             is the bytes it must move (each input read once, each output
             written once) over the card's 3.35 TB/s, and its library time
             that of one PyTorch call computing the same function, where one
             exists (the full-table expansion: one advanced-indexing call);
   guard   — every one of the kernels' 39 template instantiations at small
             odd shapes (tools/sanitize_kernels.py's calls; lanes 1, 7, 33,
             300): torch.profiler must see all 39 launch; then each call
             twice, every input and every tensor the wrappers allocate
             inside guard bands of a poison byte (0xA5, then 0x5A): no guard
             band may change (a write out of bounds), no input may change,
             and the outputs, padding included, must agree between the two
             poisons (else a kernel read memory nothing wrote or outside its
             inputs); then the public API's routes on ~200 KB text and
             skewed bodies and a 7-lane tiled decode, guarded the same way
             and byte-exact;
4. e2e     — compress + decompress with backend="device" on 5.2 MB text,
             5 MB skewed / run-heavy / random and 100 MB text: .et bytes equal
             the host backend's, round trips exact, the 374-B golden file
             matches, the 100 MB text streams in >= 2 decode and encode tiles
             (counted: one sync pass per decode tile, one pack launch per
             encode tile); then decompress through each two-pass route
             (expand="split", "fused", "host"; 100 MB through "host" only);
             then the tiled decode at narrow tiles (100 MB text in 8192-lane
             tiles, 5 MB skewed in 1024-lane tiles: byte-exact) and the peak
             device memory of the 100 MB decompress at both tile widths; auto
             routing (backend=None: the host-to-device probe must say fast,
             host at 5.2 MB, the device at 100 MB); the CLI in process
             (``entreepy_tpu_torch.cli.main``: c/d of the 100 MB file through
             auto, ``--backend device`` on the 5.2 MB file); the sharded
             backend (``[sharded]``): at world 1, a one-rank NCCL group, the
             5.2 MB text through every route, the 5 MB skewed body through
             "onepass" and "fused", the 100 MB text compressed and decompressed
             once (untiled) with its peak device memory beside the device
             backend's (world 1 on any machine: one rank on ``cuda``); then
             world 2 on the one card, two spawned processes in
             a gloo group, the 5.2 MB text and 5 MB skewed round trips through
             "onepass" and "host" (.et equal the host backend's, the same
             fixed-point passes on both ranks, a timeout); the sharded
             backend over several ranks (``[multicard]``): a local mesh of two
             ranks on cuda:0 (two threads, one card) through the 5.2 MB text
             on every route, 5 MB skewed and run-heavy and 100 MB text, each
             call exact, its peak device memory per card, the ranks' passes,
             exchange stages and bytes read from the other ranks (counted
             from shapes), beside the device backend's time; with two or more
             cards (up to four) also auto's pick of ``sharded`` at 100 MB,
             the local mesh over the cards at those sizes and at text-1GB and
             random-2.125GiB ("onepass" and "host"), NCCL process worlds of
             2 and n ranks, a card each (``NCCL_DEBUG=WARN``; each rank's
             launches, peak device memory and peak RSS), and each kernel
             against its plain version on every card; with one card, one line
             saying so; the JAX
             package's largest configurations (``[large]``,
             tools/large_check.py): 10^9 B of text (enwik9 scale) and
             2^31 + 2^27 B of random bytes (a body past 2 GiB, required)
             through the host codec, the device backend's tiled compress and
             one-pass decompress, its untiled "host" route, the sharded
             backend at world 1 (a one-rank NCCL group; the random body takes
             the tiled escape) and, at the random body, "split" and "fused"
             refused; every result exact, one line per call with its ms,
             peak device memory, peak RSS, tiles and launches, and the tiled
             calls' peaks within 1.10x those of the 100 MB text; then, outside
             the path's launch counts, each of its kernels against its plain
             version at the shapes those calls gave it
             (``large_kernel_checks``: the first decode and encode tiles
             whole, the untiled passes, pack and compaction on their last
             65,536 lanes or blocks, where the offsets pass 2^31); the wheel
             (``[install]``, tools/installed_check.py): built with ``pip
             wheel`` from a copy of the packaging files, so it bundles the
             portable host runtime and the kernels built for sm_90a,
             installed with ``pip install --target`` and run from an empty
             directory with a fresh XDG_CACHE_HOME, CUDA_HOME at nothing and
             no nvcc or g++ on PATH: the 5.2 MB text through the device
             backend and the "split" and "fused" routes (.et equal the host
             backend's, bytes exact, every kernel launched from the bundled
             library), the ``entreepy-torch`` console script's c/d of the
             golden file, nothing written to the cache or beside the
             install, the host codec's time with the portable runtime beside
             the checkout's -march=native build; the bench (``[bench]``):
             ``python -m entreepy_tpu_torch.bench`` as a user runs it, each
             command in a process of its own (BENCH_COMMANDS: the headline at
             5.2 MB, ``scale`` at 5 MB over the four corpora, the three
             backends and every route with ``--stages``, ``scale`` at 100 MB
             text, ``weak`` over worlds 1 and 2): exit 0, every row's .et equal
             to the host backend's and its round trip exact, the headline's
             ``cuda_*`` probe figures positive with each bound share at most
             100 %, all eleven kernels launched by the headline's device rows
             and by the 5 MB sweep's, no module of JAX or of entreepy_tpu in
             the bench's process; every number beside the card. Each path runs
             with the launch counts set to 0 and must launch each of its
             kernels; no self-sync host fallback; warm times of every route,
             of auto and of the host backend side by side, and of the sharded
             backend beside the device backend's;
5. stages  — each corpus's compress and decompress split into the
             pipeline's stages (``entreepy_tpu_torch.trace.record_stages``:
             host clock, the device synchronized at each stage's end; the
             median and range of the calls), and the two-pass routes'
             stages on 5.2 MB text;
   ENTREEPY_PROFILE=<dir> adds the port's profiler (trace.maybe_profile)
             over a warm 5.2 MB round trip, its traces written into <dir>:
             the device's self time and its busy share of the call.

Then one JSON line of kernel results, the nvidia-smi line again, and last
``{"ok": true, "device": {...}}``. Imports only entreepy_tpu_torch, numpy
and torch; never JAX nor any module of the JAX package (required before the
last line).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import inspect
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

ROOT = Path(__file__).resolve().parent
if not (ROOT / "entreepy_tpu_torch" / "csrc").is_dir():
    sys.exit("chip_smoke: run from the root of a checkout (entreepy_tpu_torch/csrc missing)")
sys.path.insert(0, str(ROOT))

sys.path.insert(0, str(ROOT / "tools"))

import installed_check as ic  # noqa: E402  (the [install] phase)
import large_check as lg  # noqa: E402  (the [large] phase)
import sanitize_kernels as sk  # noqa: E402  (the [guard] phase)
import torch_kernel_ab as ab  # noqa: E402  (the kernels' comparisons, shared)

import entreepy_tpu_torch as et  # noqa: E402
from entreepy_tpu_torch.bench import bound_ms, kernel_ms, make_corpus  # noqa: E402
from entreepy_tpu_torch.bench.timing import rss_peak  # noqa: E402
from entreepy_tpu_torch import _build, api, cli, runtime, trace  # noqa: E402
from entreepy_tpu_torch.ops import (  # noqa: E402
    cuda_compact, cuda_fsm8, cuda_pack, cuda_stitch, cuda_symbols, cuda_tables, decode8,
)
from entreepy_tpu_torch.ops.bitpack import (  # noqa: E402
    compact_plane_rows, grouped_counts_plane, plane_cap_g, plane_sub_for,
)
from entreepy_tpu_torch.format import parse_header  # noqa: E402
from entreepy_tpu_torch.format.fsm8 import _build_byte_fsm, _build_trie  # noqa: E402
from entreepy_tpu_torch.ops.encode import DEFAULT_BLOCK_BYTES, TILE_BLOCKS  # noqa: E402
from entreepy_tpu_torch.parallel import dist as pdist  # noqa: E402
from entreepy_tpu_torch.parallel import make_mesh, multihost  # noqa: E402
from entreepy_tpu_torch.tables import (  # noqa: E402
    body_for, card_decode_tables, code_tensors_for, code_trie, decode_tables, decode_tables_for,
    expand_tables_for,
)

DATA = ROOT / "tests" / "data"
MB = 1_000_000
DEV = torch.device("cuda")
KERNELS = {  # wrapper -> (name, source, TPU kernel it replaces)
    cuda_fsm8.sync_pass: ("sync_pass", "entreepy_tpu_torch/csrc/fsm8.cu",
                          "entreepy_tpu/ops/pallas_fsm8.py:183"),
    cuda_fsm8.emit_pass: ("emit_pass", "entreepy_tpu_torch/csrc/fsm8.cu",
                          "entreepy_tpu/ops/pallas_fsm8.py:207"),
    cuda_fsm8.fused_pass: ("fused_pass", "entreepy_tpu_torch/csrc/fsm8.cu",
                           "entreepy_tpu/ops/pallas_fsm8.py:539"),
    cuda_fsm8.expand_pass_split: ("expand_pass_split", "entreepy_tpu_torch/csrc/expand.cu",
                                  "entreepy_tpu/ops/pallas_fsm8.py:389"),
    cuda_fsm8.expand_pass: ("expand_pass", "entreepy_tpu_torch/csrc/expand.cu",
                            "entreepy_tpu/ops/pallas_fsm8.py:288"),
    cuda_pack.pack_blocks: ("pack_blocks", "entreepy_tpu_torch/csrc/pack.cu",
                            "entreepy_tpu/ops/pallas_pack.py:117"),
    cuda_compact.compact_rows: ("compact_rows", "entreepy_tpu_torch/csrc/compact.cu",
                                "entreepy_tpu/ops/pallas_compact.py:121"),
    # the symbols kernel's two launches; the JAX package selects the symbols on the host
    cuda_symbols.symbol_counts: ("symbol_counts", "entreepy_tpu_torch/csrc/symbols.cu",
                                 "none (host selection)"),
    cuda_symbols.write_symbols: ("write_symbols", "entreepy_tpu_torch/csrc/symbols.cu",
                                 "none (host selection)"),
    # the single-device encode's stitch; the JAX package stitches on the host
    cuda_stitch.stitch_tile: ("stitch_tile", "entreepy_tpu_torch/csrc/stitch.cu",
                              "none (host stitch)"),
    # the one-pass decode's tables on the card; the JAX package builds them in NumPy
    cuda_tables.fsm_tables: ("fsm_tables", "entreepy_tpu_torch/csrc/tables.cu",
                             "none (host NumPy build)"),
}
SYMBOLS = (cuda_symbols.symbol_counts, cuda_symbols.write_symbols)
# every kernel but the single-device encode's stitch: the sharded encode stitches on the host
MESH_KERNELS = tuple(fn for fn in KERNELS if fn is not cuda_stitch.stitch_tile)
# Kernels each main path must launch: the device backend's round trip (encode
# and the one-pass decode) and each two-pass decode route.
PATH_KERNELS = {
    "device": (cuda_fsm8.sync_pass, cuda_fsm8.fused_pass, cuda_pack.pack_blocks,
               cuda_compact.compact_rows, *SYMBOLS, cuda_stitch.stitch_tile,
               cuda_tables.fsm_tables),
    "split": (cuda_fsm8.sync_pass, cuda_fsm8.emit_pass, cuda_fsm8.expand_pass_split,
              cuda_compact.compact_rows, cuda_symbols.write_symbols),
    "fused": (cuda_fsm8.sync_pass, cuda_fsm8.emit_pass, cuda_fsm8.expand_pass,
              cuda_compact.compact_rows, cuda_symbols.write_symbols),
    "host": (cuda_fsm8.sync_pass, cuda_fsm8.emit_pass),
    # the tiled decode at narrow tiles: packed text and unpacked skewed rows
    "tiles": (cuda_fsm8.sync_pass, cuda_fsm8.fused_pass, cuda_compact.compact_rows, *SYMBOLS,
              cuda_tables.fsm_tables),
    # auto routing at 5.2 MB (host: no launch) and 100 MB (the device)
    "auto": (cuda_fsm8.sync_pass, cuda_fsm8.fused_pass, cuda_pack.pack_blocks, *SYMBOLS,
             cuda_stitch.stitch_tile, cuda_tables.fsm_tables),
    "cli": (cuda_fsm8.sync_pass, cuda_fsm8.fused_pass, cuda_pack.pack_blocks,
            cuda_compact.compact_rows, *SYMBOLS, cuda_stitch.stitch_tile,
            cuda_tables.fsm_tables),
    # the sharded backend at world 1: every route, so every kernel but the stitch
    "sharded": MESH_KERNELS,
    # the JAX package's largest configurations (tools/large_check.py)
    "large": lg.PATH_KERNELS,
    # local meshes: 5.2 MB text through every route, so every kernel but the stitch
    "multicard": MESH_KERNELS,
}
# World 1 of the sharded phase: each corpus through these routes.
SHARDED_CASES = (("text 5.2 MB", decode8.EXPAND_MODES), ("skewed 5 MB", ("onepass", "fused")))
# World 2 of the sharded phase: two ranks on the one card, in a gloo group
# (NCCL takes one card per rank), each round trip through these routes.
WORLD2_CASES = (("text 5.2 MB", "text", 5_200_000), ("skewed 5 MB", "skewed", 5 * MB))
WORLD2_ROUTES = ("onepass", "host")
WORLD_TIMEOUT_S = 400
WORLD_KERNELS = ("sync_pass", "fused_pass", "emit_pass", "pack_blocks", "compact_rows")
# [multicard]: the sharded backend over several ranks: local meshes (one
# process, a thread per rank; 2 ranks on cuda:0 on any machine, one rank per
# card over up to MC_MAX_CARDS cards) and NCCL process worlds, a card each.
MC_MAX_CARDS = 4
MC_CASES = (("text 5.2 MB", decode8.EXPAND_MODES), ("skewed 5 MB", ("onepass", "fused")),
            ("runheavy 5 MB", ("onepass",)), ("text 100 MB", ("onepass", "host")))
MC_LARGE_ROUTES = ("onepass", "host")  # at [large]'s configurations, across the cards
NCCL_CASES = (("text 5.2 MB", "text", 5_200_000), ("text 100 MB", "text", 100 * MB))
NCCL_ROUTES = ("onepass", "host")
NCCL_TIMEOUT_S = 240  # a world's ranks take about 40 s; NCCL that cannot start must not hang
# [large]: lanes or blocks of an untiled shape held against the plain version
LARGE_WINDOW = 65_536


def corpus(kind: str, n_bytes: int) -> bytes:
    return make_corpus(kind, n_bytes)


def cuda_ms(fn, iters: int) -> float:
    """Median CUDA-event time of single ``fn()`` calls in ms, after one
    warm-up call (the plain versions' timing)."""
    fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(fn, iters: int) -> float:
    """Median host-clock time of ``fn()`` in ms (it ends in a host fetch)."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor, live: torch.Tensor | None = None) -> int:
    """Largest |a - b| over the live elements; raises if any differs."""
    err = ab.max_err(a, b, live)
    require(err == 0, f"kernel and plain version differ (max |err| {err})")
    return err


def body_xs(buf: np.ndarray, chunk: int = decode8.DEFAULT_CHUNK_BYTES):
    """(xs uint8[K, lanes] on the card, lanes) of a compressed body, as the
    decode's main path lays it out."""
    lanes = -(-buf.size // chunk)
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[: buf.size] = buf
    return decode8.bytes_to_cols(padded, lanes, chunk, DEV).t().contiguous(), lanes


def body_cols(data: bytes):
    """(xs uint8[K, lanes] on the card, one-pass decode tables, n_valid,
    n_real_lanes) of a corpus's compressed body."""
    tables, buf = decode_tables_for(et.compress(data, backend="host"), DEV)
    xs, lanes = body_xs(buf)
    return xs, tables, buf.size, lanes


def sync_check(xs, next_state):
    """Sync kernel vs plain over the suffix window the main path's first
    guess walks, from the root: exits exact. Returns (err, ms, plain_ms,
    bound_ms, library_ms)."""
    w = min(decode8.SYNC_WINDOW, xs.shape[0])
    sx, zeros = xs[-w:], torch.zeros(xs.shape[1], dtype=torch.int32, device=DEV)
    exits = cuda_fsm8.sync_pass(sx, next_state, zeros)
    return (max_err(exits, cuda_fsm8.sync_pass_plain(sx, next_state, zeros)),
            kernel_ms(lambda: cuda_fsm8.sync_pass(sx, next_state, zeros)),
            cuda_ms(lambda: cuda_fsm8.sync_pass_plain(sx, next_state, zeros), 3),
            bound_ms(sx, next_state, zeros, exits), None)


def emit_check(xs, next_state):
    """Emit kernel vs plain from the entries of the main path's first pass
    (the suffix sync's guess): states and exits exact. Returns (err, ms,
    plain_ms, bound_ms, library_ms)."""
    k, lanes = xs.shape
    w = min(decode8.SYNC_WINDOW, k)
    zeros = torch.zeros(lanes, dtype=torch.int32, device=DEV)
    guess = cuda_fsm8.sync_pass(xs[-w:], next_state, zeros)
    entries = torch.cat([zeros[:1], guess[:-1]])
    sk, xk = cuda_fsm8.emit_pass(xs, next_state, entries)
    sp, xp = cuda_fsm8.emit_pass_plain(xs, next_state, entries)
    err = max(max_err(sk, sp), max_err(xk, xp))
    ms = kernel_ms(lambda: cuda_fsm8.emit_pass(xs, next_state, entries))
    plain_ms = cuda_ms(lambda: cuda_fsm8.emit_pass_plain(xs, next_state, entries), 3)
    return err, ms, plain_ms, bound_ms(xs, next_state, entries, sk, xk), None


def compact_check(rows, live, sub: int, cap: int):
    """Compaction kernel vs plain: plane and counts exact. Returns (err, ms,
    plain_ms, bound_ms, library_ms)."""
    ck = cuda_compact.compact_rows(rows, live, sub, cap)
    cp = cuda_compact.compact_rows_plain(rows, live, sub, cap)
    return (max(max_err(ck[0], cp[0]), max_err(ck[1], cp[1])),
            kernel_ms(lambda: cuda_compact.compact_rows(rows, live, sub, cap)),
            cuda_ms(lambda: cuda_compact.compact_rows_plain(rows, live, sub, cap), 3),
            bound_ms(rows, live, *ck), None)


def expand_check(blob: bytes, split: bool):
    """Split or full expansion kernel vs plain at a body's shapes, from its
    converged states: row 0 exact, symbol slots where live. Then the
    compaction kernel vs plain on the kernel's masked rows, at the sub-group
    width and cap the two-pass route gives it. Returns ((err, ms, plain_ms)
    of the expansion, the same of the compaction, tables, (sub, cap))."""
    tables, buf = expand_tables_for(blob, DEV, split)
    xs, lanes = body_xs(buf)
    states, unconverged = decode8.fsm8_decode(xs, tables.next_state, lanes)
    require(not unconverged, "self-sync did not converge")
    m = tables.m
    if split:
        args = (xs, states, tables.table, m, tables.mt)
        fn, plain = cuda_fsm8.expand_pass_split, cuda_fsm8.expand_pass_split_plain

        def kernel():
            return fn(*args)
    else:
        args = (xs, states, tables.table, m)
        fn, plain = cuda_fsm8.expand_pass, cuda_fsm8.expand_pass_plain

        def kernel():  # with the vector table the decode builds once per table
            return fn(*args, tables.vec)
    vk, vp = kernel(), plain(*args)
    j = torch.arange(m, device=DEV)[None, :, None]
    err = max(max_err(vk[:, 0], vp[:, 0]),
              max_err(vk[:, 1:], vp[:, 1:], j < (vp[:, 0] & 15)[:, None, :]))
    library = None
    if not split:  # one advanced-indexing call gives the full table's [K, m+1, lanes] rows
        cols_of = (torch.arange(m + 1, device=DEV) * tables.s)[None, :, None]

        def index_call():
            return tables.table[xs.long()[:, None, :], states.long()[:, None, :] + cols_of]

        max_err(index_call(), vk)
        library = kernel_ms(index_call)
    expand = (err, kernel_ms(kernel), cuda_ms(lambda: plain(*args), 3),
              bound_ms(xs, states, tables.table, vk), library)

    k = xs.shape[0]
    counts, _inv, syms = decode8._expand_mask(vk[:, 0], vk[:, 1:], buf.size)
    sub, cap = decode8._sub_width(k) * m, decode8.sym_cap(counts, m)
    live = (j < counts[:, None, :]).reshape(k * m, lanes)
    compact = compact_check(syms.reshape(k * m, lanes).to(torch.int32), live, sub, cap)
    return expand, compact, tables, (sub, cap)


def pack_check(data: bytes, blob: bytes):
    """Pack kernel vs plain on ``data`` in the encode's blocks, with the
    code table of ``blob``: emitted, acc and nbits exact, words where
    emitted. Returns ((err, ms, plain_ms, bound_ms, library_ms), the
    kernel's results)."""
    blocks, valid = ab.encode_blocks(data, DEFAULT_BLOCK_BYTES, DEV)
    codes, lengths = code_tensors_for(blob, DEV)
    pk = cuda_pack.pack_blocks(blocks, valid, codes, lengths)
    err = ab.pack_err(pk, cuda_pack.pack_blocks_plain(blocks, valid, codes, lengths))
    require(err == 0, f"kernel and plain version differ (max |err| {err})")
    return (err, kernel_ms(lambda: cuda_pack.pack_blocks(blocks, valid, codes, lengths)),
            cuda_ms(lambda: cuda_pack.pack_blocks_plain(blocks, valid, codes, lengths), 3),
            bound_ms(blocks, valid, codes, lengths, *pk), None), pk


def stitch_check(data: bytes, blob: bytes, shift: int = 0, seed: int = 0):
    """Stitch kernel vs plain on ``data`` as one encode tile, with the code
    table of ``blob``: the tile's pack and compaction as the encode runs
    them, then the stream's bytes exact at base ``shift`` (0-31), with a
    random carried word in the shift's bits when it is not 0. At shift 0
    the stream is the host codec's body where ``data`` starts the document.
    Returns (err, ms, plain_ms, bound_ms, library_ms)."""
    blocks, valid = ab.encode_blocks(data, DEFAULT_BLOCK_BYTES, DEV)
    codes, lengths = code_tensors_for(blob, DEV)
    words, emitted, acc, nbits = cuda_pack.pack_blocks(blocks, valid, codes, lengths)
    counts_g = grouped_counts_plane(emitted)
    plane, counts = compact_plane_rows(
        words, emitted, plane_cap_g(int(counts_g.max()), DEFAULT_BLOCK_BYTES))
    del words, emitted, blocks
    bits = int(counts_g.sum()) * 32 + int(nbits.sum())
    n_words = (shift + bits + 31) >> 5
    word = int(np.random.default_rng(seed).integers(1, 1 << 32)) & ~(0xFFFFFFFF >> shift)
    carry = (torch.tensor(list(word.to_bytes(4, "big")), dtype=torch.uint8, device=DEV)
             if shift else None)
    args = (plane, counts, acc, nbits, shift, n_words, carry)
    out = cuda_stitch.stitch_tile(*args)
    err = max_err(out, cuda_stitch.stitch_tile_plain(*args))
    if shift == 0:  # the document's first bits, whole bytes: the host codec's body
        body = np.frombuffer(blob, np.uint8)[parse_header(blob).body_start:][: bits // 8]
        max_err(out[: body.size], torch.from_numpy(body.copy()).to(DEV))
    return (err, kernel_ms(lambda: cuda_stitch.stitch_tile(*args)),
            cuda_ms(lambda: cuda_stitch.stitch_tile_plain(*args), 3),
            bound_ms(plane, counts, acc, nbits, out), None)


def tables_check(blob: bytes):
    """Tables kernel vs its plain version and the host's NumPy build
    (``_build_byte_fsm``, ``decode_tables``) on the code table of ``blob``:
    next_state and the fused table exact. Returns ((err, ms, plain_ms,
    bound_ms, library_ms), a label)."""
    table = parse_header(blob).table
    children, leaf_sym = _build_trie(table)
    width, m, mt, s = cuda_tables.trie_layout(children, leaf_sym)
    args = (cuda_tables.pack_trie(children, leaf_sym), width, s, mt, DEV)
    ns, fused = cuda_tables.fsm_tables(*args)
    host = decode_tables(_build_byte_fsm(table), DEV)
    plain = cuda_tables.fsm_tables_plain(*args)
    err = max(max_err(ns, host.next_state), max_err(fused, host.fused),
              max_err(ns, plain[0]), max_err(fused, plain[1]))
    return ((err, kernel_ms(lambda: cuda_tables.fsm_tables(*args)),
             cuda_ms(lambda: cuda_tables.fsm_tables_plain(*args), 3), bound_ms(ns, fused), None),
            f"{children.shape[0]} nodes, S={width} m={m} s={s}, fused {tuple(fused.shape)}")


def table_build_ms(blob: bytes) -> tuple[float, float, float]:
    """The one-pass tables of ``blob``'s code table built three ways, ms,
    median of 7 on the host clock, outside the launch counts: the host's
    NumPy build and upload (``_build_byte_fsm``, ``decode_tables``), the
    card build to its launch (``code_trie``: trie and layout DP, then
    ``card_decode_tables``: the launch) and to the tables' end."""
    table = parse_header(blob).table
    with uncounted():
        return (wall_ms(lambda: decode_tables(_build_byte_fsm(table), DEV), 7),
                wall_ms(lambda: card_decode_tables(code_trie(table), DEV), 7),
                wall_ms(lambda: (card_decode_tables(code_trie(table), DEV),
                                 torch.cuda.synchronize()), 7))


def fused_check(xs, tables, n_valid, lanes, packed: bool):
    """Fused kernel vs plain at converged entry states: row0/count bytes and
    exits exact, symbol slots compared where live (j < count). Returns (err,
    ms, plain_ms, bound_ms, library_ms)."""
    m, mt, s = tables.m, tables.mt, tables.s
    _, exits, unconverged = decode8.fsm8_decode_fused(
        xs.t().contiguous(), tables.next_state, tables.fused, lanes, m, mt, s,
        packed=packed, n_valid=n_valid,
    )
    require(not unconverged, "self-sync did not converge")
    entries = torch.cat([exits.new_zeros(1), exits[:-1]])
    args = (xs, tables.fused, entries, m, mt, s, packed, n_valid)
    vk, xk = cuda_fsm8.fused_pass(*args)
    err = fused_err(vk, xk, *cuda_fsm8.fused_pass_plain(*args), m, packed)
    ms = kernel_ms(lambda: cuda_fsm8.fused_pass(*args))
    plain_ms = cuda_ms(lambda: cuda_fsm8.fused_pass_plain(*args), 3)
    return err, ms, plain_ms, bound_ms(xs, tables.fused, entries, vk, xk), None


def fused_err(vk, xk, vp, xp, m: int, packed: bool) -> int:
    """The fused kernel's rows and exits against the plain version's:
    row0/count bytes and exits exact, symbol slots where live (j < count)."""
    j = torch.arange(m, device=vk.device)[None, :, None]
    if packed:
        row0k, row0p = vk >> (8 * m), vp >> (8 * m)
        shifts = (8 * (m - 1 - j)).int()
        slots_k = (vk[:, None, :] >> shifts) & 255
        slots_p = (vp[:, None, :] >> shifts) & 255
    else:
        row0k, row0p = vk[:, 0], vp[:, 0]
        slots_k, slots_p = vk[:, 1:], vp[:, 1:]
    return max(max_err(row0k, row0p), max_err(xk, xp),
               max_err(slots_k, slots_p, j < (row0p & 15)[:, None, :]))


def onepass_items(xs, tables, n_valid, lanes):
    """What the one-pass route hands the symbols kernel for a body at its
    fixed point: (items, m, mini_tot, cap) of :func:`symbols_check`, the
    fused pass's packed words for m <= 3, else the compaction kernel's
    subgroup plane of its masked rows."""
    m = tables.m
    vals, _, unconverged = decode8.fsm8_decode_fused(
        xs.t().contiguous(), tables.next_state, tables.fused, lanes, m, tables.mt, tables.s,
        packed=m <= 3, n_valid=n_valid)
    require(not unconverged, "self-sync did not converge")
    if m <= 3:
        return vals, m, None, 0
    counts, inv, syms = decode8._expand_mask(vals[:, 0], vals[:, 1:].to(torch.uint8), n_valid)
    cap = decode8.sym_cap(counts, m)
    plane, mini_tot, _, _ = decode8.compact_symbols_device(counts, inv, syms, m, cap)
    return plane, 1, mini_tot, cap


def symbols_check(items, m, mini_tot=None, cap=0):
    """The symbols kernel vs plain on a tile's items: the count launch's
    lane_tot and w_inv (packed form) and the write launch's symbols exact.
    Returns (the count launch's (err, ms, plain_ms, bound_ms, library_ms),
    None on the plane form; the write launch's; (ms, bound_ms) of the
    launches back to back, the bound the items read once and the symbols
    and lane metadata written once)."""
    count = None
    if mini_tot is None:
        tot, inv = cuda_symbols.symbol_counts(items, m)
        err = max(max_err(t, p) for t, p in zip((tot, inv),
                                                cuda_symbols.symbol_counts_plain(items, m)))
        count = (err, kernel_ms(lambda: cuda_symbols.symbol_counts(items, m)),
                 cuda_ms(lambda: cuda_symbols.symbol_counts_plain(items, m), 3),
                 bound_ms(items, tot, inv), None)
    else:
        tot = mini_tot.clamp(max=cap).sum(0, dtype=torch.int32)
    ends = tot.cumsum(0, dtype=torch.int64)
    args = (items, ends, int(ends[-1]), m, mini_tot, cap)
    out = cuda_symbols.write_symbols(*args)
    ins = (items,) if mini_tot is None else (items, mini_tot)
    write = (max_err(out, cuda_symbols.write_symbols_plain(*args)),
             kernel_ms(lambda: cuda_symbols.write_symbols(*args)),
             cuda_ms(lambda: cuda_symbols.write_symbols_plain(*args), 3),
             bound_ms(*ins, ends, out), None)
    if mini_tot is None:
        pair = kernel_ms(lambda: (cuda_symbols.symbol_counts(items, m),
                                  cuda_symbols.write_symbols(*args)))
    else:
        pair = write[1]
    return count, write, (pair, bound_ms(*ins, out, tot, tot))


def timed(fn):
    """(fn(), its device time in ms: one call between a CUDA-event pair)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def tail_window(n: int) -> slice:
    """The last LARGE_WINDOW of ``n`` lanes or blocks: where a kernel's
    offsets are highest (past 2^31 at [large]'s random configuration)."""
    return slice(max(0, n - LARGE_WINDOW), n)


def large_kernel_checks(data: bytes, blob: bytes) -> list:
    """Each kernel of the [large] path against its plain version at the
    shapes its calls gave it, for one configuration (``data`` and its
    ``.et``): the sync and fused passes on the tiled decode's first tile,
    and the pack and the compaction on the tiled encode's, whole; then the
    untiled shapes, each kernel launched on all of them and compared on the
    last LARGE_WINDOW lanes or blocks (the plain versions loop in Python):
    the host route's sync and emit passes over the whole body, the
    untiled sharded decode's fused pass where the body stays below the 2
    GiB escape, and the untiled sharded compress's pack over every block
    and compaction of its words; the one-pass tables of its code table
    (``tables_check``). Kernel times are at the full shape, plain
    times on what was compared. Returns [(wrapper, label, (err, ms,
    plain_ms, bound_ms, None))]."""
    out = []
    tables, buf = decode_tables_for(blob, DEV)
    ns, m, packed = tables.next_state, tables.m, tables.m <= 3
    tile = buf[: decode8.TILE_LANES * decode8.DEFAULT_CHUNK_BYTES]
    xs, lanes = body_xs(tile)
    out.append((cuda_fsm8.sync_pass, f"the first {lanes}-lane decode tile, whole",
                sync_check(xs, ns)))
    out.append((cuda_fsm8.fused_pass, f"{'packed' if packed else 'unpacked'} m={m}, the same "
                "tile", fused_check(xs, tables, tile.size, lanes, packed)))

    xs, lanes = body_xs(buf)
    k, win = xs.shape[0], tail_window(lanes)
    at = f"untiled, {lanes} lanes x {k} B; lanes {win.start}-{win.stop - 1} compared"
    sx = xs[-min(decode8.SYNC_WINDOW, k):]
    zeros = torch.zeros(lanes, dtype=torch.int32, device=DEV)
    guess = cuda_fsm8.sync_pass(sx, ns, zeros)
    plain, plain_ms = timed(lambda: cuda_fsm8.sync_pass_plain(sx[:, win], ns, zeros[win]))
    out.append((cuda_fsm8.sync_pass, at, (
        max_err(guess[win], plain), kernel_ms(lambda: cuda_fsm8.sync_pass(sx, ns, zeros), 3, 3),
        plain_ms, bound_ms(sx, ns, zeros, guess), None)))
    entries = torch.cat([zeros[:1], guess[:-1]])
    sk, xk = cuda_fsm8.emit_pass(xs, ns, entries)
    (sp, xp), plain_ms = timed(lambda: cuda_fsm8.emit_pass_plain(xs[:, win], ns, entries[win]))
    out.append((cuda_fsm8.emit_pass, f"{at} ({sk.numel()} states)", (
        max(max_err(sk[:, win], sp), max_err(xk[win], xp)),
        kernel_ms(lambda: cuda_fsm8.emit_pass(xs, ns, entries), 3, 3), plain_ms,
        bound_ms(xs, ns, entries, sk, xk), None)))
    del sk, sp
    if lanes * decode8.DEFAULT_CHUNK_BYTES < pdist._INT32_SAFE_BODY:
        args = (xs, tables.fused, entries, m, tables.mt, tables.s, packed, buf.size)
        vk, xk = cuda_fsm8.fused_pass(*args)
        (vp, xp), plain_ms = timed(lambda: cuda_fsm8.fused_pass_plain(
            xs[:, win], tables.fused, entries[win], m, tables.mt, tables.s, packed,
            max(0, buf.size - win.start * k)))
        out.append((cuda_fsm8.fused_pass, f"the sharded decode's, {at}", (
            fused_err(vk[..., win], xk[win], vp, xp, m, packed),
            kernel_ms(lambda: cuda_fsm8.fused_pass(*args), 3, 3), plain_ms,
            bound_ms(xs, tables.fused, entries, vk, xk), None)))
        del vk, vp
    del xs

    res, pk = pack_check(data[: TILE_BLOCKS * DEFAULT_BLOCK_BYTES], blob)
    out.append((cuda_pack.pack_blocks, f"the first {TILE_BLOCKS}-block encode tile, whole", res))
    sub = plane_sub_for(DEFAULT_BLOCK_BYTES)
    cap = plane_cap_g(int(grouped_counts_plane(pk[1]).max()), DEFAULT_BLOCK_BYTES)
    out.append((cuda_compact.compact_rows, f"that tile's words, sub={sub} cap={cap}",
                compact_check(pk[0].view(torch.int32).t().contiguous(),
                              pk[1].t().contiguous(), sub, cap)))
    del pk
    out.append((cuda_stitch.stitch_tile, "that tile's plane, shift 0",
                stitch_check(data[: TILE_BLOCKS * DEFAULT_BLOCK_BYTES], blob)))
    res, label = tables_check(blob)
    out.append((cuda_tables.fsm_tables, f"the one-pass tables of its code table: {label}", res))

    codes, lengths = code_tensors_for(blob, DEV)
    blocks, valid = ab.encode_blocks(data, DEFAULT_BLOCK_BYTES, DEV)
    n, win = blocks.shape[0], tail_window(blocks.shape[0])
    at = f"the sharded compress's {n} blocks; blocks {win.start}-{win.stop - 1} compared"
    pk = cuda_pack.pack_blocks(blocks, valid, codes, lengths)
    pp, plain_ms = timed(lambda: cuda_pack.pack_blocks_plain(blocks[win], valid[win], codes,
                                                             lengths))
    err = ab.pack_err([t[win] for t in pk], pp)
    require(err == 0, f"pack_blocks and its plain version differ (max |err| {err})")
    out.append((cuda_pack.pack_blocks, f"{at} ({pk[0].numel()} words)", (
        err, kernel_ms(lambda: cuda_pack.pack_blocks(blocks, valid, codes, lengths), 3, 3),
        plain_ms, bound_ms(blocks, valid, codes, lengths, *pk), None)))
    wk, ek = pk[0].view(torch.int32).t().contiguous(), pk[1].t().contiguous()
    cap = plane_cap_g(int(grouped_counts_plane(pk[1]).max()), DEFAULT_BLOCK_BYTES)
    del pk, blocks
    ck = cuda_compact.compact_rows(wk, ek, sub, cap)
    cp, plain_ms = timed(lambda: cuda_compact.compact_rows_plain(wk[:, win], ek[:, win], sub,
                                                                 cap))
    out.append((cuda_compact.compact_rows, f"{at}, its words, sub={sub} cap={cap}", (
        max(max_err(ck[0][:, win], cp[0]), max_err(ck[1][:, win], cp[1])),
        kernel_ms(lambda: cuda_compact.compact_rows(wk, ek, sub, cap), 3, 3), plain_ms,
        bound_ms(wk, ek, *ck), None)))
    return out


# --- every kernel held against its plain version at the shapes a path gives it ---

def _sync_err(a, out, win):
    plain = cuda_fsm8.sync_pass_plain(a["xs"][:, win], a["next_state"], a["entries"][win])
    return max_err(out[win], plain)


def _emit_err(a, out, win):
    sp, xp = cuda_fsm8.emit_pass_plain(a["xs"][:, win], a["next_state"], a["entries"][win])
    return max(max_err(out[0][:, win], sp), max_err(out[1][win], xp))


def _fused_err(a, out, win):
    xs, n_valid = a["xs"], a["n_valid"]
    if n_valid is not None:  # lane-linear: the window's lanes start win.start * K bytes in
        n_valid = max(0, n_valid - win.start * xs.shape[0])
    vp, xp = cuda_fsm8.fused_pass_plain(xs[:, win], a["t_fused"], a["entries"][win], a["m"],
                                        a["mt"], a["s"], a["packed"], n_valid)
    return fused_err(out[0][..., win], out[1][win], vp, xp, a["m"], a["packed"])


def _expand_err(plain):
    def err(a, out, win):
        table = a["t_split"] if "t_split" in a else a["t_exp"]
        extra = (a["mt"],) if "t_split" in a else ()
        vp = plain(a["xs"][:, win], a["states"][:, win], table, a["m"], *extra)
        vk = out[..., win]
        j = torch.arange(a["m"], device=vk.device)[None, :, None]
        return max(max_err(vk[:, 0], vp[:, 0]),
                   max_err(vk[:, 1:], vp[:, 1:], j < (vp[:, 0] & 15)[:, None, :]))
    return err


def _pack_err(a, out, win):
    pp = cuda_pack.pack_blocks_plain(a["blocks"][win], a["valid"][win], a["codes"],
                                     a["lengths"])
    err = ab.pack_err([t[win] for t in out], pp)
    require(err == 0, f"pack_blocks and its plain version differ (max |err| {err})")
    return err


def _compact_err(a, out, win):
    cp = cuda_compact.compact_rows_plain(a["wk"][:, win], a["ek"][:, win], a["sub"], a["cap"])
    return max(max_err(out[0][:, win], cp[0]), max_err(out[1][:, win], cp[1]))


def _counts_err(a, out, win):
    tp, ip = cuda_symbols.symbol_counts_plain(a["words"][:, win], a["m"])
    return max(max_err(out[0][win], tp), max_err(out[1][win], ip))


def _write_err(a, out, win):
    """The window's lanes' symbols, from the end of the lane before it."""
    ends, mini = a["ends"], a["mini_tot"]
    lo = int(ends[win.start - 1]) if win.start else 0
    plain = cuda_symbols.write_symbols_plain(
        a["items"][:, win], ends[win] - lo, a["total"] - lo, a["m"],
        None if mini is None else mini[:, win], a["cap"])
    return max_err(out[lo:], plain)


def _tables_err(a, out, win):
    """Both tables whole: the trie is the kernel's only input."""
    ns, fused = cuda_tables.fsm_tables_plain(a["edges"], a["width"], a["s"], a["mt"],
                                             out[0].device)
    return max(max_err(out[0], ns), max_err(out[1], fused))


def _stitch_err(a, out, win):
    """The whole stream: a window's bytes depend on every lane before it."""
    return max_err(out, cuda_stitch.stitch_tile_plain(
        a["plane"], a["counts"], a["acc"], a["nbits"], a["shift"], a["n_words"], a["carry"]))


# kernel -> (its comparison with the plain version on a window of its lanes
# or blocks, the argument whose lanes (dim 1) or blocks (dim 0) are windowed)
SHADOW = {
    cuda_fsm8.sync_pass: (_sync_err, ("xs", 1)),
    cuda_fsm8.emit_pass: (_emit_err, ("xs", 1)),
    cuda_fsm8.fused_pass: (_fused_err, ("xs", 1)),
    cuda_fsm8.expand_pass_split: (_expand_err(cuda_fsm8.expand_pass_split_plain), ("xs", 1)),
    cuda_fsm8.expand_pass: (_expand_err(cuda_fsm8.expand_pass_plain), ("xs", 1)),
    cuda_pack.pack_blocks: (_pack_err, ("blocks", 0)),
    cuda_compact.compact_rows: (_compact_err, ("wk", 1)),
    cuda_symbols.symbol_counts: (_counts_err, ("words", 1)),
    cuda_symbols.write_symbols: (_write_err, ("items", 1)),
    cuda_stitch.stitch_tile: (_stitch_err, ("plane", 1)),
    cuda_tables.fsm_tables: (_tables_err, ("edges", 0)),
}


class _Checked:
    """A kernel wrapper that, after each call, runs its plain version on the
    same inputs (the last LARGE_WINDOW lanes or blocks) and compares;
    attributes (the launch counts) are the wrapper's own."""

    def __init__(self, fn, record):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_record", record)
        object.__setattr__(self, "_sig", inspect.signature(fn))

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        a = bound.arguments
        compare, (key, dim) = SHADOW[self._fn]
        n = a[key].shape[dim]
        win = tail_window(n)
        err = compare(a, out, win)
        shape = tuple(a[key].shape)
        self._record(self._fn, err,
                     shape if win.start == 0 else (*shape, f"last {win.stop - win.start}"))
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def checked_kernels():
    """Inside the block every kernel wrapper, wherever the port's modules
    bind it, is a :class:`_Checked` one, and the launches leave the counts
    as they were (``uncounted``). Yields {kernel: [calls, max error, the
    shapes compared]}; a difference raises in the thread that met it."""
    lock = threading.Lock()
    seen = {fn: [0, 0, set()] for fn in KERNELS}

    def record(fn, err, shape):
        with lock:
            s = seen[fn]
            s[0], s[1] = s[0] + 1, max(s[1], err)
            s[2].add(shape)

    patched = []
    for mod in [m for name, m in list(sys.modules.items())
                if name.split(".")[0] == "entreepy_tpu_torch" and m is not None]:
        for attr, value in list(vars(mod).items()):
            if any(value is fn for fn in KERNELS):
                patched.append((mod, attr, value))
                setattr(mod, attr, _Checked(value, record))
    try:
        with uncounted():
            yield seen
    finally:
        for mod, attr, value in patched:
            setattr(mod, attr, value)


def shadow_checked(label: str, calls, merge, card: str) -> None:
    """Each (name, fn, want) of ``calls`` once more, exact, with every kernel
    it launches held against its plain version at the shapes the call gives
    it (``checked_kernels``); prints each kernel's calls, shapes and error
    and merges the error into the JSON line's."""
    t0 = time.perf_counter()
    with checked_kernels() as seen:
        for name, fn, want in calls:
            require(fn() == want, f"{label} {name}: result differs under the kernel checks")
    for fn, (n, err, shapes) in seen.items():
        if n:
            merge(fn, (err, None, None, None, None))
            print(f"[multicard] {label}: {KERNELS[fn][0]} against its plain version in {n} "
                  f"calls, max_abs_err {err}, shapes {sorted(shapes, key=str)} | {card}",
                  flush=True)
    print(f"[multicard] {label}: every launch of the calls held against its plain version, "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)


def launch_counts() -> dict:
    return {fn: fn.launches for fn in KERNELS}


@contextlib.contextmanager
def uncounted():
    """Launches inside the block leave every kernel's counts (in all and
    per card) as they were: a comparison with the plain version is no
    launch of a main path."""
    saved = {fn: (fn.launches, collections.Counter(fn.launches_on)) for fn in KERNELS}
    try:
        yield
    finally:
        for fn, (n, on) in saved.items():
            fn.launches, fn.launches_on = n, on


def print_launches(label: str, before: dict) -> None:
    """The launches of each kernel since ``before`` (one call's count)."""
    print(f"[e2e] {label} launches: {{"
          + ", ".join(f"{KERNELS[f][0]}: {f.launches - n}" for f, n in before.items()
                      if f.launches > n) + "}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_rank(rank: int, world: int, backend: str, cases, routes, port: int,
               out: str) -> None:
    """One rank of a sharded process world (a spawned process): a gloo group
    with every rank on cuda:0, or an NCCL group with rank r on cuda:r
    (``multihost.init`` binds it). The round trips of ``cases`` (name,
    corpus kind, bytes) through ``routes`` with the sharded backend, each
    .et equal to the host backend's; writes to ``out`` its fixed-point
    passes, times (median of 3 warm calls), stage ms of the exchanges,
    kernel launches, host fallbacks, its card's peak device memory and its
    peak RSS."""
    multihost.init(backend=backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                   rank=rank)
    try:
        with rss_peak() as rss:
            device = "cuda:0" if backend == "gloo" else None
            mesh = make_mesh(device=device)
            require(mesh.world == world and mesh.group is not None, f"world-{world} mesh {mesh}")
            require(torch.cuda.current_device() == mesh.device.index or backend == "gloo",
                    f"rank {rank} bound to cuda:{torch.cuda.current_device()}, not {mesh.device}")
            torch.cuda.reset_peak_memory_stats(mesh.device)
            res = {"device": str(mesh.device)}
            for name, kind, n in cases:
                data = corpus(kind, n)
                blob = et.compress(data, backend="sharded", device=device)
                require(blob == et.compress(data, backend="host"),
                        f"world {world} {name}: .et differs from the host backend's")
                res[name] = {"compress_ms": wall_ms(
                    lambda: et.compress(data, backend="sharded", device=device), 3)}
                with trace.record_stages() as stages:
                    et.compress(data, backend="sharded", device=device)
                res[name]["compress_stages"] = stages
                for route in routes:
                    require(et.decompress(blob, backend="sharded", device=device,
                                          expand=route) == data,
                            f"world {world} {name} expand={route}: round trip differs")
                    passes = pdist.last_decode_stats["passes"]
                    ms = wall_ms(lambda: et.decompress(blob, backend="sharded", device=device,
                                                       expand=route), 3)
                    with trace.record_stages() as stages:
                        et.decompress(blob, backend="sharded", device=device, expand=route)
                    res[name][route] = {"passes": passes, "ms": ms, "stages": stages}
            torch.cuda.synchronize(mesh.device)
            res["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
            res["launches"] = {KERNELS[fn][0]: fn.launches for fn in KERNELS}
            res["host_fallbacks"] = decode8.decode_host.calls
            res["peak_rss"] = rss["bytes"]  # sampled so far: the rank's work is done
        Path(out).write_text(json.dumps(res))
    finally:
        tdist.destroy_process_group()


def run_world(card: str, world: int, backend: str, cases, routes, tag: str,
              timeout: float = WORLD_TIMEOUT_S) -> None:
    """A sharded process world of ``world`` spawned ranks (``world_rank``);
    a rank that fails, or a run past ``timeout`` seconds, fails the smoke."""
    ctx = tmp.get_context("spawn")
    port = free_port()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmpdir:
        outs = [Path(tmpdir) / f"rank{r}.json" for r in range(world)]
        procs = [ctx.Process(target=world_rank,
                             args=(r, world, backend, cases, routes, port, str(o)))
                 for r, o in enumerate(outs)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        require(not hung, f"world {world}: ranks {hung} did not finish in {timeout} s")
        codes = [p.exitcode for p in procs]
        require(codes == [0] * world, f"world {world}: rank exit codes {codes}")
        ranks = [json.loads(o.read_text()) for o in outs]
    wall = time.perf_counter() - t0
    where = ("on cuda:0" if backend == "gloo"
             else "on " + ", ".join(res["device"] for res in ranks))
    label = f"world {world} ({backend}, {world} ranks {where})"
    for r, res in enumerate(ranks):
        require(res["host_fallbacks"] == 0, f"{label} rank {r} fell back to the host decoder")
        idle = [k for k in WORLD_KERNELS if res["launches"][k] == 0]
        require(not idle, f"{label} rank {r} never launched {idle}")
        print(f"{tag} {label} rank {r} on {res['device']}: kernel launches {res['launches']}, "
              f"peak device memory {res['peak_bytes']} B, peak RSS {res['peak_rss']} B | {card}")
    for name, _, _ in cases:
        for route in routes:
            got = [res[name][route] for res in ranks]
            passes = [g["passes"] for g in got]
            require(len(set(passes)) == 1, f"{label} {name} {route}: passes differ {passes}")
            print(f"{tag} {label} {name} expand={route}: round trip ok, .et == host, "
                  f"fixed-point passes per rank {passes}, decompress ms per rank "
                  f"{[round(g['ms'], 3) for g in got]}, stage ms per rank "
                  f"{exchange_stages([g['stages'] for g in got])} | compress ms per rank "
                  f"{[round(res[name]['compress_ms'], 3) for res in ranks]}, stage ms per rank "
                  f"{exchange_stages([res[name]['compress_stages'] for res in ranks])} "
                  f"| warm median of 3 | {card}")
    print(f"{tag} {label}: every rank exit 0 in {wall:.1f} s (spawn included) | {card}")


# Stages that time the ranks' exchanges (and the host work beside them)
EXCHANGE_STAGES = ("allgather_exits", "gather_symbols", "gather_payload", "host_extract",
                   "host_expand", "host_validate", "host_join")
# The host tail of a sharded call, which a local mesh's caller runs once
HOST_TAIL_STAGES = ("stitch", "serialize", "host_validate", "host_join", "host_check_bits")


def exchange_stages(per_rank: list[dict]) -> dict:
    """{stage: [ms per rank]} of EXCHANGE_STAGES that the ranks recorded."""
    return {k: [round(st[k], 3) for st in per_rank] for k in EXCHANGE_STAGES
            if all(k in st for st in per_rank)}


# --- [multicard]: the sharded backend over several ranks in one process ---

def max_rss() -> int:
    """This process's peak RSS (``ru_maxrss``: the smoke is no spawned child)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def card_peaks(cards, fn):
    """(fn(), its wall ms, {card index: its peak device memory above what
    that card held before the call})."""
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
    base = {c: torch.cuda.memory_allocated(c) for c in cards}
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    for c in cards:
        torch.cuda.synchronize(c)
    return out, ms, {c: torch.cuda.max_memory_allocated(c) - base[c] for c in cards}


def exchanged(op: str, stats: dict, world: int) -> list[int]:
    """Per rank of a local mesh's last call: the bytes it read from the
    other ranks card to card, counted from shapes. Compress: the int64
    histogram. Decompress: the int32 exit states of every pass (passes +
    the suffix sync's). Each rank fetches its own payload or symbols, and
    the caller joins them on the host."""
    if op == "compress":
        return [256 * 8 * (world - 1)] * world
    return [(r["passes"] + 1) * 4 * r["lanes"] * (world - 1) for r in stats["ranks"]]


def mesh_op(label: str, op: str, fn, want: bytes, cards, world: int,
            card: str) -> tuple[float, dict]:
    """One call of a local mesh, exact against ``want``, with its per-card
    peaks, then a recorded call for the ranks' stages; prints both with the
    bytes each rank read from the others. Returns (wall ms, peaks)."""
    got, ms, peaks = card_peaks(cards, fn)
    require(got == want, f"{label} {op}: result differs")
    with trace.record_stages() as caller:
        fn()
    stats = last_stats(op)
    ranks = stats["ranks"]
    require(len(ranks) == world, f"{label} {op}: {len(ranks)} ranks, want {world}")
    line = f"[multicard] {label} {op}: {'.et == host' if op == 'compress' else 'exact'}, " \
           f"{ms:.3f} ms one call, peak device B per card {peaks}"
    if op != "compress":
        passes = [r["passes"] for r in ranks]
        require(len(set(passes)) == 1, f"{label} {op}: passes differ {passes}")
        line += f", fixed-point passes per rank {passes}"
    tail = {k: round(v, 3) for k, v in caller.items() if k in HOST_TAIL_STAGES}
    print(line + f", stage ms per rank {exchange_stages([r['stages'] for r in ranks])}, host "
          f"tail ms (once) {tail}, bytes read card to card from the other ranks per rank "
          f"{exchanged(op, stats, world)} | {card}", flush=True)
    return ms, peaks


def mesh_calls(mesh, data_of: dict, blobs: dict, cases) -> list:
    """(name, op, the local mesh's call, the device backend's same call,
    its result) of each op of ``cases`` (name, routes): the compress, then
    the decompress through each route; ``mesh`` a Mesh, or None for
    ``backend="sharded"`` through the public API."""
    calls = []
    for name, routes in cases:
        data, blob = data_of[name], blobs[name]
        calls.append((name, "compress",
                      (lambda d=data: et.compress(d, backend="sharded")) if mesh is None
                      else (lambda d=data: pdist.compress_sharded(d, mesh)),
                      lambda d=data: et.compress(d, backend="device"), blob))
        for op in routes:
            calls.append((name, op,
                          (lambda b=blob, op=op: et.decompress(b, backend="sharded", expand=op))
                          if mesh is None else
                          (lambda b=blob, op=op: pdist.decompress_sharded(b, mesh, expand=op)),
                          lambda b=blob, op=op: et.decompress(b, backend="device", expand=op),
                          data))
    return calls


def mesh_round_trips(label: str, mesh, cards, data_of: dict, blobs: dict, cases,
                     card: str) -> None:
    """The ops of ``mesh_calls`` over a local mesh, exact, each op's wall
    beside the device backend's same call (warm median of 3 below 20 MB,
    else one call; the device calls outside the path's counts)."""
    world = len(cards) if mesh is None else mesh.world
    for name, op, fn, dev_fn, want in mesh_calls(mesh, data_of, blobs, cases):
        ms, _ = mesh_op(f"{label} {name}", op, fn, want, cards, world, card)
        iters = 3 if len(data_of[name]) < 20 * MB else 1
        warm = wall_ms(fn, iters) if iters > 1 else ms
        with uncounted():
            dev = wall_ms(dev_fn, iters)
        print(f"[multicard] {label} {name} {op}: local mesh {warm:.3f} ms, device backend "
              f"{dev:.3f} ms ({'warm median of 3' if iters > 1 else 'one call each'}) "
              f"| {card}", flush=True)


def last_stats(op: str) -> dict:
    """The sharded codec's stats of its last ``op`` ("compress", else a
    decompress route)."""
    return pdist.last_encode_stats if op == "compress" else pdist.last_decode_stats


def multicard_large(cards, card: str, merge) -> None:
    """[large]'s two configurations over the local mesh of ``cards``
    (``backend="sharded"``): compress, then decompress through each of
    MC_LARGE_ROUTES, each exact, with its per-card peaks; the device
    backend's same calls beside, once each, outside the path's counts; the
    process's peak RSS. Then each op once more with every kernel held
    against its plain version at the rank slices' shapes
    (``shadow_checked``)."""
    for cfg in lg.CONFIGS:
        t0 = time.perf_counter()
        data = make_corpus(cfg.kind, cfg.n_bytes)
        ref = et.compress(data, backend="host")
        body = len(ref) - parse_header(ref).body_start
        lanes = -(-body // decode8.DEFAULT_CHUNK_BYTES)
        per_rank = -(-lanes // len(cards))
        print(f"[multicard] {cfg.name}: {len(data)} B, body {body} B, {lanes} lanes, {per_rank} "
              f"per rank of {len(cards)} ({per_rank * decode8.DEFAULT_CHUNK_BYTES} B each, "
              f"untiled below {pdist._INT32_SAFE_BODY}) | {card}", flush=True)
        label = f"local mesh of {len(cards)} cards {cfg.name}"
        walls, calls = {}, []
        for op in ("compress", *MC_LARGE_ROUTES):
            if op == "compress":
                fn, dev_fn, want = (lambda: et.compress(data, backend="sharded"),
                                    lambda: et.compress(data, backend="device"), ref)
            else:  # op bound now: the kernel checks call fn again after the loop
                fn, dev_fn, want = (
                    lambda op=op: et.decompress(ref, backend="sharded", expand=op),
                    lambda op=op: et.decompress(ref, backend="device", expand=op), data)
            got, ms, peaks = card_peaks(cards, fn)
            require(got == want, f"{label} {op}: result differs")
            del got
            stats = last_stats(op)
            if op != "compress":
                passes = [r["passes"] for r in stats["ranks"]]
                require(len(set(passes)) == 1 and "passes" in stats,
                        f"{label} {op}: passes {passes}, not the untiled rank decode")
            with uncounted():
                dev_got, dev_ms, dev_peaks = card_peaks([0], dev_fn)
            require(dev_got == want, f"{cfg.name} device {op}: result differs")
            del dev_got
            walls[op] = (ms, dev_ms)
            calls.append((op, fn, want))
            print(f"[multicard] {label} {op}: exact, {ms:.1f} ms ({cfg.n_bytes / ms / 1e3:.1f} "
                  f"MB/s), peak device B per card {peaks}"
                  + (f", fixed-point passes per rank {passes}" if op != "compress" else "")
                  + f", bytes read card to card from the other ranks per rank "
                  f"{exchanged(op, stats, len(cards))} | device backend "
                  f"{dev_ms:.1f} ms, peak {dev_peaks[0]} B | peak RSS {max_rss()} B | {card}",
                  flush=True)
        shadow_checked(label, calls, merge, card)
        del data, ref, calls
        gc.collect()
        for c in cards:
            with torch.cuda.device(c):
                torch.cuda.empty_cache()
        print(f"[multicard] {cfg.name}: {time.perf_counter() - t0:.1f} s | {card}", flush=True)


def card_kernel_checks(text: bytes, blob: bytes, cards, show, merge) -> None:
    """On each card, each kernel against its plain version at the 5.2 MB
    text's shapes (the [kernels] helpers, on that card as the current
    device), outside the path's counts; every error merged into the JSON
    line's."""
    for c in cards:
        t0 = time.perf_counter()
        with torch.cuda.device(c), uncounted():
            xs, tables, n_valid, lanes = body_cols(text)
            checks = [(cuda_fsm8.sync_pass, sync_check(xs, tables.next_state)),
                      (cuda_fsm8.fused_pass, fused_check(xs, tables, n_valid, lanes, True)),
                      (cuda_fsm8.emit_pass, emit_check(xs, tables.next_state))]
            res, pk = pack_check(text, blob)
            checks.append((cuda_pack.pack_blocks, res))
            sub = plane_sub_for(DEFAULT_BLOCK_BYTES)
            cap = plane_cap_g(int(grouped_counts_plane(pk[1]).max()), DEFAULT_BLOCK_BYTES)
            checks.append((cuda_compact.compact_rows, compact_check(
                pk[0].view(torch.int32).t().contiguous(), pk[1].t().contiguous(), sub, cap)))
            for fn, split in ((cuda_fsm8.expand_pass_split, True), (cuda_fsm8.expand_pass, False)):
                res, cres, _, _ = expand_check(blob, split)
                checks += [(fn, res), (cuda_compact.compact_rows, cres)]
            count, write, _ = symbols_check(*onepass_items(xs, tables, n_valid, lanes))
            checks += list(zip(SYMBOLS, (count, write)))
            checks.append((cuda_stitch.stitch_tile, stitch_check(text, blob, 5, 5)))
            checks.append((cuda_tables.fsm_tables, tables_check(blob)[0]))
            del xs, tables, pk
            torch.cuda.empty_cache()
        for fn, res in checks:
            merge(fn, res)
            show(f"cuda:{c} {KERNELS[fn][0]}, text 5.2 MB shapes", res, "multicard")
        print(f"[multicard] cuda:{c}: all eleven kernels equal their plain versions, "
              f"{time.perf_counter() - t0:.1f} s | {card_of(c)}", flush=True)


def card_of(c: int) -> str:
    """nvidia-smi's ``name, power.limit`` of card ``c``."""
    return subprocess.run(
        ["nvidia-smi", f"--id={c}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def multicard_phase(card: str, data_of: dict, blobs: dict, show, merge,
                    all_card_checks: bool = False) -> dict:
    """[multicard] (see the module docstring): run through ``run_path`` with
    every kernel but the stitch; returns the path's launch counts. Then each local
    mesh's calls once more with every kernel held against its plain version
    at the rank slices' shapes (at [large]'s configurations inside the
    path's run, outside its counts). ``all_card_checks``: also hold the
    kernels against their plain versions at the 5.2 MB text's shapes on
    every card, one card included (the phase alone has no [kernels])."""
    phase_t0 = time.perf_counter()
    n = min(torch.cuda.device_count(), MC_MAX_CARDS)
    cards = list(range(n))
    shared = make_mesh(devices=["cuda:0", "cuda:0"])
    mesh = None if n == torch.cuda.device_count() else make_mesh(n)
    per_card = {}

    def drive():
        mesh_round_trips("local mesh of 2 ranks on cuda:0", shared, [0], data_of, blobs,
                         MC_CASES, card)
        if n < 2:
            print(f"[multicard] the cross-card half needs 2 or more cards: this process sees "
                  f"{torch.cuda.device_count()} | {card}", flush=True)
            return
        for c in cards:
            print(f"[multicard] cuda:{c}: {card_of(c)}", flush=True)
        if mesh is None:
            for name, want in (("text 5.2 MB", "host"), ("text 100 MB", "sharded")):
                picks = (api._pick_backend(None, len(data_of[name])),
                         api._pick_backend(None, len(blobs[name])))
                require(picks == (want, want), f"auto picks {picks} at {name}, want {want}")
            require(et.decompress(blobs["text 100 MB"]) == data_of["text 100 MB"],
                    "auto (sharded) text 100 MB round trip differs")
            require(len(pdist.last_decode_stats["ranks"]) == n, "auto's mesh is not every card")
            print(f"[multicard] auto picks host at 5.2 MB and sharded at 100 MB over {n} cards; "
                  f"its 100 MB round trip exact | {card}", flush=True)
        mesh_round_trips(f"local mesh of {n} cards", mesh, cards, data_of, blobs, MC_CASES,
                         card)
        multicard_large(cards, card, merge)
        os.environ.setdefault("NCCL_DEBUG", "WARN")
        for world in sorted({2, n}):
            run_world(card, world, "nccl", NCCL_CASES, NCCL_ROUTES, "[multicard]",
                      NCCL_TIMEOUT_S)

    counts = run_path("multicard", drive)
    for fn in KERNELS:
        per_card[KERNELS[fn][0]] = {f"cuda:{c}": fn.launches_on[c] for c in sorted(fn.launches_on)}
    print(f"[multicard] local-mesh launches per card: {per_card} | {card}", flush=True)
    idle = [c for c in cards if not any(v.get(f"cuda:{c}", 0) for v in per_card.values())]
    require(not idle, f"[multicard] cards {idle} launched no kernel")
    if n >= 2 or all_card_checks:
        card_kernel_checks(data_of["text 5.2 MB"], blobs["text 5.2 MB"], cards, show, merge)
    for label, m in (("local mesh of 2 ranks on cuda:0", shared),
                     *([(f"local mesh of {n} cards", mesh)] if n >= 2 else [])):
        shadow_checked(label, [(f"{name} {op}", fn, want) for name, op, fn, _, want
                               in mesh_calls(m, data_of, blobs, MC_CASES)], merge, card)
    print(f"[multicard] phase {time.perf_counter() - phase_t0:.1f} s, peak RSS {max_rss()} B "
          f"| {card}", flush=True)
    return counts


def install_phase(card: str, text: bytes, text_blob: bytes) -> None:
    """[install]: the wheel built from a copy of the packaging files, its
    bundled libraries required, installed with ``pip --target`` and driven
    with no compiler in reach (``tools/installed_check.py``): the 5.2 MB
    text through every device route, every kernel launched from the bundled
    library; the console script's c/d of the golden file; nothing written
    to the fresh cache or beside the install."""
    phase_t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmpdir:
        work = Path(tmpdir)
        t0 = time.perf_counter()
        wheel = ic.build_wheel(ROOT, work)
        wheel_s = time.perf_counter() - t0
        name = _build.library_name()
        with zipfile.ZipFile(wheel) as z:
            missing = {f"entreepy_tpu_torch/{name}", "entreepy_tpu_torch/runtime/_native_ext.so"
                       } - set(z.namelist())
        require(not missing, f"[install] the wheel lacks {sorted(missing)}")
        site, cache, cwd = work / "site", work / "cache", work / "cwd"
        ic.install(wheel, site)
        cache.mkdir()
        cwd.mkdir()
        (work / "text.txt").write_bytes(text)
        t0 = time.perf_counter()
        rep = ic.drive(site, cache, cwd, work / "text.txt", work / "out")
        run_s = time.perf_counter() - t0
        pkg = site / "entreepy_tpu_torch"
        loaded = (rep["package"], rep["kernels"], rep["runtime"])
        require(loaded == (str(pkg / "__init__.py"), str(pkg / name),
                           str(pkg / "runtime" / "_native_ext.so")),
                f"[install] loaded {loaded}, not the installed package's bundled libraries")
        require(rep["modules"] == [], f"[install] the installed port imported {rep['modules']}")
        require(all(rep["decoded"].values()), f"[install] round trips {rep['decoded']}")
        for et_name in ("host.et", "device.et"):
            require((work / "out" / et_name).read_bytes() == text_blob,
                    f"[install] {et_name} differs from the checkout's host backend's")
        idle = [k for k in (KERNELS[fn][0] for fn in KERNELS) if rep["launches"].get(k, 0) == 0]
        require(not idle, f"[install] never launched {idle}")
        print(f"[install] wheel {wheel.name}: {wheel.stat().st_size} B, built in {wheel_s:.1f} s "
              f"(pip wheel, nvcc and both g++ builds), bundles {name} and the portable "
              f"runtime/_native_ext.so | {card}")
        print(f"[install] installed run (no nvcc or g++ on PATH, CUDA_HOME at nothing, empty "
              f"cwd, fresh XDG_CACHE_HOME) in {run_s:.1f} s: text 5.2 MB .et == host, round "
              f"trips exact {rep['decoded']}, kernels from {rep['kernels']}, launches "
              f"{rep['launches']} | {card}")
        cli_dir = work / "cli"
        cli_dir.mkdir()
        golden = (DATA / "nice.shakespeare.txt").read_bytes()
        (cli_dir / "m.txt").write_bytes(golden)
        for args in (["c", "m.txt"], ["d", "m.txt.et"]):
            r = subprocess.run([str(site / "bin" / "entreepy-torch"), "--backend", "device",
                                *args], cwd=cli_dir, env=ic.bare_env(site, cache),
                               capture_output=True, text=True, timeout=300)
            require(r.returncode == 0, f"[install] entreepy-torch {args}: exit {r.returncode}\n"
                                       f"{r.stdout}\n{r.stderr}")
        require((cli_dir / "m.txt.et").read_bytes() == (DATA / "nice.shakespeare.et").read_bytes(),
                "[install] entreepy-torch c: .et differs from the golden file")
        require((cli_dir / "decoded_m.txt").read_bytes() == golden,
                "[install] entreepy-torch d: decoded file differs")
        written = sorted(str(p) for p in cache.rglob("*"))
        require(not written, f"[install] the installed port wrote into the cache: {written}")
        require(not (site / "build").exists(), "[install] the installed port built beside itself")
    print(f"[install] entreepy-torch --backend device c/d of the golden file: exit 0, .et == "
          f"golden, decoded == input; the fresh cache empty, no {site.name}/build; phase "
          f"{time.perf_counter() - phase_t0:.1f} s | {card}")
    ms = {op: wall_ms(fn, 5) for op, fn in (
        ("compress", lambda: et.compress(text, backend="host")),
        ("decompress", lambda: et.decompress(text_blob, backend="host")))}
    own = Path(runtime._load()._name).name
    print(f"[install] host codec, text 5.2 MB, ms (warm median of 5): bundled portable "
          f"_native_ext.so compress {rep['host_ms']['compress']:.3f}, decompress "
          f"{rep['host_ms']['decompress']:.3f} | the checkout's -march=native {own} compress "
          f"{ms['compress']:.3f}, decompress {ms['decompress']:.3f} | {card}")


# The [bench] phase: the port's bench, each command in a process of its own.
BENCH_COMMANDS = (
    ("headline", ()),
    ("scale 5 MB", ("scale", "--sizes", "5", "--corpora", "text,random,skewed,runheavy",
                    "--backends", "auto,host,device", "--routes", "onepass,split,fused,host",
                    "--stages")),
    ("scale 100 MB", ("scale", "--sizes", "100", "--corpora", "text",
                      "--backends", "auto,host,device")),
    ("weak", ("weak", "--worlds", "1,2", "--per-rank-mb", "2")),
)
BENCH_TIMEOUT_S = 600
BENCH_PROBE = ("cuda_full_ms", "cuda_pass_ms", "cuda_decode_pass_MBps", "cuda_fused_pass_ms",
               "cuda_pack_pass_ms", "cuda_pack_MBps", "cuda_decode_e2e_ms",
               "cuda_decode_e2e_MBps", "cuda_encode_e2e_ms", "cuda_encode_e2e_MBps",
               "cuda_pass_bound_pct", "cuda_fused_pass_bound_pct", "cuda_pack_pass_bound_pct")


def _stats(s: dict) -> str:
    return f"{s['median_ms']:.3f} ms ({s['min_ms']:.3f}-{s['max_ms']:.3f}, n {s['n']})"


def bench_headline(line: dict, card: str) -> None:
    """The headline line: bench.py's keys, every row exact, the probe's
    figures present and positive, each bound share at most 100 %, all seven
    kernels launched by its device rows."""
    require(line.get("metric") == "decode_throughput_5MB" and line.get("unit") == "MB/s"
            and line["value"] > 0 and line["vs_baseline"] > 0, f"[bench] headline {line}")
    require(line["device"]["platform"] == "gpu"
            and line["device"]["kind"] == torch.cuda.get_device_name(0),
            f"[bench] headline device {line['device']}")
    bad = [r for r in line["rows"] if not r["ok"]]
    require(not bad, f"[bench] headline rows not exact: {bad}")
    missing = [k for k in BENCH_PROBE if not line.get(k, 0) > 0]
    require(not missing, f"[bench] headline probe fields missing or not positive: {missing}")
    over = {k: line[k] for k in BENCH_PROBE if k.endswith("_bound_pct") and line[k] > 100}
    require(not over, f"[bench] bound shares above 100 %: {over}")
    idle = [k for k, n in line["launches"].items() if n == 0]
    require(not idle and len(line["launches"]) == len(KERNELS),
            f"[bench] headline rows never launched {idle}")
    print(f"[bench] headline: {line['value']:.3f} MB/s decode through auto "
          f"({line['auto_backend']}; best of {line['headline_calls']['decompress']['n']}), "
          f"vs_baseline {line['vs_baseline']:.1f}, ratio {line['ratio']:.4f}, encode "
          f"{line['encode_MBps']:.3f} MB/s | {card}")
    for r in line["rows"]:
        print(f"[bench] headline row {r['backend']} {r['op']}"
              + (f" expand={r['expand']}" if r["expand"] else "")
              + f": {_stats(r)}, {r['MBps']:.3f} MB/s, peak {r['peak_bytes']} B | {card}")
    print("[bench] headline probe: " + ", ".join(f"{k} {line[k]:.6g}" for k in BENCH_PROBE)
          + f" | {card}")
    print(f"[bench] headline device rows' launches: {line['launches']} | {card}")


def bench_scale(rows: list[dict], label: str, card: str) -> None:
    """Every row's .et equal to the host backend's and round trip exact;
    the device rows of all routes launch all eleven kernels."""
    bad = [(r["corpus"], r["backend"], r["route"]) for r in rows
           if not (r["et_equals_host"] and r["round_trip"])]
    require(not bad, f"[bench] {label}: rows not exact: {bad}")
    launched = {k: sum(r["launches"][k] for r in rows) for k in rows[0]["launches"]}
    routes = {r["route"] for r in rows if r["backend"] == "device"}
    if routes == set(decode8.EXPAND_MODES):
        idle = [k for k, n in launched.items() if n == 0]
        require(not idle, f"[bench] {label}: the device rows never launched {idle}")
    for r in rows:
        print(f"[bench] {label} {r['corpus']} {r['bytes']} B {r['backend']}"
              + (f" expand={r['route']}" if r["route"] else "")
              + (f" (auto picked {r['picked']})" if "picked" in r else "")
              + f": ratio {r['ratio']:.4f}, compress {_stats(r['encode'])} "
              f"{r['encode_MBps']:.3f} MB/s peak {r['encode']['peak_bytes']} B, decompress "
              f"{_stats(r['decode'])} {r['decode_MBps']:.3f} MB/s peak "
              f"{r['decode']['peak_bytes']} B | {card}")
        for op, st in r.get("stages", {}).items():
            if st:
                print(f"[bench] {label} {r['corpus']} {r['backend']} {r['route'] or ''} "
                      f"{op} stages ms: " + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
                      + f" | {card}")
    print(f"[bench] {label}: launches over its rows {launched} | {card}")


def bench_weak(rows: list[dict], card: str) -> None:
    bad = [r["processes"] for r in rows if not (r["et_equals_host"] and r["round_trip"])
           or not (r["weak_eff_encode"] > 0 and r["weak_eff_decode"] > 0)]
    require(len(rows) == 2 and not bad, f"[bench] weak: worlds {bad} of {len(rows)} rows")
    for r in rows:
        print(f"[bench] weak world {r['processes']} ({r['corpus_MB']} MB, pinned "
              f"{r['pinned']}): encode {r['encode_s']:.6f} s, decode {r['decode_s']:.6f} s "
              f"(rank 0, median of {r['decode']['n']}), efficiency encode "
              f"{r['weak_eff_encode']:.4f}, decode {r['weak_eff_decode']:.4f}, rank 0 "
              f"launches {r['launches']} | {card}")


def bench_phase(card: str) -> None:
    """[bench]: ``python -m entreepy_tpu_torch.bench`` as a user runs it, each
    of BENCH_COMMANDS in a process of its own: exit 0, every JSON row's
    correctness fields, the headline's probe, the kernels launched, and no
    module of JAX or of ``entreepy_tpu`` in the bench's process."""
    phase_t0 = time.perf_counter()
    for label, args in BENCH_COMMANDS:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "entreepy_tpu_torch.bench", *args], cwd=ROOT,
                           capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        secs = time.perf_counter() - t0
        require(r.returncode == 0, f"[bench] {label}: exit {r.returncode}\n{r.stdout[-2000:]}"
                                   f"\n{r.stderr[-4000:]}")
        require("[bench] modules of jax or entreepy_tpu imported: []" in r.stderr,
                f"[bench] {label}: the bench imported JAX or entreepy_tpu:\n{r.stderr[-2000:]}")
        rows = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
        require(bool(rows), f"[bench] {label}: no JSON row")
        if label == "headline":
            require(len(rows) == 1, f"[bench] headline: {len(rows)} JSON lines")
            bench_headline(rows[0], card)
        elif label == "weak":
            bench_weak(rows, card)
        else:
            bench_scale(rows, label, card)
        print(f"[bench] {label} (python -m entreepy_tpu_torch.bench {' '.join(args)}): exit 0, "
              f"{len(rows)} JSON rows, no module of JAX or entreepy_tpu, {secs:.1f} s | {card}")
    print(f"[bench] phase {time.perf_counter() - phase_t0:.1f} s | {card}")


def run_path(path: str, drive) -> dict:
    """Drive one main path with every launch count and the host-fallback
    count at 0; require each of the path's kernels launched and no
    fallback. Returns the launch counts of the run."""
    for fn in KERNELS:
        fn.launches = 0
        fn.launches_on.clear()
    decode8.decode_host.calls = 0
    drive()
    counts = launch_counts()
    print(f"[e2e] {path} path launches: "
          f"{{{', '.join(f'{KERNELS[f][0]}: {n}' for f, n in counts.items())}}}"
          f" | self-sync host fallbacks: {decode8.decode_host.calls}")
    missing = [KERNELS[f][0] for f in PATH_KERNELS[path] if counts[f] == 0]
    require(not missing, f"{path} path never launched {missing}")
    require(decode8.decode_host.calls == 0, f"{path} path fell back to the host decoder")
    return counts


def stage_line(label: str, fn, iters: int, card: str) -> None:
    """Median stage times of ``iters`` calls of ``fn`` (record_stages), each
    with its range over the calls."""
    runs = []
    for _ in range(iters):
        with trace.record_stages() as stages:
            fn()
        runs.append(stages)

    def stage(k: str) -> str:
        ms = [r.get(k, 0.0) for r in runs]  # fsm_build: only where its cache missed
        return f"{k} {statistics.median(ms):.3f} ({min(ms):.3f}-{max(ms):.3f})"

    print(f"[stages] {label}, ms (median of {iters}, range): "
          + ", ".join(stage(k) for k in dict.fromkeys(k for r in runs for k in r))
          + f" | {card}")


def _self_device_us(event) -> float:
    value = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if value is None else value


def profile_round_trip(data: bytes, card: str) -> None:
    """The port's profiler (``trace.maybe_profile``: a trace per block into
    $ENTREEPY_PROFILE) over one warm compress and one warm decompress: the
    device's self time (kernels and copies), its share of the profiled call,
    the top device entries."""
    from torch.autograd import DeviceType

    blob = et.compress(data, backend="device")
    with trace.maybe_profile():
        et.decompress(blob, backend="device")  # the profiler's first session pays its start-up
    for direction, fn in (("compress", lambda: et.compress(data, backend="device")),
                          ("decompress", lambda: et.decompress(blob, backend="device"))):
        fn()
        torch.cuda.synchronize()
        with trace.maybe_profile() as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # device-side entries only: a host op's self device time repeats its kernels'
        events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                        key=_self_device_us, reverse=True)
        dev_ms = sum(_self_device_us(e) for e in events) / 1e3
        print(f"[profile] {len(data)} B text {direction}: {wall:.3f} ms under the profiler, "
              f"device self time {dev_ms:.3f} ms, busy share {dev_ms / wall:.4f} | {card}")
        for e in events[:8]:
            print(f"[profile]   {e.key}: {_self_device_us(e) / 1e3:.3f} ms in {e.count} calls")


def finish(card: str, smoke_t0: float, results: dict, launches: dict, **extra) -> int:
    """The no-JAX check, the smoke's time, the JSON line of kernel results
    (and ``extra`` keys), the card, and last the ``{"ok": true, ...}`` line."""
    require("jax" not in sys.modules, "the port imported jax")
    jax_package = [n for n in sys.modules if n.split(".")[0] == "entreepy_tpu"]
    require(not jax_package, f"the port imported the JAX package: {jax_package}")
    print(f"[smoke] {time.perf_counter() - smoke_t0:.1f} s, the build included | {card}")
    print(json.dumps({"kernels": [
        {"name": KERNELS[fn][0], "route": "cuda", "source": KERNELS[fn][1],
         "replaces": KERNELS[fn][2], "launches": launches[fn], "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
         "library_ms": library}
        for fn, (err, ms, plain_ms, bound, library) in results.items()
    ], **extra}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv: list[str]) -> int:
    args = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="ENTREEPY_PROFILE=<dir> adds a torch.profiler trace of a warm 5.2 MB "
               "round trip, written into <dir>",
    )
    args.add_argument("--only", choices=["multicard"],
                      help="run the device and build phases and this phase alone (the "
                           "kernels then checked on every card)")
    args = args.parse_args(argv)
    profile = bool(os.environ.get("ENTREEPY_PROFILE"))
    smoke_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    # 1. device
    print(card)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | capability {cap} | nvcc {_build.nvcc_path()}")
    require(cap == (9, 0), f"want an sm_90 card, got capability {cap}")

    # 2. build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"[build] {so} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    results = {}

    def show(label: str, res, tag: str = "kernels") -> None:
        err, ms, plain_ms, bound, library = res
        print(f"[{tag}] {label}: max_abs_err {err}, kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({bound / ms:.1%} of it), plain {plain_ms:.3f} ms"
              + (f", library {library:.4f} ms" if library is not None else "") + f" | {card}")

    def merge(fn, res) -> None:
        """A kernel checked at further shapes: its worst error counts; the
        JSON line keeps the first timed shapes' times (a check at the main
        path's own shapes, ``shadow_checked``, has none)."""
        first = results.get(fn)
        if first is None or first[1] is None:
            first = res if first is None else (first[0], *res[1:])
        results[fn] = (max(first[0], res[0]), *first[1:])

    if args.only == "multicard":
        data_of = {"text 5.2 MB": corpus("text", 5_200_000),
                   **{f"{kind} 5 MB": corpus(kind, 5 * MB) for kind in ("skewed", "runheavy")},
                   "text 100 MB": corpus("text", 100 * MB)}
        blobs = {name: et.compress(data, backend="host") for name, data in data_of.items()}
        launches = multicard_phase(card, data_of, blobs, show, merge, all_card_checks=True)
        return finish(card, smoke_t0, {fn: results[fn] for fn in KERNELS}, launches)

    # 3. kernels, at the shapes of the 5.2 MB text corpus
    text = corpus("text", 5_200_000)
    xs, tables, n_valid, lanes = body_cols(text)
    print(f"[kernels] text body {n_valid} B: {lanes} lanes x {xs.shape[0]} B, "
          f"m={tables.m} s={tables.s} fused table {tuple(tables.fused.shape)} | {card}")

    results[cuda_fsm8.sync_pass] = sync_check(xs, tables.next_state)
    results[cuda_fsm8.fused_pass] = fused_check(xs, tables, n_valid, lanes, True)
    results[cuda_fsm8.emit_pass] = emit_check(xs, tables.next_state)

    def symbols_rows(label, res):
        """Each launch's check merged and shown, and the launches back to back
        beside the bytes the tile moves at least."""
        count, write, (pair_ms, pair_bound) = res
        for fn, r in zip(SYMBOLS, (count, write)):
            if r is not None:
                merge(fn, r)
                show(f"{KERNELS[fn][0]}, {label}", r)
        print(f"[kernels] symbols kernel, {label}: the launches back to back {pair_ms:.4f} ms, "
              f"bound {pair_bound:.4f} ms ({pair_bound / pair_ms:.1%} of it) | {card}")

    symbols_rows(f"text body ({lanes} lanes, packed, m={tables.m})",
                 symbols_check(*onepass_items(xs, tables, n_valid, lanes)))

    text_blob = et.compress(text, backend="host")
    results[cuda_pack.pack_blocks], pk = pack_check(text, text_blob)
    n_blocks = pk[1].shape[0]

    # the compaction at the encode plane's shapes first (the JSON line's times)
    sub = plane_sub_for(DEFAULT_BLOCK_BYTES)
    cap = plane_cap_g(int(grouped_counts_plane(pk[1]).max()), DEFAULT_BLOCK_BYTES)
    results[cuda_compact.compact_rows] = compact_check(
        pk[0].view(torch.int32).t().contiguous(), pk[1].t().contiguous(), sub, cap)
    print(f"[kernels] pack/compact: {n_blocks} blocks x {DEFAULT_BLOCK_BYTES} B, "
          f"compaction sub={sub} cap={cap}")
    # the stitch of that plane: the body itself at shift 0 (the JSON line's times), then
    # base shifts inside a word with a carried word, as a later tile starts
    del pk
    results[cuda_stitch.stitch_tile] = stitch_check(text, text_blob)
    for shift in (1, 13, 31):
        res = stitch_check(text, text_blob, shift, shift)
        merge(cuda_stitch.stitch_tile, res)
        show(f"stitch_tile, text 5.2 MB as one tile, shift {shift} with a carried word", res)

    # the emit pass with a 256-state table, and the expansions: text (m = 3)
    # first, for the JSON line; the wider tables after. Each expansion's rows
    # then go through the compaction at the two-pass route's shapes.
    blobs = {kind: et.compress(corpus(kind, 5 * MB), backend="host")
             for kind in ("skewed", "runheavy")}
    blobs["text"] = text_blob
    rh_tables, rh_buf = expand_tables_for(blobs["runheavy"], DEV, True)
    res = emit_check(body_xs(rh_buf)[0], rh_tables.next_state)
    merge(cuda_fsm8.emit_pass, res)
    show(f"emit_pass, runheavy body: S={rh_tables.s} next_state "
         f"{tuple(rh_tables.next_state.shape)}", res)
    for fn, split, kinds in ((cuda_fsm8.expand_pass_split, True, ("text", "runheavy")),
                             (cuda_fsm8.expand_pass, False, ("text", "skewed", "runheavy"))):
        for kind in kinds:
            res, cres, t, (sub, cap) = expand_check(blobs[kind], split)
            merge(fn, res)
            merge(cuda_compact.compact_rows, cres)
            show(f"{KERNELS[fn][0]}, {kind} body: m={t.m} S={t.s} table "
                 f"{tuple(t.table.shape)} ({t.table.numel()} B)", res)
            show(f"compact_rows on its rows: sub={sub} cap={cap}", cres)

    sk_xs, sk_tables, sk_valid, sk_lanes = body_cols(corpus("skewed", 5 * MB))
    res = fused_check(sk_xs, sk_tables, sk_valid, sk_lanes, False)
    merge(cuda_fsm8.fused_pass, res)
    symbols_rows(f"skewed body ({sk_lanes} lanes, plane form, m={sk_tables.m})",
                 symbols_check(*onepass_items(sk_xs, sk_tables, sk_valid, sk_lanes)))
    show(f"fused_pass unpacked, skewed body {sk_valid} B: {sk_lanes} lanes, m={sk_tables.m} "
         f"table {tuple(sk_tables.fused.shape)} ({sk_tables.fused.numel()} B shared)", res)
    res = sync_check(sk_xs, sk_tables.next_state)
    merge(cuda_fsm8.sync_pass, res)
    show(f"sync_pass, skewed body: S={sk_tables.next_state.shape[0]} next_state "
         f"{tuple(sk_tables.next_state.shape)}", res)
    rh_xs, rh_tables, rh_valid, rh_lanes = body_cols(corpus("runheavy", 5 * MB))
    res = fused_check(rh_xs, rh_tables, rh_valid, rh_lanes, False)
    merge(cuda_fsm8.fused_pass, res)
    symbols_rows(f"run-heavy body ({rh_lanes} lanes, plane form, m={rh_tables.m})",
                 symbols_check(*onepass_items(rh_xs, rh_tables, rh_valid, rh_lanes)))
    show(f"fused_pass unpacked, run-heavy body {rh_valid} B: {rh_lanes} lanes, "
         f"m={rh_tables.m} table {tuple(rh_tables.fused.shape)}", res)
    # a full tile of the streaming encode: the 100 MB text's first 32 MiB
    big_text = corpus("text", 100 * MB)
    big_blob = et.compress(big_text, backend="host")
    res, _ = pack_check(big_text[: TILE_BLOCKS * DEFAULT_BLOCK_BYTES], big_blob)
    merge(cuda_pack.pack_blocks, res)
    show(f"pack_blocks, a {TILE_BLOCKS}-block encode tile of the 100 MB text", res)
    for shift in (0, 7, 19):
        res = stitch_check(big_text[: TILE_BLOCKS * DEFAULT_BLOCK_BYTES], big_blob, shift, shift)
        merge(cuda_stitch.stitch_tile, res)
        show(f"stitch_tile, that {TILE_BLOCKS}-block tile, shift {shift}"
             + (" with a carried word" if shift else ", the body's first bytes"), res)
    # a full tile of the streaming decode: the 100 MB text body's first 65,536 lanes
    big_tables, big_buf = decode_tables_for(big_blob, DEV)
    tile = big_buf[: decode8.TILE_LANES * decode8.DEFAULT_CHUNK_BYTES]
    tile_xs, tile_lanes = body_xs(tile)
    res = sync_check(tile_xs, big_tables.next_state)
    merge(cuda_fsm8.sync_pass, res)
    show(f"sync_pass, a {tile_lanes}-lane tile of the 100 MB text body", res)
    res = fused_check(tile_xs, big_tables, tile.size, tile_lanes, True)
    merge(cuda_fsm8.fused_pass, res)
    show(f"fused_pass packed, a {tile_lanes}-lane tile of the 100 MB text body", res)
    symbols_rows(f"a {tile_lanes}-lane tile of the 100 MB text body (packed)",
                 symbols_check(*onepass_items(tile_xs, big_tables, tile.size, tile_lanes)))
    del tile_xs

    for i, (kind, blob) in enumerate((("text 5.2 MB", text_blob), ("skewed 5 MB", blobs["skewed"]),
                                      ("runheavy 5 MB", blobs["runheavy"]),
                                      ("random 5 MB", et.compress(corpus("random", 5 * MB),
                                                                  backend="host")))):
        res, label = tables_check(blob)
        host_ms, launch_ms, card_ms = table_build_ms(blob)
        if i == 0:
            results[cuda_tables.fsm_tables] = res
        else:
            merge(cuda_tables.fsm_tables, res)
        show(f"fsm_tables, {kind} code table: {label}", res)
        print(f"[kernels] the one-pass tables of the {kind} code table: host NumPy build "
              f"(_build_byte_fsm, decode_tables) {host_ms:.3f} ms; on the card "
              f"(card_decode_tables: trie, layout DP, launch) {launch_ms:.3f} ms to the launch, "
              f"{card_ms:.3f} ms to the tables' end | {card}")

    results = {fn: results[fn] for fn in KERNELS}  # the JSON line's order
    for fn, res in results.items():
        show(f"{KERNELS[fn][0]} (50 back-to-back launches per event pair; plain: median "
             "of single calls)", res)
    print("[kernels] library: the full-table expansion is one advanced-indexing call "
          "(table[byte, j*S + state]); no single PyTorch call computes the others: the "
          "sync, emit and fused passes are serial per-lane walks, the split expansion two "
          "dependent lookups (its tail slots' column is the first lookup's value & 15) and "
          "a combine rule, the pack a per-block prefix sum and bit scatter, the compaction "
          "a per-column stable compaction, the symbols kernel per-lane sums and a "
          "selection in lane-major order over slots unpacked from the words first, the "
          "tables kernel a bit-serial walk of a trie from every (state, byte)")
    # 3b. guard: every kernel instantiation, launched and checked inside guard bands
    t0 = time.perf_counter()
    guard_calls = sk.plan(DEV)
    seen = sk.profiled_instantiations(guard_calls, DEV)
    require(seen == set(sk.INSTANTIATIONS),
            f"[guard] profiler: missing {sorted(set(sk.INSTANTIATIONS) - seen)}, "
            f"unknown {sorted(seen - set(sk.INSTANTIATIONS))}")
    faults = sk.guard_calls(guard_calls, DEV)
    calls_s = time.perf_counter() - t0
    print(f"[guard] {len(guard_calls)} calls reach {len(seen)}/{len(sk.INSTANTIATIONS)} "
          f"instantiations (torch.profiler), each run under poisons "
          f"{', '.join(f'{p:#x}' for p in sk.POISONS)}: {len(faults)} faults in "
          f"{calls_s:.1f} s | {card}")
    t0 = time.perf_counter()
    faults += sk.guard_api(DEV)
    api_s = time.perf_counter() - t0
    print(f"[guard] API round trips (~200 KB text and skewed, every route, a 7-lane "
          f"tiled decode) under both poisons: exact, {len(faults)} faults in total, "
          f"{api_s:.1f} s | {card}")
    require(not faults, "[guard] " + " | ".join(faults[:20]))

    # 4. end to end, through the public API: each main path with its counts from 0
    golden = (DATA / "nice.shakespeare.txt").read_bytes()
    cases = [("text 5.2 MB", text)] + [
        (f"{kind} 5 MB", corpus(kind, 5 * MB)) for kind in ("skewed", "runheavy", "random")
    ] + [("text 100 MB", corpus("text", 100 * MB))]
    data_of = dict(cases)
    e2e_blobs, dec_ms, enc_ms = {}, {name: {} for name, _ in cases}, {}

    def device_path():
        golden_et = (DATA / "nice.shakespeare.et").read_bytes()
        require(et.compress(golden, backend="device") == golden_et, "golden .et differs")
        require(et.decompress(golden_et, backend="device") == golden,
                "golden round trip differs")
        print(f"[e2e] golden nice.shakespeare.et (374 B) matches | {card}")
        for name, data in cases:
            host_blob = et.compress(data, backend="host")
            before = launch_counts()
            blob = e2e_blobs[name] = et.compress(data, backend="device")
            enc_tiles = cuda_pack.pack_blocks.launches - before[cuda_pack.pack_blocks]
            stitches = cuda_stitch.stitch_tile.launches - before[cuda_stitch.stitch_tile]
            require(blob == host_blob, f"{name}: .et differs from the host backend's")
            require(stitches == enc_tiles, f"{name}: {stitches} stitches, {enc_tiles} tiles")
            syncs = cuda_fsm8.sync_pass.launches
            require(et.decompress(blob, backend="device") == data, f"{name}: round trip differs")
            dec_tiles = cuda_fsm8.sync_pass.launches - syncs
            print_launches(f"{name} round trip (device backend)", before)
            require(et.decompress(blob, backend="host") == data,
                    f"{name}: host round trip differs")
            if len(data) > 20 * MB:
                require(dec_tiles >= 2 and enc_tiles >= 2,
                        f"{name}: {dec_tiles} decode / {enc_tiles} encode tiles, want >= 2")
            iters = 2 if len(data) > 20 * MB else 5
            line = []
            for backend in ("device", "host"):
                enc = wall_ms(lambda: et.compress(data, backend=backend), iters)
                dec = wall_ms(lambda: et.decompress(blob, backend=backend), iters)
                enc_ms[name, backend] = enc
                dec_ms[name]["onepass" if backend == "device" else "host backend"] = dec
                line.append(f"{backend}: compress {enc:.3f} ms ({len(data) / enc / 1e3:.1f} "
                            f"MB/s), decompress {dec:.3f} ms ({len(data) / dec / 1e3:.1f} MB/s)")
            print(f"[e2e] {name}: {len(data)} B -> {len(blob)} B, .et == host, round trip ok, "
                  f"tiles: decode {dec_tiles}, encode {enc_tiles} | "
                  f"{' | '.join(line)} | warm median of {iters} | {card}")

    def two_pass_path(route: str):
        for name, data in cases:
            big = len(data) > 20 * MB
            if big and route != "host":
                continue  # untiled rows of every byte: 100 MB runs through "host" only
            blob = e2e_blobs[name]
            before = launch_counts()
            require(et.decompress(blob, backend="device", expand=route) == data,
                    f"{name}: expand={route} round trip differs")
            print_launches(f"{name} decompress expand={route}", before)
            dec_ms[name][route] = wall_ms(
                lambda: et.decompress(blob, backend="device", expand=route), 1 if big else 5)

    def tiles_path():
        """Narrow tiles (many tile boundaries, each tile's fetch behind the
        next tile's decode) and the peak device memory at two widths."""
        for name, tile_lanes in (("text 100 MB", 8192), ("skewed 5 MB", 1024)):
            table, n, buf = body_for(e2e_blobs[name])
            syncs = cuda_fsm8.sync_pass.launches
            out = decode8.decode_body_device_tiled(buf, table, n, device=DEV,
                                                   tile_lanes=tile_lanes)
            tiles = cuda_fsm8.sync_pass.launches - syncs
            lanes = -(-buf.size // decode8.DEFAULT_CHUNK_BYTES)
            want = -(-lanes // tile_lanes)
            require(tiles == want, f"{name}: {tiles} tiles of {tile_lanes} lanes, want {want}")
            require(out.tobytes() == data_of[name], f"{name}: {tile_lanes}-lane tiles differ")
            print(f"[tiles] {name} body {buf.size} B in {tiles} tiles of {tile_lanes} lanes: "
                  f"bytes exact | {card}")
        blob = e2e_blobs["text 100 MB"]
        table, n, buf = body_for(blob)
        peaks = {}
        for label, tile_lanes in ((f"default ({decode8.TILE_LANES} lanes)", None),
                                  ("8192 lanes", 8192)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            if tile_lanes is None:
                require(et.decompress(blob, backend="device") == data_of["text 100 MB"],
                        "text 100 MB: round trip differs")
            else:
                decode8.decode_body_device_tiled(buf, table, n, device=DEV, tile_lanes=tile_lanes)
            torch.cuda.synchronize()
            peaks[label] = torch.cuda.max_memory_allocated() - base
        print(f"[tiles] text 100 MB decompress ({buf.size} B body), peak device memory above "
              f"the {base} B held before the call (torch.cuda.max_memory_allocated): "
              + ", ".join(f"{k} tiles {v} B" for k, v in peaks.items()) + f" | {card}")

    def auto_path():
        require(api._h2d_fast(), "the host-to-device probe says the card's link is slow")
        big = "sharded" if torch.cuda.device_count() > 1 else "device"  # the JAX rule
        for name, want in (("text 5.2 MB", "host"), ("text 100 MB", big)):
            data, blob = data_of[name], e2e_blobs[name]
            picks = (api._pick_backend(None, len(data)), api._pick_backend(None, len(blob)))
            require(picks == (want, want), f"{name}: auto picks {picks}, want {want}")
            before = sum(fn.launches for fn in KERNELS)
            require(et.compress(data) == blob, f"{name}: auto .et differs")
            require(et.decompress(blob) == data, f"{name}: auto round trip differs")
            launched = sum(fn.launches for fn in KERNELS) - before
            require((launched > 0) == (want != "host"),
                    f"{name}: auto launched {launched} kernels, picking {want}")
            iters = 2 if len(data) > 20 * MB else 5
            enc, dec = wall_ms(lambda: et.compress(data), iters), \
                wall_ms(lambda: et.decompress(blob), iters)
            print(f"[auto] {name}: picks {want} (compress of {len(data)} B, decompress of "
                  f"{len(blob)} B) | auto: compress {enc:.3f} ms, decompress {dec:.3f} ms | "
                  f"device: compress {enc_ms[name, 'device']:.3f}, decompress "
                  f"{dec_ms[name]['onepass']:.3f} | host: compress {enc_ms[name, 'host']:.3f}, "
                  f"decompress {dec_ms[name]['host backend']:.3f} | warm median of {iters} "
                  f"| {card}")

    def cli_path():
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            for name, flags in (("text 100 MB", []), ("text 5.2 MB", ["--backend", "device"])):
                src = Path(tmp) / f"{name.replace(' ', '_')}.txt"
                src.write_bytes(data_of[name])
                t0 = time.perf_counter()
                require(cli.main([*flags, "c", str(src)]) == 0, f"cli c {name} failed")
                require(cli.main([*flags, "d", f"{src}.et"]) == 0, f"cli d {name} failed")
                wall = (time.perf_counter() - t0) * 1e3
                require(Path(f"{src}.et").read_bytes() == e2e_blobs[name],
                        f"cli {name}: .et differs from the host backend's")
                require((src.parent / f"decoded_{src.name}").read_bytes() == data_of[name],
                        f"cli {name}: decoded file differs")
                print(f"[cli] {' '.join(flags) or '(auto)'} c + d {name}: exit 0, .et == host, "
                      f"decoded == input, {wall:.1f} ms both | {card}")

    def peak_call(fn):
        """(fn(), its wall ms, its peak device memory above what was held
        before it)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() - base

    sharded = {}  # (name, op) -> (ms, passes, all-gather ms) or, at 100 MB, (ms, peak B)

    def sharded_path():
        """World 1: a one-rank NCCL group (at one rank the collectives call
        nothing). Only sharded calls run here, so the counts are its own."""
        tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                 world_size=1, rank=0)
        try:
            mesh = make_mesh(device=DEV)
            require(mesh.group is not None and mesh.world == 1, f"world-1 mesh {mesh}")
            for name, routes in SHARDED_CASES:
                data, blob = data_of[name], e2e_blobs[name]
                require(et.compress(data, backend="sharded", device=DEV) == blob,
                        f"sharded {name}: .et differs from the host backend's")
                sharded[name, "compress"] = (
                    wall_ms(lambda: et.compress(data, backend="sharded", device=DEV), 3),
                    None, None)
                for route in routes:
                    before = launch_counts()
                    require(et.decompress(blob, backend="sharded", device=DEV,
                                          expand=route) == data,
                            f"sharded {name} expand={route}: round trip differs")
                    passes = pdist.last_decode_stats["passes"]
                    print_launches(f"{name} sharded decompress expand={route}", before)
                    ms = wall_ms(lambda: et.decompress(blob, backend="sharded", device=DEV,
                                                       expand=route), 3)
                    with trace.record_stages() as stages:
                        et.decompress(blob, backend="sharded", device=DEV, expand=route)
                    sharded[name, route] = (ms, passes, stages["allgather_exits"])
            sharded.update(big_calls("sharded"))
        finally:
            tdist.destroy_process_group()

    def big_calls(backend: str) -> dict:
        """The 100 MB text compressed and decompressed once through
        ``backend``: wall ms and peak device memory of each call."""
        name = "text 100 MB"
        data, blob = data_of[name], e2e_blobs[name]
        got, enc, enc_peak = peak_call(lambda: et.compress(data, backend=backend, device=DEV))
        require(got == blob, f"{backend} {name}: .et differs from the host's")
        got, dec, dec_peak = peak_call(lambda: et.decompress(blob, backend=backend, device=DEV))
        require(got == data, f"{backend} {name}: round trip differs")
        return {(name, "compress"): (enc, enc_peak), (name, "onepass"): (dec, dec_peak)}

    def sharded_beside_device():
        """The sharded path's times beside the same calls through the device
        backend, in the same process."""
        for name, routes in SHARDED_CASES:
            data, blob = data_of[name], e2e_blobs[name]
            for op in ("compress", *routes):
                ms, passes, gather_ms = sharded[name, op]
                if op == "compress":
                    dev_ms = wall_ms(lambda: et.compress(data, backend="device"), 3)
                    what = "compress: .et == host"
                else:
                    dev_ms = wall_ms(lambda: et.decompress(blob, backend="device", expand=op), 3)
                    what = (f"decompress expand={op}: round trip ok, fixed-point passes "
                            f"{passes}, exit all-gathers {gather_ms:.3f} ms")
                print(f"[sharded] world 1 (NCCL) {name} {what} | sharded {ms:.3f} ms, device "
                      f"{dev_ms:.3f} ms | warm median of 3 | {card}")
        name = "text 100 MB"
        device = big_calls("device")
        print(f"[sharded] {name}, one call each, ms and peak device memory above what was "
              f"held before the call (torch.cuda.max_memory_allocated): " + " | ".join(
                  f"{backend} {op} {got[name, op][0]:.3f} ms peak {got[name, op][1]} B"
                  for backend, got in (("sharded (untiled)", sharded), ("device (tiled)", device))
                  for op in ("compress", "onepass")) + f" | {card}")

    launches = run_path("device", device_path)
    for route in ("split", "fused", "host"):
        counts = run_path(route, lambda: two_pass_path(route))
        launches = {fn: launches[fn] + counts[fn] for fn in KERNELS}
    for name, data in cases:
        print(f"[e2e] {name} decompress by route, ms (MB/s): "
              + ", ".join(f"{route} {ms:.3f} ({len(data) / ms / 1e3:.1f})"
                          for route, ms in dec_ms[name].items())
              + (" | warm median of 2 (expand=host: 1 run)" if len(data) > 20 * MB
                 else " | warm median of 5") + f" | {card}")
    for path, drive in (("tiles", tiles_path), ("auto", auto_path), ("cli", cli_path),
                        ("sharded", sharded_path)):
        counts = run_path(path, drive)
        launches = {fn: launches[fn] + counts[fn] for fn in KERNELS}
    sharded_beside_device()
    run_world(card, 2, "gloo", WORLD2_CASES, WORLD2_ROUTES, "[sharded]")
    counts = multicard_phase(card, data_of, e2e_blobs, show, merge)
    launches = {fn: launches[fn] + counts[fn] for fn in KERNELS}
    def large_kernels(cfg, data: bytes, blob: bytes) -> None:
        """[large]'s kernels against their plain versions at its shapes,
        outside the path's launch counts."""
        t0 = time.perf_counter()
        with uncounted():
            for fn, label, res in large_kernel_checks(data, blob):
                merge(fn, res)
                show(f"{cfg.name} {KERNELS[fn][0]}, {label}", res, "large")
        torch.cuda.empty_cache()
        print(f"[large] {cfg.name} kernels against their plain versions: "
              f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)

    counts = run_path("large", lambda: lg.run(DEV, card, KERNELS, check=large_kernels))
    launches = {fn: launches[fn] + counts[fn] for fn in KERNELS}
    install_phase(card, text, e2e_blobs["text 5.2 MB"])
    bench_phase(card)

    # 5. stages of the device backend (and, with ENTREEPY_PROFILE, the device's busy share)
    for name, data in cases:
        blob = e2e_blobs[name]
        iters = 1 if len(data) > 20 * MB else 5
        stage_line(f"{name} compress", lambda: et.compress(data, backend="device"), iters, card)
        stage_line(f"{name} decompress", lambda: et.decompress(blob, backend="device"), iters,
                   card)
    for route in ("split", "fused", "host"):
        stage_line(f"text 5.2 MB decompress expand={route}",
                   lambda: et.decompress(e2e_blobs["text 5.2 MB"], backend="device",
                                         expand=route), 5, card)
    if profile:
        profile_round_trip(text, card)
    return finish(card, smoke_t0, results, launches, guard={
        "instantiations": len(seen), "calls": len(guard_calls), "faults": len(faults),
        "poisons": list(sk.POISONS), "calls_s": calls_s, "api_s": api_s, "card": card})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
