"""The port at the JAX package's largest published configurations, through
its public API: ``chip_smoke.py``'s ``[large]`` phase, which builds the
kernels, counts their launches and calls :func:`run` on the card.

The two configurations (``CONFIGS``) are made from the seed by
``benchmarks/scale.py``'s generators (``entreepy_tpu_torch.bench.make_corpus``):

* ``text-1GB``: the text family at 10^9 B, enwik9 scale (README.md's
  "1 GB (enwik9 scale)" rows): a ~586 MB body, whose stitched bit offsets
  pass 2^32 and whose untiled dense symbol plane has ~1.76 G elements;
* ``random-2.125GiB``: uniform bytes, 2^31 + 2^27 B. Every code is 8 bits,
  so the body is as long as the input: its byte positions pass 2^31
  (required before any decode), and so do the host route's ``states`` and
  the sharded compress's ``words``.

Per configuration, one line per call (wall ms, MB/s, peak device bytes
above what was held before the call, the process's peak RSS, tiles, the
call's kernel launches, the card), each result compared byte for byte:
the host codec's compress (the reference ``.et``); the device backend's
tiled compress; its tiled one-pass decompress (no host fallback); its
untiled ``expand="host"`` route; the sharded backend at world 1 (a one-rank
group: NCCL on the card), whose decompress of a body of 2 GiB or more must
take the escape into the tiled decode; at the random configuration the
``split`` and ``fused`` routes, which must raise NotImplementedError naming
the route; and the host codec's decompress. Then the caller's ``check``
gets the configuration's input and ``.et`` (the smoke holds each kernel
against its plain version there, at the shapes these calls gave it).

The tiled decompress must peak at most ``PEAK_RATIO`` x the one-pass
decompress peak of ``REFERENCE`` (the 100 MB text) measured by the same run,
and the tiled compress at most ``PEAK_RATIO`` x its compress peak: both are
bounded by their tiles. The bounds are checked after every call has run.
"""

from __future__ import annotations

import gc
import resource
import socket
import time
from pathlib import Path
from typing import NamedTuple

import torch
import torch.distributed as tdist

import entreepy_tpu_torch as et
from entreepy_tpu_torch.bench import make_corpus
from entreepy_tpu_torch.bench.timing import peak_bytes
from entreepy_tpu_torch.format import parse_header
from entreepy_tpu_torch.ops import (
    cuda_compact, cuda_fsm8, cuda_pack, cuda_stitch, cuda_tables, decode8, encode,
)
from entreepy_tpu_torch.parallel import dist as pdist


class Config(NamedTuple):
    name: str
    kind: str
    n_bytes: int


CONFIGS = (Config("text-1GB", "text", 10**9),
           Config("random-2.125GiB", "random", (1 << 31) + (1 << 27)))
REFERENCE = Config("text 100 MB", "text", 10**8)
BODY_MIN = 1 << 31  # the random configuration's body: past every 32-bit position
PEAK_RATIO = 1.10
# The kernels the phase must launch (the expansions run in the smoke's [e2e])
PATH_KERNELS = (cuda_fsm8.sync_pass, cuda_fsm8.fused_pass, cuda_fsm8.emit_pass,
                cuda_pack.pack_blocks, cuda_compact.compact_rows, cuda_stitch.stitch_tile,
                cuda_tables.fsm_tables)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(f"[large] {msg}")


def _rss() -> tuple[int, int]:
    """(the process's peak RSS, its RSS now), bytes."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    now = int(Path("/proc/self/statm").read_text().split()[1]) * resource.getpagesize()
    return peak, now


def _raises_not_implemented(fn) -> str:
    """The message of the NotImplementedError that ``fn()`` raises (any
    other outcome fails the phase)."""
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    require(False, "a route past its bound returned instead of raising NotImplementedError")
    return ""


class Phase:
    """One run of the phase on ``device``: every call's line and the peaks."""

    def __init__(self, device: torch.device, card: str, kernels):
        self.device, self.card, self.kernels = device, card, tuple(kernels)
        self.peaks: dict = {}

    def _launches(self) -> dict:
        return {fn: fn.launches for fn in self.kernels}

    def call(self, cfg: Config, label: str, fn, want: bytes | None = None):
        """``fn()`` once, timed on the host clock, its peak device memory and
        its launches counted; its result must equal ``want`` (when given)
        and it must not fall back to the host decoder. Returns (result,
        launches of the call by kernel name)."""
        before, fallbacks = self._launches(), decode8.decode_host.calls
        with peak_bytes(self.device) as peak:
            t0 = time.perf_counter()
            out = fn()
            ms = (time.perf_counter() - t0) * 1e3
        launched = {fn.__name__: fn.launches - n for fn, n in before.items() if fn.launches > n}
        tiles = (launched.get("pack_blocks" if label.startswith("compress") else "sync_pass", 0)
                 if self.device.type == "cuda" else "not counted")
        rss_peak, rss_now = _rss()
        require(decode8.decode_host.calls == fallbacks,
                f"{cfg.name} {label}: fell back to the host decoder")
        if want is not None:
            require(out == want, f"{cfg.name} {label}: result differs")
        self.peaks[cfg.name, label] = peak["bytes"]
        shown = "not measured" if peak["bytes"] is None else f"{peak['bytes']} B"
        print(f"[large] {cfg.name} {label}: {ms:.1f} ms ({cfg.n_bytes / ms / 1e3:.1f} MB/s), "
              f"peak device {shown}, peak RSS {rss_peak} B (now {rss_now} B), tiles {tiles}, "
              f"launches {launched}{', result exact' if want is not None else ''} | {self.card}",
              flush=True)
        return out, launched

    def reference(self, cfg: Config) -> None:
        """The tiled compress and one-pass decompress of ``cfg``: the peaks
        the large configurations are held to."""
        data = make_corpus(cfg.kind, cfg.n_bytes)
        ref = et.compress(data, backend="host")
        self.call(cfg, "compress device (tiled)",
                  lambda: et.compress(data, backend="device", device=self.device), ref)
        self.call(cfg, "decompress device onepass (tiled)",
                  lambda: et.decompress(ref, backend="device", device=self.device), data)

    def config(self, cfg: Config, body_min: int, check) -> None:
        dev = self.device
        t0 = time.perf_counter()
        data = make_corpus(cfg.kind, cfg.n_bytes)
        print(f"[large] {cfg.name}: {len(data)} B made from the seed in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ref, _ = self.call(cfg, "compress host (the reference .et)",
                           lambda: et.compress(data, backend="host"))
        hdr = parse_header(ref)
        body = len(ref) - hdr.body_start
        lanes = -(-body // decode8.DEFAULT_CHUNK_BYTES)
        dec_tiles = -(-lanes // decode8.TILE_LANES)
        enc_tiles = -(-len(data) // (encode.TILE_BLOCKS * encode.DEFAULT_BLOCK_BYTES))
        print(f"[large] {cfg.name}: body {body} B, {lanes} lanes, {dec_tiles} decode tiles, "
              f"{enc_tiles} encode tiles, {hdr.table.num_symbols} codes of "
              f"{hdr.table.min_len}-{hdr.table.max_len} bits", flush=True)
        if cfg.kind == "random":
            require(body >= body_min, f"{cfg.name}: body {body} B, want >= {body_min} B")
            require(hdr.table.num_symbols == 256 and hdr.table.min_len == hdr.table.max_len == 8,
                    f"{cfg.name}: not 256 codes of 8 bits")

        counted = dev.type == "cuda"  # the wrappers count launches of their kernels only
        _, got = self.call(cfg, "compress device (tiled)",
                           lambda: et.compress(data, backend="device", device=dev), ref)
        require(not counted or got.get("pack_blocks") == enc_tiles,
                f"{cfg.name}: {got.get('pack_blocks')} encode tiles, want {enc_tiles}")
        _, got = self.call(cfg, "decompress device onepass (tiled)",
                           lambda: et.decompress(ref, backend="device", device=dev), data)
        require(not counted or got.get("sync_pass") == dec_tiles,
                f"{cfg.name}: {got.get('sync_pass')} decode tiles, want {dec_tiles}")
        self.call(cfg, "decompress device expand=host (untiled)",
                  lambda: et.decompress(ref, backend="device", device=dev, expand="host"), data)

        self.call(cfg, "compress sharded world 1",
                  lambda: et.compress(data, backend="sharded", device=dev), ref)
        escapes = lanes * decode8.DEFAULT_CHUNK_BYTES >= pdist._INT32_SAFE_BODY
        pdist.last_decode_stats.clear()
        _, got = self.call(
            cfg, f"decompress sharded world 1 onepass ({'tiled escape' if escapes else 'untiled'})",
            lambda: et.decompress(ref, backend="sharded", device=dev), data)
        if cfg.kind == "random":
            require(escapes, f"{cfg.name}: the sharded decode did not reach its 2 GiB escape")
        if escapes:
            require(not pdist.last_decode_stats,
                    f"{cfg.name}: the sharded decode ran its own passes "
                    f"({pdist.last_decode_stats}), not the tiled escape")
            require(not counted or (got.get("sync_pass") == dec_tiles
                                    and got.get("fused_pass", 0) >= dec_tiles),
                    f"{cfg.name}: the escape launched {got}, want {dec_tiles} tiles")
            print(f"[large] {cfg.name}: the sharded decode took the tiled escape "
                  f"(last_decode_stats empty, {got.get('fused_pass', 0)} fused launches over "
                  f"{dec_tiles} tiles) | {self.card}", flush=True)
        else:
            require("passes" in pdist.last_decode_stats
                    and (not counted or got.get("sync_pass") == 1),
                    f"{cfg.name}: the sharded decode did not run untiled ({got})")

        if body > decode8.MAX_UNTILED_BYTES:
            for route in ("split", "fused"):
                before = self._launches()
                msg = _raises_not_implemented(
                    lambda: et.decompress(ref, backend="device", device=dev, expand=route))
                require(f"expand={route!r}" in msg, f"{cfg.name}: {route} raised {msg!r}")
                require(self._launches() == before, f"{cfg.name}: {route} launched kernels")
                print(f"[large] {cfg.name} decompress device expand={route}: "
                      f"NotImplementedError ({msg}), no launch | {self.card}", flush=True)
        self.call(cfg, "decompress host", lambda: et.decompress(ref, backend="host"), data)
        if check is not None:
            check(cfg, data, ref)

    def check_peaks(self, ref: Config, configs) -> None:
        """Each tiled call's peak against the reference's, by PEAK_RATIO."""
        if self.device.type != "cuda":
            return
        over = []
        for label in ("compress device (tiled)", "decompress device onepass (tiled)"):
            bound = PEAK_RATIO * self.peaks[ref.name, label]
            for cfg in configs:
                peak = self.peaks[cfg.name, label]
                print(f"[large] {cfg.name} {label}: peak {peak} B = "
                      f"{peak / self.peaks[ref.name, label]:.3f} x {ref.name}'s | {self.card}")
                if peak > bound:
                    over.append(f"{cfg.name} {label} {peak} B > {bound:.0f} B")
        require(not over, "peak device memory grew with the input: " + "; ".join(over))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(device: torch.device, card: str, kernels, configs=CONFIGS,
        reference: Config = REFERENCE, body_min: int = BODY_MIN, check=None) -> None:
    """The phase: the reference's peaks, then each configuration (its data
    freed before the next), the sharded calls in a one-rank group (NCCL on
    a CUDA device, else gloo), then the peak bounds. ``kernels``: the
    wrappers whose launches each call counts; ``check(cfg, data, et)``, when
    given, runs after a configuration's calls."""
    t0 = time.perf_counter()
    phase = Phase(device, card, kernels)
    tdist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                             init_method=f"tcp://127.0.0.1:{_free_port()}",
                             world_size=1, rank=0)
    try:
        phase.reference(reference)
        for cfg in configs:
            c0 = time.perf_counter()
            phase.config(cfg, body_min, check)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            print(f"[large] {cfg.name}: {time.perf_counter() - c0:.1f} s | {card}", flush=True)
    finally:
        tdist.destroy_process_group()
    phase.check_peaks(reference, configs)
    print(f"[large] phase {time.perf_counter() - t0:.1f} s | {card}", flush=True)
