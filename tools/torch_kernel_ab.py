#!/usr/bin/env python3
"""Kernel times of two checkouts of entreepy_tpu_torch, in turns, on one card.

    python3 tools/torch_kernel_ab.py NAME=ROOT NAME=ROOT [NAME=ROOT ...]
        [--order A,B,B,A] [--only KERNEL,...] [--out FILE]

Each NAME=ROOT names the root of a checkout (for a parent commit:
``git archive <commit> | tar -x -C build/ab_parent``). Every turn of
``--order`` (default for two checkouts: first, second, second, first; for
more: each once, as given) runs in a process of its own, because every
package is named ``entreepy_tpu_torch``. The process
builds that checkout's kernels and times all seven, ``sync_pass``,
``fused_pass``, ``emit_pass``, ``expand_pass_split``, ``expand_pass``,
``pack_blocks`` and ``compact_rows``, at the shapes of the main path, on
inputs made the same way in every turn:

* sync_pass: the suffix window (128 B) of the 5.2 MB text body (5,958
  lanes, S = 128), of a 65,536-lane tile of the 100 MB text body and of the
  5 MB skewed body (S = 256), from the root, as the main path's first guess;
* fused_pass, packed: the 5.2 MB text body (5,958 lanes) and a 65,536-lane
  tile of the 100 MB text body; unpacked: the 5 MB skewed body (m = 4) and
  the 5 MB run-heavy body (m = 8);
* emit_pass: the 5.2 MB text body and the 5 MB run-heavy body (1,727
  lanes, S = 256), from the suffix sync's guess, as the two-pass routes'
  first pass;
* expand_pass_split and expand_pass: the same two bodies, and for
  expand_pass also the 5 MB skewed body (m = 4, S = 256), from the states
  of the checkout's own two-pass fixed point (``decode8.fsm8_decode``);
  the bound counts the table the function takes (``expand_tensors``'
  layout); where the checkout relays it for its kernel
  (``cuda_fsm8.expand_vector_table``), the relayout's own time is
  reported beside, and whether it lies inside the timed call (per call) or
  outside it (built once per table, ``ExpandTables.vec``, as the decode
  does);
* pack_blocks: the 5.2 MB text in 1 KiB blocks (5,079) and one 32 MiB
  encode tile of the 100 MB text (32,768 blocks), each with its corpus's
  code table;
* compact_rows: the encode plane of the 5.2 MB text (1 KiB blocks), the
  one-pass decode's m > 3 rows of the skewed body, the two-pass rows of the
  text body (split table) and of the run-heavy body (full table), from the
  checkout's own ``decode8.run_expand`` (whose rows a checkout may keep in
  int32 or uint8).

Fused entry states are the converged ones of the checkout's own
fixed-point loop. ``--only`` times the named kernels alone.
A time is 50 back-to-back launches between one CUDA-event pair, divided by
the count, median of 5 such runs; each result is also held against the
checkout's plain version (max |err| over live values; the exit code is 1
if any is not 0, after every turn has run, so a deliberately broken
checkout can still be timed). The bound is
the bytes the call must move (inputs read once, outputs written once) at the
card's 3.35 TB/s. Prints one line per turn and shape, the card's name and
power limit, and a JSON summary (also written to ``--out``). Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

MB = 1_000_000
DEVICE = "cuda"
TEXT_BYTES = 5_200_000  # bench.py's text corpus
BENCH = Path(__file__).resolve().parent.parent / "entreepy_tpu_torch" / "bench"


def _own(name: str):
    """Module ``name`` of this checkout's ``entreepy_tpu_torch/bench``, loaded
    by its path: every turn times and makes its inputs with the same code,
    whichever checkout it imports as ``entreepy_tpu_torch``."""
    spec = importlib.util.spec_from_file_location(f"_ab_bench_{name}", BENCH / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_timing, _corpus = _own("timing"), _own("corpus")
HBM_BYTES_PER_MS, bound_ms, kernel_ms = (_timing.HBM_BYTES_PER_MS, _timing.bound_ms,
                                         _timing.kernel_ms)


def corpus(root: Path, kind: str, n: int) -> bytes:
    """The corpus families of benchmarks/scale.py (``bench.corpus``, seed
    1234), the text one from the checkout at ``root``."""
    return _corpus.make_corpus(kind, n, root / _corpus.FIXTURE)


def max_err(a, b, live=None) -> int:
    """Largest |a - b| over the live elements."""
    import torch

    d = (a.long() - b.long()).abs()
    if live is not None:
        d = torch.where(live, d, 0)
    return int(d.max()) if d.numel() else 0


def encode_blocks(data: bytes, block: int, dev):
    """(blocks uint8[n_blocks, block] zero-padded, valid int32[n_blocks]) on
    ``dev``: ``data`` cut into the encode's blocks."""
    import torch

    n_blocks = -(-len(data) // block)
    flat = torch.zeros(n_blocks * block, dtype=torch.uint8, device=dev)
    flat[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    valid = torch.full((n_blocks,), block, dtype=torch.int32, device=dev)
    valid[-1] = len(data) - (n_blocks - 1) * block
    return flat.reshape(n_blocks, block), valid


def pack_err(pk, pp) -> int:
    """Largest |err| of a pack kernel's results against the plain
    version's: emitted, acc and nbits everywhere, words where emitted."""
    import torch

    return max(max_err(pk[0].view(torch.int32), pp[0].view(torch.int32), pp[1]),
               max_err(pk[1], pp[1]),
               max_err(pk[2].view(torch.int32), pp[2].view(torch.int32)),
               max_err(pk[3], pp[3]))


def _worker(root: Path, only: set[str]) -> dict:
    """Times of one checkout's kernels (see the module docstring); only
    those named in ``only`` when it is not empty."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import entreepy_tpu_torch as et
    from entreepy_tpu_torch.ops import cuda_compact, cuda_fsm8, cuda_pack, decode8
    from entreepy_tpu_torch.ops.bitpack import grouped_counts_plane, plane_cap_g, plane_sub_for
    from entreepy_tpu_torch.ops.encode import DEFAULT_BLOCK_BYTES
    from entreepy_tpu_torch.tables import code_tensors_for, decode_tables_for, expand_tables_for

    assert Path(et.__file__).resolve().is_relative_to(root.resolve()), et.__file__
    dev = torch.device(DEVICE)

    def body_xs(buf: np.ndarray):
        chunk = decode8.DEFAULT_CHUNK_BYTES
        lanes = -(-buf.size // chunk)
        padded = np.zeros(lanes * chunk, np.uint8)
        padded[: buf.size] = buf
        return decode8.bytes_to_cols(padded, lanes, chunk, dev).t().contiguous(), lanes

    out = {}

    def body(blob: bytes, n_lanes: int | None):
        tables, buf = decode_tables_for(blob, dev)
        if n_lanes is not None:
            buf = buf[: n_lanes * decode8.DEFAULT_CHUNK_BYTES]
        return (tables, buf, *body_xs(buf))

    def wanted(kernel: str) -> bool:
        return not only or kernel in only

    def sync(label: str, blob: bytes, n_lanes: int | None = None):
        if not wanted("sync_pass"):
            return
        tables, _buf, xs, lanes = body(blob, n_lanes)
        w = min(decode8.SYNC_WINDOW, xs.shape[0])
        sx, zeros = xs[-w:], torch.zeros(lanes, dtype=torch.int32, device=dev)
        exits = cuda_fsm8.sync_pass(sx, tables.next_state, zeros)
        out[f"sync_pass {label}"] = {
            "ms": kernel_ms(lambda: cuda_fsm8.sync_pass(sx, tables.next_state, zeros)),
            "bound_ms": bound_ms(sx, tables.next_state, zeros, exits),
            "max_abs_err": max_err(exits, cuda_fsm8.sync_pass_plain(sx, tables.next_state,
                                                                     zeros)),
            "shape": f"{lanes} lanes x {w} B, S={tables.next_state.shape[0]}"}

    def fused(label: str, blob: bytes, n_lanes: int | None = None):
        if not wanted("fused_pass"):
            return
        tables, buf, xs, lanes = body(blob, n_lanes)
        m, mt, s, packed = tables.m, tables.mt, tables.s, tables.m <= 3
        _, exits, unconverged = decode8.fsm8_decode_fused(
            xs.t().contiguous(), tables.next_state, tables.fused, lanes, m, mt, s,
            packed=packed, n_valid=buf.size)
        assert not unconverged
        entries = torch.cat([exits.new_zeros(1), exits[:-1]])
        args = (xs, tables.fused, entries, m, mt, s, packed, buf.size)
        vk, xk = cuda_fsm8.fused_pass(*args)
        vp, xp = cuda_fsm8.fused_pass_plain(*args)
        j = torch.arange(m, device=dev)[None, :, None]
        if packed:
            sh = (8 * (m - 1 - j)).int()
            r0k, r0p = vk >> (8 * m), vp >> (8 * m)
            sk, sp = (vk[:, None, :] >> sh) & 255, (vp[:, None, :] >> sh) & 255
        else:
            r0k, r0p, sk, sp = vk[:, 0], vp[:, 0], vk[:, 1:], vp[:, 1:]
        e = max(max_err(r0k, r0p), max_err(xk, xp),
                max_err(sk, sp, j < (r0p & 15)[:, None, :]))
        out[f"fused_pass {label}"] = {
            "ms": kernel_ms(lambda: cuda_fsm8.fused_pass(*args)),
            "bound_ms": bound_ms(xs, tables.fused, entries, vk, xk),
            "max_abs_err": e, "shape": f"{lanes} lanes x {xs.shape[0]} B, m={m} s={s}"}

    def emit(label: str, blob: bytes):
        if not wanted("emit_pass"):
            return
        tables, _buf, xs, lanes = body(blob, None)
        w = min(decode8.SYNC_WINDOW, xs.shape[0])
        zeros = torch.zeros(lanes, dtype=torch.int32, device=dev)
        guess = cuda_fsm8.sync_pass(xs[-w:], tables.next_state, zeros)
        entries = torch.cat([zeros[:1], guess[:-1]])
        sk, xk = cuda_fsm8.emit_pass(xs, tables.next_state, entries)
        sp, xp = cuda_fsm8.emit_pass_plain(xs, tables.next_state, entries)
        out[f"emit_pass {label}"] = {
            "ms": kernel_ms(lambda: cuda_fsm8.emit_pass(xs, tables.next_state, entries)),
            "bound_ms": bound_ms(xs, tables.next_state, entries, sk, xk),
            "max_abs_err": max(max_err(sk, sp), max_err(xk, xp)),
            "shape": f"{lanes} lanes x {xs.shape[0]} B, S={tables.next_state.shape[0]}"}

    def two_pass_inputs(blob: bytes, split: bool):
        """A body's expand tables, xs [K, lanes] and converged states."""
        tables, buf = expand_tables_for(blob, dev, split)
        xs, lanes = body_xs(buf)
        states, unconverged = decode8.fsm8_decode(xs, tables.next_state, lanes)
        assert not unconverged
        return tables, buf, xs, states

    def expand(label: str, blob: bytes, split: bool):
        name = "expand_pass_split" if split else "expand_pass"
        if not wanted(name):
            return
        tables, _buf, xs, states = two_pass_inputs(blob, split)
        m = tables.m
        relayout, extra = None, ()
        if split:
            args = (xs, states, tables.table, m, tables.mt)
            fn, plain = cuda_fsm8.expand_pass_split, cuda_fsm8.expand_pass_split_plain
        else:
            args = (xs, states, tables.table, m)
            fn, plain = cuda_fsm8.expand_pass, cuda_fsm8.expand_pass_plain
            relayout = getattr(cuda_fsm8, "expand_vector_table", None)
            if getattr(tables, "vec", None) is not None:  # built once per table
                extra = (tables.vec,)
        vk, vp = fn(*args, *extra), plain(*args)
        j = torch.arange(m, device=dev)[None, :, None]
        res = out[f"{name} {label}"] = {
            "ms": kernel_ms(lambda: fn(*args, *extra)),
            "bound_ms": bound_ms(xs, states, tables.table, vk),
            "max_abs_err": max(max_err(vk[:, 0], vp[:, 0]),
                               max_err(vk[:, 1:], vp[:, 1:], j < (vp[:, 0] & 15)[:, None, :])),
            "shape": f"{xs.shape[1]} lanes x {xs.shape[0]} B, m={m} S={tables.s}, "
                     f"table {tuple(tables.table.shape)}, {str(vk.dtype)[6:]} rows"}
        if relayout is not None:
            res["relayout_ms"] = kernel_ms(lambda: relayout(tables.table, m))
            res["relayout_in_call"] = not extra

    def compact(label: str, rows, live, sub: int, cap: int):
        ck = cuda_compact.compact_rows(rows, live, sub, cap)
        cp = cuda_compact.compact_rows_plain(rows, live, sub, cap)
        out[f"compact_rows {label}"] = {
            "ms": kernel_ms(lambda: cuda_compact.compact_rows(rows, live, sub, cap)),
            "bound_ms": bound_ms(rows, live, *ck),
            "max_abs_err": max(max_err(ck[0], cp[0]), max_err(ck[1], cp[1])),
            "shape": f"{tuple(rows.shape)}, sub {sub}, cap {cap}"}

    def two_pass_rows(blob: bytes, split: bool):
        """The two-pass route's compaction operands of a body."""
        tables, buf, xs, states = two_pass_inputs(blob, split)
        counts, _inv, syms = decode8.run_expand(xs, states, tables, buf.size)
        return rows_of(counts, syms, tables.m)

    def rows_of(counts, syms, m: int):
        k, lanes = counts.shape
        j = torch.arange(m, device=dev)[None, :, None]
        live = (j < counts[:, None, :]).reshape(k * m, lanes)
        return (syms.reshape(k * m, lanes).to(torch.int32), live,
                decode8._sub_width(k) * m, decode8.sym_cap(counts, m))

    def pack(label: str, data: bytes, blob: bytes):
        blocks, valid = encode_blocks(data, DEFAULT_BLOCK_BYTES, dev)
        codes, lengths = code_tensors_for(blob, dev)
        pk = cuda_pack.pack_blocks(blocks, valid, codes, lengths)
        if not wanted("pack_blocks"):
            return pk
        pp = cuda_pack.pack_blocks_plain(blocks, valid, codes, lengths)
        out[f"pack_blocks {label}"] = {
            "ms": kernel_ms(lambda: cuda_pack.pack_blocks(blocks, valid, codes, lengths)),
            "bound_ms": bound_ms(blocks, valid, codes, lengths, *pk),
            "max_abs_err": pack_err(pk, pp),
            "shape": f"{blocks.shape[0]} blocks x {blocks.shape[1]} B"}
        return pk

    text = corpus(root, "text", TEXT_BYTES)
    big = corpus(root, "text", 100 * MB)
    blobs = {"text": et.compress(text, backend="host"),
             "big": et.compress(big, backend="host"),
             "skewed": et.compress(corpus(root, "skewed", 5 * MB), backend="host"),
             "runheavy": et.compress(corpus(root, "runheavy", 5 * MB), backend="host")}
    sync("text 5.2 MB", blobs["text"])
    sync("65,536-lane tile of text 100 MB", blobs["big"], 65536)
    sync("skewed 5 MB", blobs["skewed"])
    fused("packed, text 5.2 MB", blobs["text"])
    fused("packed, 65,536-lane tile of text 100 MB", blobs["big"], 65536)
    fused("unpacked, skewed 5 MB", blobs["skewed"])
    fused("unpacked, runheavy 5 MB", blobs["runheavy"])
    for kind, label in (("text", "text 5.2 MB"), ("runheavy", "runheavy 5 MB")):
        emit(label, blobs[kind])
        expand(label, blobs[kind], True)
        expand(label, blobs[kind], False)
    expand("skewed 5 MB", blobs["skewed"], False)

    words, emitted, _acc, _nbits = pack("text 5.2 MB", text, blobs["text"])
    pack("32 MiB encode tile of text 100 MB", big[: 32 << 20], blobs["big"])
    if not wanted("compact_rows"):
        return out
    sub = plane_sub_for(DEFAULT_BLOCK_BYTES)
    compact("encode plane, text 5.2 MB", words.view(torch.int32).t().contiguous(),
            emitted.t().contiguous(), sub,
            plane_cap_g(int(grouped_counts_plane(emitted).max()), DEFAULT_BLOCK_BYTES))

    tables, buf = decode_tables_for(blobs["skewed"], dev)
    xs, lanes = body_xs(buf)
    vals, _, _ = decode8.fsm8_decode_fused(xs.t().contiguous(), tables.next_state,
                                           tables.fused, lanes, tables.m, tables.mt, tables.s)
    counts, _inv, syms = decode8._expand_mask(vals[:, 0], vals[:, 1:].to(torch.uint8), buf.size)
    compact("one-pass m > 3 rows, skewed 5 MB", *rows_of(counts, syms, tables.m))
    compact("split-route rows, text 5.2 MB", *two_pass_rows(blobs["text"], True))
    compact("fused-route rows, runheavy 5 MB", *two_pass_rows(blobs["runheavy"], False))
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=ROOT")
    ap.add_argument("--order", help="comma-separated names (default for two checkouts: "
                    "A,B,B,A; for more, each once)")
    ap.add_argument("--only", default="", help="comma-separated kernels to time "
                    "(sync_pass, fused_pass, emit_pass, expand_pass_split, expand_pass, "
                    "pack_blocks, compact_rows; default: all)")
    ap.add_argument("--out", help="also write the JSON summary here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = {k for k in args.only.split(",") if k}
    if args.worker:
        print(json.dumps(_worker(Path(args.worker), only)))
        return 0
    trees = dict(t.split("=", 1) for t in args.trees)
    if len(trees) < 2:
        ap.error("give two or more checkouts, NAME=ROOT each")
    names = list(trees)
    order = (args.order.split(",") if args.order
             else [names[0], names[1], names[1], names[0]] if len(names) == 2 else names)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    turns = []
    for i, name in enumerate(order, 1):
        root = Path(trees[name]).resolve()
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                            str(root), "--only", args.only], cwd=root, capture_output=True,
                           text=True,
                           env={**os.environ, "PYTHONPATH": str(root)}, timeout=900)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        res = json.loads(r.stdout.strip().splitlines()[-1])
        turns.append({"turn": i, "tree": name, "results": res})
        for label, v in res.items():
            print(f"[ab] turn {i} {name}: {label} ({v['shape']}): {v['ms']:.4f} ms, bound "
                  f"{v['bound_ms']:.4f} ms ({v['bound_ms'] / v['ms']:.1%}), max_abs_err "
                  f"{v['max_abs_err']}"
                  + (f", the table relayout alone {v['relayout_ms']:.4f} ms "
                     + ("(inside the call)" if v.get("relayout_in_call", True)
                        else "(once per table, outside the call)")
                     if "relayout_ms" in v else "") + f" | {card}")
    print(card)
    summary = {"card": card, "order": order, "turns": turns}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return int(any(v["max_abs_err"] for t in turns for v in t["results"].values()))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
