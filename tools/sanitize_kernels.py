"""Every CUDA kernel instantiation of entreepy_tpu_torch, launched at small
odd shapes and checked inside poisoned guard bands.

:func:`plan` lays out calls that launch each of the 39 template
instantiations of ``csrc/`` at least once, through the kernel wrappers of
``ops/cuda_*.py``, at shapes that reach every guard (lanes 1, 7, 33 and 300;
partial last chunks, blocks and rounds; k = 1, 16, 17, 33, 48 and 512); the
rules below mirror the dispatch code that picks each instantiation, file
and line beside each. :func:`api_round_trips` adds one round trip per
decode route and one encode through the public API on a ~200 KB text and a
~200 KB skewed body, and one tiled decode at 7 lanes per tile. The FSM
tables come from real code tables; m = 5, 6 and 7, which no prefix code
gives (a byte completes at most 4 codes of 2 bits or more, and 8 where a
code has 1 bit), and m = 1 at S = 128 (m = 1 needs all 256 symbols) take
the tail slots or rows of a wider real table, cut to that m.

Guard bands (:class:`Guard`, :func:`guard_calls`, :func:`guard_api`; the
``[guard]`` phase of chip_smoke.py): each call runs twice with its inputs
and every tensor the wrappers allocate inside bands of a poison byte, 0xA5
then 0x5A. A band that changed is a write out of bounds; outputs that
differ between the poisons read memory that nothing wrote or that lies
outside the inputs.

    python tools/sanitize_kernels.py                 # the calls, on the card
    python tools/sanitize_kernels.py --device cpu    # the same through the plain versions

Imports only entreepy_tpu_torch, numpy and torch.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "entreepy_tpu_torch" / "csrc"
DATA = ROOT / "tests" / "data"

# cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100: the staged-or-L2 rule's
# limit when no card is asked (the card's own value is read on the card).
H100_SMEM_OPTIN = 232448
MAX_TILE_CAP = 1536       # compact.cu kMaxTileCap
MAX_TILE_GROUPS = 65535   # compact.cu: the tile kernel's grid.y

# Every kernel instantiation the port can launch, as the profiler and the
# reports name them (namespace and parameters dropped).
INSTANTIATIONS = (
    "walk_kernel<false>", "walk_kernel<true>",
    "fused_kernel<true, 2>", *(f"fused_kernel<false, {nt}>" for nt in range(8)),
    "pack_kernel<true>", "pack_kernel<false>",
    "compact_tile_kernel", "compact_serial_kernel",
    *(f"expand_split_kernel<{nt}>" for nt in range(8)),
    *(f"expand_kernel<{m1}, 4, true>" for m1 in (2, 3, 4)),
    *(f"expand_kernel<{m + 1}, {4 if m < 4 else 8 if m < 8 else 16}, false>"
      for m in range(1, 9)),
    "symbols_kernel<false, false>", "symbols_kernel<false, true>", "symbols_kernel<true, true>",
    "stitch_kernel", "tables_kernel",
)
PORT_KERNELS = ("walk_kernel", "fused_kernel", "pack_kernel", "compact_tile_kernel",
                "compact_serial_kernel", "expand_split_kernel", "expand_kernel", "symbols_kernel",
                "stitch_kernel", "tables_kernel")


# ---- the dispatch rules of csrc/, one per C entry point ----

def walk_instantiation(emit: bool) -> str:
    """fsm8.cu:336 et_sync_pass, :341 et_emit_pass."""
    return f"walk_kernel<{'true' if emit else 'false'}>"


def fused_instantiation(m: int, mt: int, packed: bool) -> str:
    """fsm8.cu:354-358: packed rows take <true, 2>, unpacked <false, min(mt, m - 1)>."""
    return "fused_kernel<true, 2>" if packed else f"fused_kernel<false, {min(mt, m - 1)}>"


def pack_instantiation(steps: int, blocks_ptr: int) -> str:
    """pack.cu:205: 16-byte loads when steps % 16 == 0 and the rows' base is aligned."""
    vec = steps % 16 == 0 and blocks_ptr % 16 == 0
    return f"pack_kernel<{'true' if vec else 'false'}>"


def compact_instantiation(cap: int, groups: int) -> str:
    """compact.cu:129: the serial kernel past the tile's cap or grid."""
    serial = cap > MAX_TILE_CAP or groups > MAX_TILE_GROUPS
    return "compact_serial_kernel" if serial else "compact_tile_kernel"


def split_instantiation(m: int, mt: int) -> str:
    """expand.cu:282: NT = min(mt, m - 1)."""
    return f"expand_split_kernel<{min(mt, m - 1)}>"


def expand_instantiation(m: int, s: int, smem_max: int = H100_SMEM_OPTIN) -> str:
    """expand.cu:302-311: entries of P = m + 1 rounded up to 4, 8 or 16
    bytes; the table is staged in shared memory exactly when its entries are
    4 bytes and it fits a block's opt-in limit."""
    p = 4 if m < 4 else 8 if m < 8 else 16
    staged = p == 4 and 256 * s * p <= smem_max
    return f"expand_kernel<{m + 1}, {p}, {'true' if staged else 'false'}>"


def symbols_instantiation(plane: bool, write: bool) -> str:
    """symbols.cu et_symbol_counts (packed words), et_symbol_write (a plane
    when mini_tot is given, else packed words)."""
    return f"symbols_kernel<{'true' if plane else 'false'}, {'true' if write else 'false'}>"


def source_instantiations() -> set[str]:
    """The instantiations the dispatch code of ``csrc/`` names: every
    ``*_kernel<literal, ...>`` and ``launch_walk<literal>`` outside comments,
    and every kernel without template parameters."""
    found = set()
    for path in sorted(CSRC.glob("*.cu")):
        code = re.sub(r"//[^\n]*", "", path.read_text())
        for name, args in re.findall(r"\b(\w+_kernel)<([\w ,]+)>", code):
            if all(re.fullmatch(r"\d+|true|false", a.strip()) for a in args.split(",")):
                found.add(f"{name}<{', '.join(a.strip() for a in args.split(','))}>")
        for emit in re.findall(r"\blaunch_walk<(true|false)>", code):
            found.add(f"walk_kernel<{emit}>")
        for template, name in re.findall(
                r"(template\s*<[^>]*>\s*)?__global__\s+void\s+"
                r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+_kernel)\s*\(", code):
            if not template:
                found.add(name)
    return found


def kernel_name(demangled: str) -> str:
    """A demangled device function's name as INSTANTIATIONS writes it:
    ``void (anonymous namespace)::fused_kernel<false, 3>(unsigned char
    const*, ...)`` -> ``fused_kernel<false, 3>``."""
    s = demangled.replace("(anonymous namespace)::", "")
    s = s.replace("(bool)1", "true").replace("(bool)0", "false")
    m = re.search(r"(\w+)(<[^()]*>)?\s*\(", s)
    if not m:
        return s.strip()
    args = m.group(2)
    if not args:
        return m.group(1)
    args = [a.strip() for a in args[1:-1].split(",")]
    return f"{m.group(1)}<{', '.join(args)}>"


# ---- the calls ----

@dataclass
class Call:
    """One launch of a kernel wrapper: ``fn(*args, **kwargs)``."""
    label: str
    instantiation: str
    fn: object = field(repr=False)
    args: tuple = field(repr=False)
    kwargs: dict = field(default_factory=dict, repr=False)

    def run(self, args=None):
        return self.fn(*(self.args if args is None else args), **self.kwargs)


def _corpora() -> dict[str, bytes]:
    """Small corpora whose code tables give m = 1, 2, 3, 4 and 8 at S = 128
    and 256 (S: the byte-FSM's width, 256 past 129 symbols)."""
    import numpy as np

    rng = np.random.default_rng(11)
    text = (DATA / "a_midsummer_nights_dream.txt").read_bytes()
    zipf = 1.0 / np.arange(1, 257) ** 1.3
    wide3 = rng.integers(0, 200, 20_000).astype(np.uint8)
    hot = rng.random(wide3.size) < 0.5
    wide3[hot] = rng.integers(200, 204, int(hot.sum()))
    return {
        "text": text[:20_000],                                            # m 3, S 128
        "uniform": bytes(range(256)) * 80,                                # m 1, S 256
        "few": (rng.integers(0, 20, 20_000) + 65).astype(np.uint8).tobytes(),  # m 2, S 128
        "wide2": rng.integers(0, 200, 20_000).astype(np.uint8).tobytes(),  # m 2, S 256
        "wide3": wide3.tobytes(),                                         # m 3, S 256
        "skewed": rng.choice(256, 20_000, p=zipf / zipf.sum()).astype(np.uint8).tobytes(),
        "runheavy": (b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()) * 3,
    }


def _cut_fused(t, s: int, mt: int, to_mt: int):
    """A fused table uint8[256, 2s + 9(mt + 2)] with its tail slots cut to
    ``to_mt``: the first ``to_mt`` slot blocks, then the tail end block."""
    import torch

    keep = 2 * s + 9 * (1 + to_mt)
    end = 2 * s + 9 * (1 + mt)
    return torch.cat([t[:, :keep], t[:, end:end + 9]], dim=1).contiguous()


def plan(device) -> list[Call]:
    """The calls that reach every instantiation, their inputs on ``device``
    (on the CPU the wrappers run their plain versions)."""
    import numpy as np
    import torch

    import entreepy_tpu_torch as et
    from entreepy_tpu_torch.format import parse_header
    from entreepy_tpu_torch.format.fsm8 import _build_trie
    from entreepy_tpu_torch.format.huffman import CodeTable
    from entreepy_tpu_torch.ops import (cuda_compact, cuda_fsm8, cuda_pack, cuda_stitch,
                                        cuda_symbols, cuda_tables)
    from entreepy_tpu_torch.tables import code_tensors_for, decode_tables_for, expand_tables_for

    device = torch.device(device)
    smem_max = H100_SMEM_OPTIN
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        smem_max = getattr(props, "shared_memory_per_block_optin", H100_SMEM_OPTIN)
    rng = np.random.default_rng(5)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def u8(*shape):
        return dev(rng.integers(0, 256, shape, dtype=np.uint8))

    def below(n, *shape, dtype=np.uint8):
        return dev(rng.integers(0, n, shape).astype(dtype))

    corpora = _corpora()
    blobs = {k: et.compress(d, backend="host") for k, d in corpora.items()}
    dec = {k: decode_tables_for(b, device)[0] for k, b in blobs.items()}
    split = {k: expand_tables_for(b, device, True)[0] for k, b in blobs.items()}
    full = {k: expand_tables_for(b, device, False)[0] for k, b in blobs.items()}
    calls: list[Call] = []

    def add(label, inst, fn, *args, **kwargs):
        calls.append(Call(label, inst, fn, args, kwargs))

    shapes = ((1, 1), (17, 7), (33, 33), (512, 300), (48, 7), (16, 33))  # (k, lanes)

    # walk_kernel: the sync pass (w <= 128) and the emit pass, at S = 128 and 256
    for kind in ("text", "wide2"):
        ns = dec[kind].next_state
        for k, lanes in shapes:
            w = min(k, 128)
            xs, ent = u8(w, lanes), below(ns.shape[0], lanes, dtype=np.int32)
            add(f"sync_pass S={ns.shape[0]} w={w} lanes={lanes}", walk_instantiation(False),
                cuda_fsm8.sync_pass, xs, ns, ent)
            xs = u8(k, lanes)
            add(f"emit_pass S={ns.shape[0]} k={k} lanes={lanes}", walk_instantiation(True),
                cuda_fsm8.emit_pass, xs, ns, ent)

    # fused_kernel: packed rows for m <= 3, unpacked rows for m = 1..8
    by_m = {1: "uniform", 2: "few", 3: "text", 4: "skewed", 8: "runheavy"}
    for i, m in enumerate(range(1, 9)):
        kind = by_m.get(m, "runheavy")
        t = dec[kind]
        mt = max(1, m - 1)
        fused = t.fused if t.m == m else _cut_fused(t.fused, t.s, t.mt, mt)
        cut = "" if t.m == m else f" (the {kind} table's tail slots cut to {mt})"
        for packed in ((False, True) if m <= 3 else (False,)):
            k, lanes = shapes[(i + packed) % 4]
            xs, ent = u8(k, lanes), below(t.s, lanes, dtype=np.int32)
            n_valid = k * lanes - k // 2  # the last lane partly live
            add(f"fused_pass m={m} s={t.s} packed={packed} k={k} lanes={lanes}{cut}",
                fused_instantiation(m, mt, packed), cuda_fsm8.fused_pass,
                xs, fused, ent, m, mt, t.s, packed=packed, n_valid=n_valid)

    # expand_split_kernel: m = 1..8
    for i, m in enumerate(range(1, 9)):
        kind = by_m.get(m, "runheavy")
        t = split[kind]
        mt = max(1, m - 1)
        table = t.table if t.m == m else t.table[:, :2 * t.s + 9 * (1 + mt)].contiguous()
        cut = "" if t.m == m else f" (the {kind} table's tail slots cut to {mt})"
        k, lanes = shapes[i % 4]
        xs, st = u8(k, lanes), below(t.s, k, lanes)
        add(f"expand_pass_split m={m} S={t.s} k={k} lanes={lanes}{cut}",
            split_instantiation(m, mt), cuda_fsm8.expand_pass_split, xs, st, table, m, mt)

    # expand_kernel: staged at S = 128 for m <= 3, through L2 at S = 256 for m = 1..8
    full_cases = [(1, "text", 128), (2, "few", 128), (3, "text", 128),
                  (1, "uniform", 256), (2, "wide2", 256), (3, "wide3", 256),
                  (4, "skewed", 256), (5, "runheavy", 256), (6, "runheavy", 256),
                  (7, "runheavy", 256), (8, "runheavy", 256)]
    for i, (m, kind, s) in enumerate(full_cases):
        t = full[kind]
        assert t.s == s, (kind, t.s)
        table = t.table if t.m == m else t.table[:, :(m + 1) * s].contiguous()
        cut = "" if t.m == m else f" (the {kind} table's first {m + 1} rows)"
        k, lanes = shapes[i % 4]
        xs, st = u8(k, lanes), below(s, k, lanes)
        add(f"expand_pass m={m} S={s} k={k} lanes={lanes}{cut}",
            expand_instantiation(m, s, smem_max), cuda_fsm8.expand_pass, xs, st, table, m)

    # pack_kernel: 16-byte and byte loads, one and several rounds of 1,024
    # steps, a partly live last block
    codes, lengths = code_tensors_for(blobs["text"], device)
    text = np.frombuffer(corpora["text"], np.uint8)
    for lanes, steps in ((33, 1024), (7, 100), (300, 2048), (1, 2000), (7, 17), (33, 3000)):
        blocks = dev(np.resize(text, lanes * steps).reshape(lanes, steps))
        valid = np.full(lanes, steps, np.int32)
        valid[-1] = steps - steps // 3
        valid = dev(valid)
        add(f"pack_blocks lanes={lanes} steps={steps}",
            pack_instantiation(steps, blocks.data_ptr()), cuda_pack.pack_blocks,
            blocks, valid, codes, lengths)

    # compaction: the staged tile (partial chunks of 64 rows) and the serial kernel
    for lanes, groups, sub, cap in ((33, 2, 64, 64), (7, 3, 100, 37), (300, 1, 512, 300),
                                    (1, 5, 1, 1), (7, 1, 2000, 1600)):
        wk = below(2**31 - 1, groups * sub, lanes, dtype=np.int32)
        ek = dev(rng.random((groups * sub, lanes)) < 0.6)
        add(f"compact_rows lanes={lanes} groups={groups} sub={sub} cap={cap}",
            compact_instantiation(cap, groups), cuda_compact.compact_rows, wk, ek, sub, cap)

    # symbols_kernel: packed words (counts, write) for m = 1..3 with invalid words and
    # padding lanes, partial chunks of 64 rows and tiles of 32 lanes; a plane's write
    for i, m in enumerate((1, 2, 3)):
        k, lanes = shapes[i + 3]
        raw = rng.integers(0, m + 1, (k, lanes))
        raw[rng.random((k, lanes)) < 0.05] = 16
        raw[:, lanes - lanes // 4:] = 0
        words = (raw << (8 * m) | rng.integers(0, 1 << (8 * m), (k, lanes))).astype(np.int32)
        ends = np.cumsum((raw & 15).sum(0))
        add(f"symbol_counts m={m} k={k} lanes={lanes}", symbols_instantiation(False, False),
            cuda_symbols.symbol_counts, dev(words), m)
        add(f"write_symbols m={m} k={k} lanes={lanes}", symbols_instantiation(False, True),
            cuda_symbols.write_symbols, dev(words), dev(ends), int(ends[-1]), m)
    for lanes, groups, cap in ((33, 3, 48), (7, 2, 16)):
        mini = rng.integers(0, cap + 1, (groups, lanes)).astype(np.int32)
        ends = np.cumsum(mini.sum(0))
        add(f"write_symbols plane lanes={lanes} groups={groups} cap={cap}",
            symbols_instantiation(True, True), cuda_symbols.write_symbols,
            u8(groups * cap, lanes), dev(ends), int(ends[-1]), 1, dev(mini), cap)

    # stitch_kernel (stitch.cu et_stitch_tile, one instantiation): planes of 1, 7, 33 and 300
    # lanes, partial chunks of 64 rows, full and empty subgroups, partial words with bits past
    # nbits set, base shifts inside a word with and without a carried word
    for lanes, groups, cap, shift, carried in ((1, 1, 1, 0, False), (7, 3, 48, 13, True),
                                               (33, 2, 16, 31, True), (300, 4, 100, 1, False)):
        counts = rng.integers(0, cap + 1, (groups, lanes)).astype(np.int32)
        counts[:, 0] = cap
        counts[0, -1] = 0
        nbits = rng.integers(0, 32, lanes).astype(np.int32)
        n_words = (shift + int(counts.sum()) * 32 + int(nbits.sum()) + 31) >> 5
        add(f"stitch_tile lanes={lanes} groups={groups} cap={cap} shift={shift} "
            f"carry={carried}", "stitch_kernel", cuda_stitch.stitch_tile,
            below(2**31 - 1, groups * cap, lanes, dtype=np.int32), dev(counts),
            dev(rng.integers(0, 2**32, lanes, dtype=np.uint32)), dev(nbits), shift, n_words,
            u8(4) if carried else None)

    # tables_kernel (tables.cu et_fsm_tables, one instantiation): S = 128 and 256, m = 1, 2,
    # 3, 4 and 8, two symbols (one internal node), and a trie with dead edges
    tries = {k: parse_header(b).table for k, b in blobs.items()}
    two_lengths, two_codes = np.zeros(256, np.uint8), np.zeros(256, np.uint32)
    two_lengths[[65, 66]], two_codes[66] = 1, 1
    tries["two"] = CodeTable(two_codes, two_lengths)
    pruned_lengths, pruned_codes = tries["text"].lengths.copy(), tries["text"].codes.copy()
    for sym in b"eq":
        pruned_lengths[sym] = pruned_codes[sym] = 0
    tries["pruned"] = CodeTable(pruned_codes, pruned_lengths)
    for kind in ("text", "uniform", "few", "wide3", "skewed", "runheavy", "two", "pruned"):
        children, leaf_sym = _build_trie(tries[kind])
        width, m, mt, s = cuda_tables.trie_layout(children, leaf_sym)
        add(f"fsm_tables {kind}: {children.shape[0]} nodes, S={width} m={m} s={s}",
            "tables_kernel", cuda_tables.fsm_tables, cuda_tables.pack_trie(children, leaf_sym),
            width, s, mt, device)
    return calls


def api_round_trips(device) -> list[str]:
    """One encode and one decode per route of a ~200 KB text and a ~200 KB
    skewed body, and a tiled decode at 7 lanes per tile, each checked
    byte for byte; returns a line per call."""
    import numpy as np

    import entreepy_tpu_torch as et
    from entreepy_tpu_torch.format import parse_header
    from entreepy_tpu_torch.ops import decode8

    rng = np.random.default_rng(13)
    zipf = 1.0 / np.arange(1, 257) ** 1.3
    text = (DATA / "a_midsummer_nights_dream.txt").read_bytes()
    bodies = {"text": (text * 2)[:200_000],
              "skewed": rng.choice(256, 200_000, p=zipf / zipf.sum()).astype(np.uint8).tobytes()}
    kw = {"backend": "device", "device": device}
    lines = []
    for name, data in bodies.items():
        blob = et.compress(data, **kw)
        if blob != et.compress(data, backend="host"):
            raise AssertionError(f"{name}: the device .et differs from the host's")
        lines.append(f"compress {name} {len(data)} B -> {len(blob)} B (== host)")
        for route in decode8.EXPAND_MODES:
            if et.decompress(blob, expand=route, **kw) != data:
                raise AssertionError(f"{name} expand={route}: round trip differs")
            lines.append(f"decompress {name} expand={route}: exact")
    blob = et.compress(bodies["text"], backend="host")
    hdr = parse_header(blob)
    out = decode8.decode_body_device_tiled(blob[hdr.body_start:], hdr.table, hdr.body_len,
                                           device=device, tile_lanes=7)
    if out.tobytes() != bodies["text"]:
        raise AssertionError("tiled decode at 7 lanes per tile differs")
    lines.append("tiled one-pass decode of text, 7 lanes per tile: exact")
    return lines


# ---- the guard bands: the same calls checked without a tool ----

GUARD_BYTES = 4096       # poisoned bytes on each side of a guarded tensor
POISONS = (0xA5, 0x5A)   # the two runs' poison bytes


class Guard:
    """Poisoned guard bands around every tensor of a call, for a check that
    needs no sanitizer.

    Inside ``with Guard(poison)``, each ``torch.empty`` of the port's Python
    code (the wrappers' outputs and scratch) returns the middle of a larger
    buffer whose every byte, guard bands included, holds ``poison``;
    :meth:`place` copies a call's input into such a buffer. A guard band
    that changed is a write out of bounds. Run the same call under two
    poisons: outputs that differ read memory that nothing wrote or that
    lies outside the inputs."""

    def __init__(self, poison: int):
        import torch

        self.torch, self.poison = torch, poison
        self.buffers = []  # (what, buffer, body bytes)

    def _body(self, nbytes: int, device, what: str):
        buf = self.torch.full((2 * GUARD_BYTES + nbytes,), self.poison,
                              dtype=self.torch.uint8, device=device)
        self.buffers.append((what, buf, nbytes))
        return buf[GUARD_BYTES:GUARD_BYTES + nbytes]

    def empty(self, *size, dtype=None, device=None, **kwargs):
        if kwargs:  # pinned host buffers and the like: not guarded
            return self._empty(*size, dtype=dtype, device=device, **kwargs)
        one = len(size) == 1 and isinstance(size[0], (tuple, list, self.torch.Size))
        shape = tuple(int(d) for d in (size[0] if one else size))
        dtype = dtype or self.torch.get_default_dtype()
        n = 1
        for d in shape:
            n *= d
        item = self._empty((), dtype=dtype).element_size()
        return self._body(n * item, device or "cpu", f"torch.empty{shape} {dtype}") \
            .view(dtype).view(shape)

    def place(self, t):
        """``t`` copied into a guarded buffer."""
        body = self._body(t.numel() * t.element_size(), t.device,
                          f"input {tuple(t.shape)} {t.dtype}")
        out = body.view(t.dtype).view(t.shape)
        out.copy_(t)
        return out

    def __enter__(self):
        self._empty = self.torch.empty
        self.torch.empty = self.empty
        return self

    def __exit__(self, *exc):
        self.torch.empty = self._empty

    def broken(self, since: int = 0) -> list[str]:
        """The buffers (made since the ``since``-th) whose guard bands changed."""
        bad = []
        for what, buf, n in self.buffers[since:]:
            band = self.torch.cat([buf[:GUARD_BYTES], buf[GUARD_BYTES + n:]])
            if not bool((band == self.poison).all()):
                bad.append(f"{what}: guard band overwritten")
        return bad

    def image(self, t) -> bytes:
        """The bytes of the guarded body that holds ``t`` (all of it: the
        padding of a padded row too), else of ``t`` itself."""
        for _, buf, n in self.buffers:
            start = buf.data_ptr() + GUARD_BYTES
            if start <= t.data_ptr() < start + max(n, 1):
                t = buf[GUARD_BYTES:GUARD_BYTES + n]
                break
        return t.detach().contiguous().cpu().view(self.torch.uint8).numpy().tobytes()


def _tensors(result) -> list:
    import torch

    items = result if isinstance(result, (tuple, list)) else (result,)
    return [t for t in items if isinstance(t, torch.Tensor)]


def guard_calls(calls: list[Call], device) -> list[str]:
    """Each call under a :class:`Guard` of each poison, its inputs placed in
    guarded buffers: returns a line per fault (a guard band overwritten, an
    input changed, outputs that differ between the poisons)."""
    import torch

    faults, images = [], {}
    for poison in POISONS:
        with Guard(poison) as g:
            for i, c in enumerate(calls):
                since = len(g.buffers)
                args = tuple(g.place(a) if isinstance(a, torch.Tensor) else a for a in c.args)
                out = c.run(args)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                faults += [f"{c.label} (poison {poison:#x}): {b}" for b in g.broken(since)]
                for a, b in zip(args, c.args):
                    if isinstance(a, torch.Tensor) and not torch.equal(a.cpu(), b.cpu()):
                        faults.append(f"{c.label}: wrote into its input {tuple(b.shape)}")
                images.setdefault(i, []).append([g.image(t) for t in _tensors(out)])
    for i, c in enumerate(calls):
        first, second = images[i]
        if first != second:
            faults.append(f"{c.label}: outputs differ between poisons "
                          f"{POISONS[0]:#x} and {POISONS[1]:#x}")
    return faults


def guard_api(device) -> list[str]:
    """:func:`api_round_trips` under a :class:`Guard` of each poison (every
    round trip byte-exact): returns a line per overwritten guard band."""
    faults = []
    for poison in POISONS:
        with Guard(poison) as g:
            api_round_trips(device)
        faults += [f"API round trips (poison {poison:#x}): {b}" for b in g.broken()]
    return faults


def profiled_instantiations(calls: list[Call], device) -> set[str]:
    """The port's kernel instantiations that torch.profiler sees while
    ``calls`` run on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in calls:
            c.run()
        torch.cuda.synchronize(device)
    names = {kernel_name(e.name) for e in prof.events()}
    return {n for n in names if n.split("<")[0] in PORT_KERNELS}


def run_calls(device) -> int:
    """Every call of :func:`plan`, then :func:`api_round_trips`; prints the
    call that reaches each instantiation and ``reached N/39``."""
    import torch

    missing = set(INSTANTIATIONS) ^ source_instantiations()
    if missing:
        print(f"sanitize_kernels: csrc/ and INSTANTIATIONS differ: {sorted(missing)}")
        return 1
    t0 = time.perf_counter()
    calls = plan(device)
    first: dict[str, str] = {}
    for c in calls:
        c.run()
        first.setdefault(c.instantiation, c.label)
    if device.type == "cuda":
        torch.cuda.synchronize()
    for inst in INSTANTIATIONS:
        print(f"sanitize_kernels: {inst} <- {first.get(inst, 'NOT REACHED')}")
    lines = api_round_trips(device)
    for line in lines:
        print(f"sanitize_kernels: api {line}")
    reached = sum(inst in first for inst in INSTANTIATIONS)
    print(f"sanitize_kernels: {len(calls)} kernel calls and {len(lines)} API calls in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"sanitize_kernels: reached {reached}/{len(INSTANTIATIONS)} instantiations")
    return 0 if reached == len(INSTANTIATIONS) else 1


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("sanitize_kernels: no CUDA device", file=sys.stderr)
        return 1
    return run_calls(device)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
