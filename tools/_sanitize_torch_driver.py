"""Drives every entry point of entreepy_tpu_torch's C++ host runtime for
tools/sanitize_torch.sh.

Expects ENTREEPY_NATIVE_LIB to point at a TSAN- or ASAN-instrumented build of
entreepy_tpu_torch/runtime/native.cpp (the script preloads the sanitizer
runtime); without it the port's own build is used, uninstrumented. Each of
the 12 entry points of ``runtime._ENTRIES`` is reached directly and through
the port's callers: the host backend's compress/decompress, the
``expand="host"`` route on ``device="cpu"`` (``decode8.expand_states``), the
sharded ``host`` route at one rank on the CPU (``dist._expand_chunks``) and
the device encode's stitch on the CPU (``stitch_flat_payload``); then the
error paths: a truncated stream, a LUT hole and an under-claimed
``pack_body_sized`` (the ASAN target). Prints each entry point's calls and
exits non-zero if one was never reached.

    python tools/_sanitize_torch_driver.py
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import entreepy_tpu_torch as et  # noqa: E402
from entreepy_tpu_torch import runtime  # noqa: E402
from entreepy_tpu_torch.format import (  # noqa: E402
    build_code_table,
    build_decode_lut,
    compress_host,
    decompress_host,
    parse_header,
)
from entreepy_tpu_torch.format.fsm8 import build_byte_fsm  # noqa: E402
from entreepy_tpu_torch.utils.stitch import stitch_words  # noqa: E402

lib = runtime._load()
assert lib is not None, "native runtime failed to load (check ENTREEPY_NATIVE_LIB)"
override = os.environ.get("ENTREEPY_NATIVE_LIB")
assert not override or lib._name == override, f"loaded {lib._name}, not {override}"
print(f"sanitize driver: runtime {lib._name}", flush=True)

# every entry point counts its calls, whoever makes them
calls = {name: 0 for name, _, _ in runtime._ENTRIES}


def _counting(name, fn):
    def call(*args):
        calls[name] += 1
        return fn(*args)
    return call


for _name in calls:
    setattr(lib, _name, _counting(_name, getattr(lib, _name)))


def expect_error(kind, fn, what: str) -> None:
    try:
        fn()
    except kind:
        return
    raise SystemExit(f"sanitize driver: {what} not detected")


rng = np.random.default_rng(7)
corpora = {
    "text": (ROOT / "tests/data/a_midsummer_nights_dream.txt").read_bytes() * 20,
    "random": rng.integers(0, 256, 2_000_000, dtype=np.uint8).tobytes(),
    "runheavy": b"a" * 1_500_000 + bytes(range(256)) * 10 + b"a" * 200_000,
}

for name, data in corpora.items():
    arr = np.frombuffer(data, np.uint8)
    blob = compress_host(data)  # threaded histogram + sized parallel pack
    assert decompress_host(blob) == data, name  # byte-FSM parallel decode
    assert et.decompress(et.compress(data, backend="host"), backend="host") == data, name
    hdr = parse_header(blob)
    body = blob[hdr.body_start:]
    table = hdr.table
    # the host pack explicitly: threaded (with its histogram) and serial
    packed, bits = runtime.pack_body(arr, table.codes, table.lengths)
    assert packed == body, name
    small = arr[:100_000]
    assert runtime.pack_body(small, table.codes, table.lengths) is not None
    assert np.array_equal(runtime.histogram(arr), np.bincount(arr, minlength=256))
    # the LUT gap-array decode, threaded, and its serial walk on the truncated stream
    lut = build_decode_lut(table)
    out = runtime.unpack_body(body, lut.flat, lut.lookup_bits, arr.size)
    assert out is not None and out.tobytes() == data, name
    expect_error(ValueError, lambda: runtime.unpack_body(
        body[:50], lut.flat, lut.lookup_bits, arr.size), f"{name}: truncated stream (lut)")
    # the byte-FSM chunk decode (threaded; re-walks on the run-heavy body)
    fsm = build_byte_fsm(table)
    res = runtime.fsm8_decode_parallel(body, fsm.next_state, fsm.counts, fsm.syms, arr.size)
    assert res is not None and res[0].tobytes() == data, name
    expect_error(ValueError, lambda: runtime.fsm8_decode_parallel(
        body[:50], fsm.next_state, fsm.counts, fsm.syms, arr.size),
        f"{name}: truncated stream (fsm8)")
    # the port's callers on the CPU, on the corpus's last 300 KB: the device
    # encode's stitch, the host-expansion route, the sharded host route
    part = data[-300_000:]
    part_blob = et.compress(part, backend="device", device="cpu")
    assert part_blob == compress_host(part), name
    assert et.decompress(part_blob, backend="device", device="cpu", expand="host") == part
    assert et.decompress(part_blob, backend="sharded", device="cpu", expand="host") == part
    print(f"sanitize driver: {name} ok ({len(data)} B)", flush=True)

# et_map_bytes: the aligned-8 byte map, and its hole error path
lut16 = np.arange(256, dtype=np.int16)[::-1].copy()
blob = rng.integers(0, 256, 1_000_000, dtype=np.uint8)
mapped = runtime.map_bytes(blob, lut16)
assert mapped is not None and np.array_equal(mapped, 255 - blob)
lut_hole = lut16.copy()
lut_hole[blob[12345]] = -1
expect_error(ValueError, lambda: runtime.map_bytes(blob, lut_hole), "map_bytes: LUT hole")

# et_fsm8_expand and et_fsm8_expand_chunks on the states of a serial walk
data = corpora["text"][:400_000]
arr = np.frombuffer(data, np.uint8)
blob = compress_host(data)
hdr = parse_header(blob)
body = np.frombuffer(blob, np.uint8)[hdr.body_start:]
fsm = build_byte_fsm(hdr.table)
states = np.empty(body.size, np.uint8)
s = 0
nxt = fsm.next_state
for i, b in enumerate(body.tolist()):
    states[i] = s
    s = int(nxt[s, b])
out, end = runtime.fsm8_expand(states, body, fsm.counts, fsm.syms, arr.size)
assert out.tobytes() == data and end == body.size - 1
m = max(1, int(fsm.counts.max()))
rows, pc, w_inv = runtime.fsm8_expand_chunks(states, body, fsm.counts, fsm.syms, 4096, m)
got = np.concatenate([rows[c, : pc[c]] for c in range(pc.size)])
assert got[: arr.size].tobytes() == data
assert (w_inv == -1).all()

# et_stitch_flat against the numpy stitch
lanes, capw = 23, 7
flat = rng.integers(0, 2**32, size=lanes * capw, dtype=np.uint64).astype(np.uint32)
bit_lens = rng.integers(0, capw * 32 - 31, size=lanes).astype(np.int64)
offs = (np.arange(lanes) * capw).astype(np.int64)
views = []
for lane in range(lanes):
    nw = (int(bit_lens[lane]) + 31) // 32
    flat[offs[lane] + nw: offs[lane] + capw] = 0
    rem = int(bit_lens[lane]) & 31
    if rem and nw:
        flat[offs[lane] + nw - 1] &= np.uint32(0xFFFFFFFF) << (32 - rem)
    views.append(flat[offs[lane]: offs[lane] + capw])
ref_words, ref_total = stitch_words(views, bit_lens)
nat_words, nat_total = runtime.stitch_flat(flat, offs, bit_lens)
assert nat_total == ref_total
assert np.array_equal(nat_words[: ref_total // 32 + 1], ref_words[: ref_total // 32 + 1])

# et_pack_parallel_sized's budget guard: an under-claimed block must fail,
# not write past its claim
counts_blocks = runtime.histogram_blocks(arr)
table = build_code_table(counts_blocks.sum(axis=0))
bad_bits = counts_blocks @ table.lengths.astype(np.int64)
bad_bits[0] -= 640
expect_error(RuntimeError, lambda: runtime.pack_body_sized(
    arr, table.codes, table.lengths, bad_bits), "pack_body_sized: under-claim")

for name, n in calls.items():
    print(f"sanitize driver: {name} {n} calls", flush=True)
missed = [name for name, n in calls.items() if n == 0]
if missed:
    raise SystemExit(f"sanitize driver: entry points never reached: {missed}")
print(f"sanitize driver: all {len(calls)} entry points reached", flush=True)
