"""The port's own copies of the JAX package's framework-free modules
(``entreepy_tpu_torch.format``, ``.runtime``, ``.utils`` and the CLI's parser)
against their originals, and the port imported and run alone: no module of
``entreepy_tpu`` and no JAX in the process."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from entreepy_tpu import cli as jcli  # noqa: E402
from entreepy_tpu import format as jfmt  # noqa: E402
from entreepy_tpu import runtime as jrt  # noqa: E402
from entreepy_tpu.format import fsm8 as jfsm8  # noqa: E402
from entreepy_tpu.utils import stitch as jstitch  # noqa: E402
from entreepy_tpu.utils.fmt import format_file_size as jsize  # noqa: E402

from entreepy_tpu_torch import cli as tcli  # noqa: E402
from entreepy_tpu_torch import format as tfmt  # noqa: E402
from entreepy_tpu_torch import runtime as trt  # noqa: E402
from entreepy_tpu_torch.format import fsm8 as tfsm8  # noqa: E402
from entreepy_tpu_torch.utils import stitch as tstitch  # noqa: E402
from entreepy_tpu_torch.utils.fmt import format_file_size as tsize  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _corpus(name: str, request) -> bytes:
    if name in ("tiny_text", "macbeth", "midsummer"):
        return request.getfixturevalue(name)
    rng = np.random.default_rng(99)
    if name == "random":
        return rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
    if name == "skewed":  # m > 3
        p = 1.0 / np.arange(1, 257) ** 1.3
        return rng.choice(256, 20_000, p=p / p.sum()).astype(np.uint8).tobytes()
    if name == "runheavy":  # m = 8
        return (b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()) * 3
    if name == "single":  # one symbol: no code table
        return b"z" * 1000
    raise ValueError(name)


def _outcome(fn):
    """fn()'s value, or (exception type name, message) if it raises."""
    try:
        return fn()
    except (ValueError, tcli.CliError, jcli.CliError) as e:
        return (type(e).__name__, str(e))


def _same(a, b) -> None:
    """Deep equality of values that may hold numpy arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def _table(mod, data: bytes):
    return mod.build_code_table(mod.histogram(np.frombuffer(data, np.uint8)))


def _check_codec(data: bytes) -> None:
    got = _outcome(lambda: tfmt.compress_host(data))
    _same(got, _outcome(lambda: jfmt.compress_host(data)))
    if isinstance(got, bytes):
        assert tfmt.decompress_host(got) == jfmt.decompress_host(got) == data


def _check_header(data: bytes) -> None:
    et = _outcome(lambda: jfmt.compress_host(data))
    if not isinstance(et, bytes):
        _same(_outcome(lambda: _table(tfmt, data)), _outcome(lambda: _table(jfmt, data)))
        return
    want, got = jfmt.parse_header(et), tfmt.parse_header(et)
    _same((got.version, got.body_len, got.body_start, got.table.codes, got.table.lengths),
          (want.version, want.body_len, want.body_start, want.table.codes, want.table.lengths))
    bad = b"XX" + et[2:]
    _same(_outcome(lambda: tfmt.parse_header(bad)), _outcome(lambda: jfmt.parse_header(bad)))


def _check_code_table(data: bytes) -> None:
    arr = np.frombuffer(data, np.uint8)
    _same(tfmt.histogram(arr), jfmt.histogram(arr))
    got, want = _outcome(lambda: _table(tfmt, data)), _outcome(lambda: _table(jfmt, data))
    if isinstance(want, tuple):
        _same(got, want)
        return
    _same((got.codes, got.lengths, got.max_len, got.min_len, got.num_symbols),
          (want.codes, want.lengths, want.max_len, want.min_len, want.num_symbols))


def _fsms(data: bytes):
    """(port fsm, JAX fsm) of data's code table, or None without one."""
    try:
        return (tfsm8.build_byte_fsm(_table(tfmt, data)),
                jfsm8.build_byte_fsm(_table(jfmt, data)))
    except ValueError:
        return None


def _check_byte_fsm(data: bytes) -> None:
    pair = _fsms(data)
    if pair is None:
        return
    got, want = pair
    _same((got.next_state, got.counts, got.syms, got.n_states, got.width),
          (want.next_state, want.counts, want.syms, want.n_states, want.width))


def _check_fsm_tensors(data: bytes) -> None:
    pair = _fsms(data)
    if pair is None:
        return
    got, want = pair
    for fn in ("fused_decode_tensors", "expand_tensors", "split_expand_tensors"):
        _same(getattr(tfsm8, fn)(got), getattr(jfsm8, fn)(want))


def _check_stitch(data: bytes) -> None:
    rng = np.random.default_rng(len(data))
    words = np.frombuffer(data + bytes(-len(data) % 4), np.uint32).copy()
    cuts = np.sort(rng.integers(0, words.size + 1, 7))
    nwords = np.diff(np.concatenate([[0], cuts, [words.size]])).astype(np.int64)
    bit_lens = np.maximum(nwords * 32 - rng.integers(0, 32, nwords.size), 0)
    _same(tstitch.stitch_flat_payload(words, nwords, bit_lens),
          jstitch.stitch_flat_payload(words, nwords, bit_lens))
    out, total = tstitch.stitch_words(list(words.reshape(1, -1)), [words.size * 32])
    assert tstitch.words_to_bytes(out, total) == jstitch.words_to_bytes(out, total)


def _stream_states(data: bytes):
    """(fsm, packed body, each body byte's state before its transition) of
    data's code table, or None without one."""
    try:
        table = _table(jfmt, data)
    except ValueError:
        return None
    body, _ = jrt.pack_body(np.frombuffer(data, np.uint8), table.codes, table.lengths)
    fsm = jfsm8.build_byte_fsm(table)
    buf = np.frombuffer(body, np.uint8)
    states = np.zeros(buf.size, np.uint8)
    state = 0
    for i, b in enumerate(buf):
        states[i] = state
        state = fsm.next_state[state, b]
    return fsm, buf, states


def _check_runtime(data: bytes) -> None:
    assert trt.available() and jrt.available()
    arr = np.frombuffer(data, np.uint8)
    _same(trt.histogram(arr), jrt.histogram(arr))
    got = _stream_states(data)
    if got is None:
        return
    table = _table(jfmt, data)
    _same(trt.pack_body(arr, table.codes, table.lengths),
          jrt.pack_body(arr, table.codes, table.lengths))
    fsm, buf, states = got
    for n in (arr.size, arr.size + 1):  # exact, then one symbol short of the stream
        _same(_outcome(lambda: trt.fsm8_expand(states, buf, fsm.counts, fsm.syms, n)),
              _outcome(lambda: jrt.fsm8_expand(states, buf, fsm.counts, fsm.syms, n)))
    assert tsize(len(data)) == jsize(len(data))


def _check_split_stitch(data: bytes) -> None:
    """split_blocks, and stitch_flat_payload with offsets that lay the
    blocks out of order in the flat array (the sharded encode's layout)."""
    arr = np.frombuffer(data, np.uint8)
    for block_bytes in (64, 1000, 1 << 16):
        _same(tstitch.split_blocks(arr, block_bytes), jstitch.split_blocks(arr, block_bytes))
    rng = np.random.default_rng(len(data) + 1)
    words = np.frombuffer(data + bytes(-len(data) % 4), np.uint32).copy()
    cuts = np.sort(rng.integers(0, words.size + 1, 7))
    nwords = np.diff(np.concatenate([[0], cuts, [words.size]])).astype(np.int64)
    bit_lens = np.maximum(nwords * 32 - rng.integers(0, 32, nwords.size), 0)
    order = rng.permutation(nwords.size)  # block order[i] is the i-th in the flat array
    offs = np.empty(nwords.size, np.int64)
    offs[order] = np.cumsum(nwords[order]) - nwords[order]
    _same(tstitch.stitch_flat_payload(words, nwords, bit_lens, offs=offs),
          jstitch.stitch_flat_payload(words, nwords, bit_lens, offs=offs))


def _check_expand_chunks(data: bytes) -> None:
    """runtime.fsm8_expand_chunks on the stream's states and on random ones
    (invalid transitions): each chunk's live symbols, counts and w_inv."""
    got = _stream_states(data)
    if got is None:
        return
    fsm, buf, states = got
    m = max(1, int(fsm.counts.max(initial=1)))
    rand = np.random.default_rng(5).integers(0, fsm.n_states, buf.size).astype(np.uint8)
    for st in (states, rand):
        for chunk in (16, 512):
            rows, counts, w_inv = trt.fsm8_expand_chunks(st, buf, fsm.counts, fsm.syms, chunk, m)
            want = jrt.fsm8_expand_chunks(st, buf, fsm.counts, fsm.syms, chunk, m)
            _same((counts, w_inv), want[1:])
            for c, k in enumerate(counts):  # past a chunk's count the rows are unspecified
                _same(rows[c, :k], want[0][c, :k])


def _check_cli(_data: bytes) -> None:
    assert tcli.REFERENCE_HELP_TEXT == jcli.REFERENCE_HELP_TEXT
    assert tcli.HELP_TEXT.startswith(jcli.REFERENCE_HELP_TEXT)
    for argv in ([], ["c", "a.txt"], ["d", "dir/a.txt.et"], ["-ptd", "d", "a.et", "-o", "b"],
                 ["--backend", "host", "c", "a"], ["--backend", "sharded", "c", "a"],
                 ["-h", "c", "a"], ["--help"], ["-o"], ["--backend"], ["--backend", "tpu"],
                 ["-z"], ["compress", "a"], ["c"], ["--print", "--test", "d", "x.et"]):
        _same(_outcome(lambda: vars(tcli.parse_args(list(argv)))),
              _outcome(lambda: vars(jcli.parse_args(list(argv)))))
    for mode, name in (("compress", "a.txt"), ("decompress", "dir/a.txt.et"),
                       ("decompress", "b.et")):
        assert tcli.default_output_name(mode, name) == jcli.default_output_name(mode, name)


CHECKS = {
    "codec": _check_codec, "header": _check_header, "code_table": _check_code_table,
    "byte_fsm": _check_byte_fsm, "fsm_tensors": _check_fsm_tensors, "stitch": _check_stitch,
    "runtime": _check_runtime, "split_stitch": _check_split_stitch,
    "expand_chunks": _check_expand_chunks,
}
CORPORA = ["tiny_text", "macbeth", "midsummer", "random", "skewed", "runheavy", "single"]


@pytest.mark.parametrize("check,corpus", [(c, n) for c in CHECKS for n in CORPORA]
                         + [("cli", "none")])
def test_copy_matches_jax(check, corpus, request):
    data = b"" if corpus == "none" else _corpus(corpus, request)
    {**CHECKS, "cli": _check_cli}[check](data)


def test_cli_dump_matches_jax(capsysbinary, macbeth):
    tcli._dump_dictionary(macbeth)
    got = capsysbinary.readouterr()
    jcli._dump_dictionary(macbeth)
    assert got == capsysbinary.readouterr() and got.out


def test_runtime_builds_under_the_port():
    """The port builds its own host runtime, never the JAX package's."""
    so = trt.library_path()
    assert so.parent == ROOT / "build" / "entreepy_tpu_torch"
    assert so.name.startswith("native-") and trt.available() and so.exists()


# Modules of the port the walk below imports: 29 before the bench, and the
# bench package with its seven modules.
PORT_MODULES = 29 + 8


def test_port_imports_no_jax_package():
    """Every module of the port but the ``__main__`` ones (which run their
    entry point when imported), a host round trip and the CLI's help leave
    no module of entreepy_tpu (nor JAX) in the process. The script's last
    line counts the modules it imported, so a script that ends early fails."""
    code = (
        "import pkgutil, sys\n"
        "import entreepy_tpu_torch as et\n"
        "n = 0\n"
        "for m in pkgutil.walk_packages(et.__path__, 'entreepy_tpu_torch.'):\n"
        "    if m.name.rsplit('.', 1)[-1] != '__main__':\n"
        "        __import__(m.name)\n"
        "        n += 1\n"
        "from entreepy_tpu_torch import cli\n"
        "data = b'a round trip on the host codec' * 50\n"
        "assert et.decompress(et.compress(data, backend='host'), backend='host') == data\n"
        "assert cli.main(['-h']) == 0\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('entreepy_tpu', 'jax'))\n"
        "assert not bad, bad\n"
        "print(f'imported {n} modules')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(tcli.HELP_TEXT)
    last = r.stdout.splitlines()[-1].split()
    assert last[0] == "imported" and last[2] == "modules", r.stdout[-200:]
    assert int(last[1]) >= PORT_MODULES


def test_native_lib_override(tmp_path):
    """ENTREEPY_NATIVE_LIB: the port loads that library as it is (how
    tools/sanitize_torch.sh injects its instrumented builds) and a host
    round trip runs through it; a path that does not load leaves the host
    runtime unavailable instead of failing."""
    so, other = tmp_path / "native_override.so", tmp_path / "no_entry_points.so"
    (tmp_path / "other.cpp").write_text('extern "C" int et_other(void) { return 0; }\n')
    not_lib = tmp_path / "not_a_library.so"
    not_lib.write_text("not a shared library")
    for src, dst in ((ROOT / "entreepy_tpu_torch" / "runtime" / "native.cpp", so),
                     (tmp_path / "other.cpp", other)):
        r = subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-pthread", "-o", str(dst),
                            str(src)], capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
    code = (
        "import os, sys\n"
        "from entreepy_tpu_torch import runtime\n"
        "import entreepy_tpu_torch as et\n"
        "lib = runtime._load()\n"
        "want = os.environ['ENTREEPY_NATIVE_LIB']\n"
        "if sys.argv[1] == 'good':\n"
        "    assert lib is not None and lib._name == want, lib\n"
        "    data = b'through the injected library ' * 20000\n"
        "    blob = et.compress(data, backend='host')\n"
        "    assert et.decompress(blob, backend='host') == data\n"
        "    assert runtime.histogram(bytearray(data))[ord('t')] == data.count(b't')\n"
        "else:\n"
        "    assert lib is None and runtime.available() is False\n"
        "    assert runtime.histogram(bytearray(b'abc')) is None\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "ENTREEPY_NO_NATIVE"}
    for case, path in (("good", so), ("bad", tmp_path / "missing.so"), ("bad", not_lib),
                       ("bad", other)):
        r = subprocess.run([sys.executable, "-c", code, case], cwd=ROOT, capture_output=True,
                           text=True, timeout=300, env={**env, "ENTREEPY_NATIVE_LIB": str(path)})
        assert r.returncode == 0 and r.stdout.strip() == "ok", (case, path, r.stderr)
