"""The port's CLI (``python -m entreepy_tpu_torch``) against the JAX
package's on the same command lines: equal output files, equal stdout and
stderr apart from the ``time taken`` line, the same exit codes; the port's
own ``--backend`` errors; no JAX in the process; the profiler trace."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from entreepy_tpu import cli as jcli  # noqa: E402
from entreepy_tpu.format import compress_host  # noqa: E402

from entreepy_tpu_torch import cli as tcli  # noqa: E402
from entreepy_tpu_torch import trace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def inputs(tmp_path, macbeth, tiny_text):
    """A directory of input files: text, its .et, a corrupt .et, an empty
    file."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "play.txt").write_bytes(macbeth)
    (src / "tiny.txt").write_bytes(tiny_text)
    (src / "play.txt.et").write_bytes(compress_host(macbeth))
    (src / "bad.et").write_bytes(b"this is not an et file at all")
    (src / "empty.txt").write_bytes(b"")
    return src


def _run(main, argv, workdir: Path, src: Path, monkeypatch, capsysbinary):
    """(exit code, stdout, stderr without the timing line, {file: bytes})
    of ``main(argv)`` run in a fresh copy of ``src``."""
    shutil.copytree(src, workdir)
    monkeypatch.chdir(workdir)
    capsysbinary.readouterr()
    rc = main(list(argv))
    out, err = capsysbinary.readouterr()
    out = b"\n".join(line for line in out.split(b"\n") if not line.startswith(b"time taken:"))
    files = {p.name: p.read_bytes() for p in sorted(workdir.iterdir())}
    return rc, out, err, files


@pytest.mark.parametrize("argv", [
    ["c", "play.txt"],
    ["d", "play.txt.et"],
    ["c", "play.txt", "-o", "out.et"],
    ["--output", "x.txt", "d", "play.txt.et"],
    ["-p", "d", "play.txt.et"],
    ["-pt", "d", "play.txt.et"],
    ["-td", "c", "tiny.txt"],
    ["-d", "c", "play.txt"],
    ["-ptd", "d", "play.txt.et", "-o", "y.txt"],
    ["--backend", "host", "c", "play.txt"],
    ["d", "bad.et"],
    ["c", "empty.txt"],
    ["c", "missing.txt"],
    ["-z", "c", "play.txt"],
    ["compress", "play.txt"],
    ["c"],
])
def test_cli_matches_jax(argv, inputs, tmp_path, monkeypatch, capsysbinary):
    got = _run(tcli.main, argv, tmp_path / "port", inputs, monkeypatch, capsysbinary)
    want = _run(jcli.main, argv, tmp_path / "jax", inputs, monkeypatch, capsysbinary)
    assert got == want


def test_cli_round_trip(inputs, tmp_path, monkeypatch, macbeth):
    work = tmp_path / "rt"
    shutil.copytree(inputs, work)
    monkeypatch.chdir(work)
    assert tcli.main(["c", "play.txt", "-o", "a.et"]) == 0
    assert (work / "a.et").read_bytes() == compress_host(macbeth)
    assert tcli.main(["d", "a.et"]) == 0
    assert (work / "decoded_a").read_bytes() == macbeth


def test_help_text(capsys):
    assert tcli.main([]) == 0
    out = capsys.readouterr().out
    assert out == tcli.HELP_TEXT
    assert out.startswith(jcli.REFERENCE_HELP_TEXT)
    assert "--backend" in out and "host | device | sharded" in out
    assert "not ported" not in out
    assert tcli.main(["--help"]) == 0 and capsys.readouterr().out == out


@pytest.mark.parametrize("argv,msg", [
    (["--backend", "sharded", "c", "play.txt"], "error: backend='sharded' needs a CUDA device"),
    (["--backend", "sharded", "d", "play.txt.et"], "error: backend='sharded' needs a CUDA device"),
    (["--backend", "device", "c", "play.txt"], "error: backend='device' needs a CUDA device"),
    (["--backend", "device", "d", "play.txt.et"], "error: backend='device' needs a CUDA device"),
])
def test_backend_errors_exit_1(argv, msg, inputs, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(inputs)
    assert tcli.main(argv) == 1
    err = capsys.readouterr().err
    assert err.startswith(msg) and "Traceback" not in err
    assert not (inputs / "play.txt.et.et").exists()


def _imports(args, cwd):
    """``python -X importtime -m entreepy_tpu_torch *args``: (result, names
    of the modules the process imported)."""
    r = subprocess.run([sys.executable, "-X", "importtime", "-m", "entreepy_tpu_torch", *args],
                       cwd=cwd, capture_output=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                            "HOME": str(cwd)})
    names = {line.rsplit(b"|", 1)[1].strip().decode()
             for line in r.stderr.splitlines() if line.startswith(b"import time:")}
    return r, names


@pytest.mark.parametrize("args", [["--help"], ["c", "play.txt"]])
def test_module_entry_leaves_jax_out(args, inputs):
    r, names = _imports(args, inputs)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "entreepy_tpu_torch.cli" in names
    assert not [n for n in names if n == "jax" or n.startswith("jax.")]
    if args[0] == "c":  # auto on the CPU: the host codec, then back
        text = (inputs / "play.txt").read_bytes()
        assert (inputs / "play.txt.et").read_bytes() == compress_host(text)
        r, names = _imports(["d", "play.txt.et", "-o", "back.txt"], inputs)
        assert r.returncode == 0 and (inputs / "back.txt").read_bytes() == text
        assert not [n for n in names if n == "jax" or n.startswith("jax.")]


def test_maybe_profile_writes_trace(tmp_path, monkeypatch, macbeth):
    out = tmp_path / "prof"
    monkeypatch.setenv("ENTREEPY_PROFILE", str(out))
    with trace.maybe_profile() as prof:
        import entreepy_tpu_torch

        entreepy_tpu_torch.compress(macbeth, backend="device", device="cpu")
    traces = list(out.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert any(e.key.startswith("aten::") for e in prof.key_averages())


def test_maybe_profile_off_without_env(tmp_path, monkeypatch):
    monkeypatch.delenv("ENTREEPY_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace.maybe_profile() as prof:
        pass
    assert prof is None
    assert list(tmp_path.iterdir()) == []
