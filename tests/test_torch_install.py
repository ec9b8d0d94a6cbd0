"""entreepy_tpu_torch as a wheel: built from a copy of the package files
(never in the tree), installed with ``pip install --target``, and run from an
empty working directory with a fresh ``XDG_CACHE_HOME``, no nvcc and no g++
on ``PATH`` (``tools/installed_check.py``). Here the wheel holds no kernel
library (no nvcc), so the device backend runs on the CPU's plain versions;
``chip_smoke.py``'s ``[install]`` phase runs the bundled kernels on the card.
"""

import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from entreepy_tpu.format import compress_host  # noqa: E402

from entreepy_tpu_torch import _build  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import installed_check as ic  # noqa: E402

PORT_RUNTIME = "entreepy_tpu_torch/runtime/_native_ext.so"


def _files(root: Path) -> set:
    return {p.relative_to(root) for p in root.rglob("*")}


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """(wheel, site, cache, the site's files after the installed run, the
    run's report, its output dir) of the wheel built and installed once."""
    work = tmp_path_factory.mktemp("install")
    wheel = ic.build_wheel(ROOT, work)
    site, cache, cwd = work / "site", work / "cache", work / "cwd"
    ic.install(wheel, site)
    cache.mkdir()
    cwd.mkdir()
    before = _files(site)
    data = ROOT / "tests" / "data" / "a_midsummer_nights_dream.txt"
    report = ic.drive(site, cache, cwd, data, work / "out", device="cpu")
    return {"wheel": wheel, "site": site, "cache": cache, "cwd": cwd, "before": before,
            "after": _files(site), "report": report, "out": work / "out"}


def _site_copy(installed, tmp_path) -> Path:
    site = tmp_path / "site"
    shutil.copytree(installed["site"], site, symlinks=True)
    return site


def _run(site: Path, cache: Path, cwd: Path, code: str, *path: str):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          env=ic.bare_env(site, cache, *path), capture_output=True,
                          text=True, timeout=300)


def test_wheel_bundles_the_port(installed):
    """The port's portable runtime, its sources and its console script are
    in the wheel beside the JAX package's; a kernel library of the current
    key exactly where nvcc built the wheel."""
    with zipfile.ZipFile(installed["wheel"]) as z:
        names = set(z.namelist())
        scripts = next(z.read(n).decode() for n in names if n.endswith("entry_points.txt"))
    assert {PORT_RUNTIME, "entreepy_tpu/runtime/_native_ext.so",
            "entreepy_tpu_torch/runtime/native.cpp", "entreepy_tpu_torch/csrc/fsm8.cu"} <= names
    kernels = {n for n in names if n.startswith("entreepy_tpu_torch/kernels-")}
    want = f"entreepy_tpu_torch/{_build.library_name()}"
    assert kernels == ({want, want[:-3] + ".log"} if _build.nvcc_path() else set())
    assert "entreepy-torch = entreepy_tpu_torch.cli:main" in scripts


def test_installed_run_loads_the_bundled_runtime(installed):
    report, site = installed["report"], installed["site"]
    assert report["package"] == str(site / "entreepy_tpu_torch" / "__init__.py")
    assert report["runtime"] == str(site / PORT_RUNTIME)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_installed_run_matches_jax(installed, midsummer, backend):
    """.et bytes equal to the JAX package's host codec with
    backend="host" and backend="device", device="cpu"; every round trip
    exact (the device's through each expand= route)."""
    assert (installed["out"] / f"{backend}.et").read_bytes() == compress_host(midsummer)
    decoded = installed["report"]["decoded"]
    assert decoded == {"host": True, **{route: True for route in ic.ROUTES}}


def test_installed_run_writes_nothing(installed):
    """No file in the fresh cache, none added or removed under the target."""
    assert not any(installed["cache"].iterdir())
    assert installed["after"] == installed["before"]
    assert not any(installed["cwd"].iterdir())


def test_installed_run_imports_no_jax(installed):
    assert installed["report"]["modules"] == []


def test_build_dir_rule(installed):
    """A checkout builds under its own build/; an installed package in the
    per-user cache."""
    assert _build.build_dir() == ROOT / "build" / "entreepy_tpu_torch"
    r = _run(installed["site"], installed["cache"], installed["cwd"],
             "from entreepy_tpu_torch import _build, runtime\n"
             "print(_build.build_dir()); print(runtime.library_path().parent)")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(installed["cache"] / "entreepy_tpu_torch")] * 2


def test_runtime_builds_into_the_user_cache(installed, tmp_path):
    """With g++ on PATH and no bundled runtime, the -march=native build
    lands in $XDG_CACHE_HOME/entreepy_tpu_torch/native-<key>.so."""
    site, cache = _site_copy(installed, tmp_path), tmp_path / "cache"
    (site / PORT_RUNTIME).unlink()
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    r = _run(site, cache, cwd,
             "from entreepy_tpu_torch import runtime\n"
             "assert runtime.available()\n"
             "print(runtime._load()._name)",
             str(Path(shutil.which("g++")).parent))
    assert r.returncode == 0, r.stderr
    so = Path(r.stdout.strip())
    assert so.parent == cache / "entreepy_tpu_torch" and so.name.startswith("native-")
    assert _files(cache) == {Path("entreepy_tpu_torch"), so.relative_to(cache)}
    assert not (site / "build").exists() and not any(cwd.iterdir())


def test_kernel_library_missing_raises(installed, tmp_path):
    """No library of the current key and no nvcc: the first build raises,
    naming every place it looked; a bundled library of another key is not
    taken."""
    site, cache = _site_copy(installed, tmp_path), tmp_path / "cache"
    pkg = site / "entreepy_tpu_torch"
    (pkg / "kernels-0000000000000000.so").write_bytes(b"not this one")
    r = _run(site, cache, installed["cwd"],
             "from entreepy_tpu_torch import _build\n"
             "try:\n"
             "    _build.build()\n"
             "except RuntimeError as e:\n"
             "    print(e)\n"
             "else:\n"
             "    raise SystemExit('no error')\n")
    assert r.returncode == 0, r.stderr
    msg = r.stdout
    assert f"no kernel library {_build.library_name()}" in msg
    for place in (pkg, cache / "entreepy_tpu_torch", "PATH", "/dev/null/bin/nvcc"):
        assert str(place) in msg, (place, msg)
    assert not cache.exists()


def test_kernel_library_lookup_order(installed, tmp_path):
    """The bundled library of the current key comes first, the one built in
    the cache second."""
    site, cache = _site_copy(installed, tmp_path), tmp_path / "cache"
    r = _run(site, cache, installed["cwd"],
             "from entreepy_tpu_torch import _build\n"
             "built = _build.build_dir() / _build.library_name()\n"
             "built.parent.mkdir(parents=True)\n"
             "built.write_bytes(b'')\n"
             "print(_build.build())\n"
             "(_build.PKG_DIR / built.name).write_bytes(b'')\n"
             "print(_build.build())\n")
    assert r.returncode == 0, r.stderr
    name = _build.library_name()
    assert r.stdout.split() == [str(cache / "entreepy_tpu_torch" / name),
                                str(site / "entreepy_tpu_torch" / name)]


def test_bundled_runtime_without_entry_point_raises(installed, tmp_path):
    """A bundled runtime that lacks an entry point raises on every call,
    never leaving the host codec quietly on numpy."""
    site = _site_copy(installed, tmp_path)
    (tmp_path / "other.cpp").write_text('extern "C" int et_other(void) { return 0; }\n')
    r = subprocess.run(["g++", "-shared", "-fPIC", "-o", str(site / PORT_RUNTIME),
                        str(tmp_path / "other.cpp")], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    r = _run(site, tmp_path / "cache", installed["cwd"],
             "from entreepy_tpu_torch import runtime\n"
             "for _ in range(2):\n"
             "    try:\n"
             "        runtime.available()\n"
             "    except AttributeError as e:\n"
             "        print(e)\n")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 2 and all("et_pack_body" in line for line in lines), lines


@pytest.mark.parametrize("mode", ["c", "d"])
def test_console_script_matches_module(installed, tmp_path, macbeth, mode):
    """``entreepy-torch`` from the target's bin/ against ``python -m
    entreepy_tpu_torch``, both installed: equal exit code, output apart from
    the timing line, and files."""
    name = "play.txt" if mode == "c" else "play.txt.et"
    runs = []
    for label, cmd in (("script", [str(installed["site"] / "bin" / "entreepy-torch")]),
                       ("module", [sys.executable, "-m", "entreepy_tpu_torch"])):
        cwd = tmp_path / label
        cwd.mkdir()
        (cwd / name).write_bytes(macbeth if mode == "c" else compress_host(macbeth))
        runs.append((cwd, subprocess.Popen(
            [*cmd, mode, name], cwd=cwd, env=ic.bare_env(installed["site"], installed["cache"]),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    got = []
    for cwd, proc in runs:  # both at once
        stdout, stderr = proc.communicate(timeout=300)
        out = [ln for ln in stdout.splitlines() if not ln.startswith(b"time taken:")]
        got.append((proc.returncode, out, stderr,
                    {p.name: p.read_bytes() for p in cwd.iterdir()}))
    assert got[0] == got[1]
    rc, _, _, files = got[0]
    assert rc == 0
    if mode == "c":
        assert files["play.txt.et"] == compress_host(macbeth)
    else:
        assert files["decoded_play.txt"] == macbeth
