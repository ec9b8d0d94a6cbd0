"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` compile with ``nvcc`` into one shared library with
a plain C interface, ``kernels-<key>.so``, loaded with ``ctypes``: one ``nvcc``
per source, all started together, then one link. No PyTorch header is
included, so a build takes seconds. The key is a hash of the sources and
flags. :func:`build` takes the first of: the library a wheel bundles beside
this module (``setup.py`` compiles it with :func:`compile_library` where the
wheel is built with nvcc), the library built before in :func:`build_dir`, a
build with nvcc into that directory. Nothing builds at import: the first
kernel launch does. This module imports only the standard library, so
``setup.py`` loads it by its file path.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -lineinfo: line tables for the sanitizer's and profiler's reports (no change to the code)
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
BUILD_TIMEOUT_S = 900

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_count_lock = threading.Lock()


def build_dir() -> Path:
    """Where the port builds its libraries at first use: the kernels here,
    the host runtime in ``runtime``.

    - In a checkout, a package whose parent directory holds this repo's
      ``pyproject.toml``: ``<checkout>/build/entreepy_tpu_torch/``, which
      ``.gitignore`` lists.
    - Anywhere else (an installed package): the per-user cache
      ``$XDG_CACHE_HOME/entreepy_tpu_torch/`` (``~/.cache`` when unset), so
      an install never writes beside its site-packages.

    Decided from where the package sits; no variable or option chooses it."""
    root = checkout_root()
    if root is not None:
        return root / "build" / "entreepy_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "entreepy_tpu_torch"


def checkout_root() -> Path | None:
    """The root of the checkout this package sits in (its parent directory,
    when that holds this repo's ``pyproject.toml``), else None: an
    installed package."""
    root = PKG_DIR.parent
    pyproject = root / "pyproject.toml"
    if pyproject.is_file() and 'name = "entreepy-tpu"' in pyproject.read_text():
        return root
    return None


def _nvcc_fallback() -> Path:
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"


def nvcc_path() -> str | None:
    """``nvcc`` on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = _nvcc_fallback()
    return str(cand) if cand.exists() else None


def _sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def library_name() -> str:
    """File name of the library of the current sources and flags."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, "-shared")).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return f"kernels-{h.hexdigest()[:16]}.so"


def _nvcc(nvcc: str, args: list[str], what: str) -> str:
    """Run ``nvcc`` with ``args``; returns its stderr (ptxas's report),
    raises with it on failure."""
    r = subprocess.run([nvcc, *args], capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} (exit {r.returncode}):\n{r.stderr}")
    return r.stderr


def compile_library(so: Path, nvcc: str) -> Path:
    """Compile the kernels with ``nvcc`` into ``so`` through private
    temporary files, so processes building at once never load a
    half-written library. ``nvcc``'s ptxas report (registers, shared memory,
    spills per kernel) is kept beside it as ``<name>.log``. Raises with
    nvcc's stderr on failure."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    sources = [p for p in _sources() if p.suffix == ".cu"]
    objs = [so.with_name(f"{so.stem}.{os.getpid()}.{p.stem}.o") for p in sources]
    try:
        with ThreadPoolExecutor(len(sources)) as pool:  # every source at once
            report = "".join(pool.map(
                lambda src, o: _nvcc(nvcc, [*NVCC_FLAGS, "-c", "-o", str(o), str(src)], src.name),
                sources, objs))
        _nvcc(nvcc, [*ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)], "the link")
        so.with_suffix(".log").write_text(report)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return so


def build() -> Path:
    """Path of the kernel library of the current sources and flags, the
    first of:

    1. the library a wheel bundles in the package, of the current key only,
       so a library of other sources is never loaded;
    2. the library built before in :func:`build_dir`;
    3. a build with ``nvcc`` into :func:`build_dir`.

    Raises ``RuntimeError`` naming every place it looked when there is no
    library and no ``nvcc``; nothing else takes the kernels' place."""
    name = library_name()
    bundled, built = PKG_DIR / name, build_dir() / name
    for so in (bundled, built):
        if so.exists():
            return so
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            f"no kernel library {name}: not bundled in {PKG_DIR}, not built in "
            f"{built.parent}, and no nvcc to build it (not on PATH, not {_nvcc_fallback()})")
    return compile_library(built, nvcc)


def library() -> ctypes.CDLL:
    """The loaded kernel library (:func:`build` on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.et_error_string.restype = ctypes.c_char_p
            lib.et_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def entry(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point ``name`` with its argument types declared (pointers and
    the stream as ``c_void_p``) and an int (cudaError_t) result."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().et_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def counted(wrapper):
    """Give kernel wrapper ``wrapper`` its launch counts, both 0: ``launches``
    and ``launches_on`` (a Counter by CUDA device index). Returns it."""
    wrapper.launches = 0
    wrapper.launches_on = collections.Counter()
    return wrapper


def count_launch(wrapper, device) -> None:
    """One more launch of ``wrapper``'s kernel on ``device``, counted under a
    lock: the ranks of a local mesh launch from several threads at once,
    and ``+= 1`` on an attribute is a read-modify-write that loses counts."""
    with _count_lock:
        wrapper.launches += 1
        wrapper.launches_on[device.index] += 1


def require(t, dtype, name: str, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (on
    ``device`` when given): the kernels take raw pointers."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous CUDA {dtype} tensor, got {t.dtype} "
            f"on {t.device} (contiguous={t.is_contiguous()})"
        )
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, the other operands on {device}")
