"""Wheel build: compile the native host runtime as a bundled extension.

The lazy in-tree g++ build (entreepy_tpu/runtime/__init__.py) exists for
source checkouts; wheels built here ship a portable binary instead
(-O3 -mtune=generic, NO -march=native), so `pip install` lands a working
fast path on machines without a compiler. Counterpart of the reference's 4
per-target ReleaseFast binaries (build.zig:14-23, release.yml:32-50).

The module is built as a plain shared library (ctypes, C linkage) — it only
borrows setuptools' Extension machinery for compilation and wheel tagging.

The PyTorch port, entreepy_tpu_torch, gets the same: its own host runtime as
``entreepy_tpu_torch.runtime._native_ext`` with the same portable flags, and,
where the wheel is built on a machine with nvcc, its CUDA kernels compiled
for sm_90a as ``entreepy_tpu_torch/kernels-<key>.so`` (the flags, sources and
key of a first-use build, ``entreepy_tpu_torch/_build.py``). Without nvcc the
wheel holds no kernel library and the first kernel launch builds one.
"""

import importlib.util
from pathlib import Path

from setuptools import setup
from setuptools.command.build_ext import build_ext
from setuptools.extension import Extension


class ctypes_build_ext(build_ext):
    """Skip the CPython-extension import check: the library exports plain C
    symbols for ctypes, not a PyInit_* entry point."""

    def get_export_symbols(self, ext):
        return ext.export_symbols

    def get_ext_filename(self, ext_name):
        # fixed, interpreter-independent name next to native.cpp
        return ext_name.replace(".", "/") + ".so"

    def run(self):
        super().run()
        # loaded by its file path: the port's __init__ imports torch,
        # _build.py only the standard library
        path = Path(__file__).resolve().parent / "entreepy_tpu_torch" / "_build.py"
        spec = importlib.util.spec_from_file_location("entreepy_tpu_torch_build", path)
        kernels = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(kernels)
        nvcc = kernels.nvcc_path()
        if nvcc is None:
            print("entreepy_tpu_torch: no nvcc, so the wheel holds no kernel library; "
                  "the first kernel launch builds it with nvcc")
            return
        pkg = Path(self.get_ext_fullpath("entreepy_tpu_torch.runtime._native_ext")).parent.parent
        kernels.compile_library(pkg / kernels.library_name(), nvcc)


setup(
    ext_modules=[
        Extension(
            "entreepy_tpu.runtime._native_ext",
            sources=["entreepy_tpu/runtime/native.cpp"],
            language="c++",
            extra_compile_args=["-O3", "-mtune=generic", "-std=c++17", "-pthread"],
            extra_link_args=["-pthread"],
        ),
        Extension(
            "entreepy_tpu_torch.runtime._native_ext",
            sources=["entreepy_tpu_torch/runtime/native.cpp"],
            language="c++",
            extra_compile_args=["-O3", "-mtune=generic", "-std=c++17", "-pthread"],
            extra_link_args=["-pthread"],
        ),
    ],
    cmdclass={"build_ext": ctypes_build_ext},
)
