"""Build-by-hash of a source into a shared library, and launch counters.

Shared by the kernel modules (``backend/ba_kernels.py``,
``ops/frontend_kernels.py``): a source under ``csrc/`` is compiled with
``nvcc`` for ``sm_90a`` at first use into
``object_oriented_slam_tpu_torch/build/`` (the library is named by the hash
of source and flags, so an edited source rebuilds) and bound with ctypes by
the caller.  ``io/native_loader.py`` builds the host clustering
(``native/src/cluster.cpp``) the same way with the host C++ compiler
(``build_host``).  Nothing is built when a module is imported.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# -fmad=false: every multiply and add rounds on its own, as in the plain
# versions' elementwise kernels, so both compute the same bits
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# native/build.sh's flags, without its -pthread and libraries: cluster.cpp
# includes only the C++ standard library
HOST_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")


class Kernel:
    """A launch counter: ``launches`` grows by one per kernel launch."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/*.cu with the CUDA toolkit")
    return path


def host_cxx() -> str:
    """The host C++ compiler (the one nvcc drives)."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: native/src/cluster.cpp is built "
                           "with the host C++ compiler")
    return path


def _local_includes(text: bytes, directory: str) -> bytes:
    """The bytes of the headers ``text`` includes by ``#include "name"``
    from ``directory`` (the shared csrc/*.cuh), so an edited header
    rebuilds every source that includes it."""
    out = b""
    for name in re.findall(rb'^\s*#include\s+"([^"]+)"', text, re.M):
        with open(os.path.join(directory, name.decode()), "rb") as f:
            out += f.read()
    return out


def build(source: str, flags=NVCC_FLAGS, compiler=None):
    """Compile ``source`` with ``compiler`` (nvcc by default) if this
    source (with the headers it includes) is not built yet with these
    flags.  Returns (path of the shared library, the compiler's output:
    this call's, or the one kept beside the library when nothing ran)."""
    with open(source, "rb") as f:
        text = f.read()
    digest = hashlib.sha1(text + _local_includes(text, os.path.dirname(source))
                          + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(BUILD_DIR,
                            f"lib{stem}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib_path):
        try:
            with open(lib_path + ".log") as f:
                return lib_path, f.read()
        except OSError:
            return lib_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        compiler = compiler or nvcc()
        proc = subprocess.run([compiler, *flags, "-o", tmp, source],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                               f"{source}:\n{log}")
        with open(tmp + ".log", "w") as f:
            f.write(log)
        os.replace(tmp + ".log", lib_path + ".log")
        os.replace(tmp, lib_path)   # atomic: concurrent builds agree
    finally:
        for path in (tmp, tmp + ".log"):
            if os.path.exists(path):
                os.remove(path)
    return lib_path, log


def build_host(source: str, flags=HOST_FLAGS):
    """``build`` with the host C++ compiler."""
    return build(source, flags, host_cxx())
