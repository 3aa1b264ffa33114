"""Build-on-first-use loader of the port's hand-written CUDA kernels and
its host C++ (no JAX counterpart: the JAX package's kernels are Pallas,
compiled by JAX).

Each source under ``dgdm_tpu_torch/csrc/`` has a plain C interface. On first
use it is compiled into a shared library under ``dgdm_tpu_torch/_build/``
(named by a hash of the source, of every header ``csrc/*.cuh`` beside it and
of the flags, so a change to any of them rebuilds) and loaded with ctypes: a
``.cu`` kernel by ``nvcc`` for ``sm_90a`` (``CudaLibrary``), a ``.cpp`` host
source by the host's C++ compiler (``HostLibrary``). Nothing here runs at
import: the CPU tests import every module on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
# no -ffast-math and no -march=native: what a host library computes must not
# depend on the host's instruction set; no fused multiply-adds either
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels build with the "
                       "CUDA toolkit (set CUDA_HOME)")


def cxx() -> Optional[str]:
    """The host's C++ compiler, or None where it has none."""
    return shutil.which("c++")


class CudaLibrary:
    """One kernel source: ``build()`` compiles it unless this source's library
    exists (with ``force`` even then; ``build_log`` holds the output of the
    compiler, ``ptxas -v`` included, when this process compiled); ``get()``
    loads it and lets ``bind`` set the C signatures."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = os.path.splitext(source)[0]
        self.src = os.path.join(_PKG, "csrc", source)
        self.build_dir = _BUILD
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""

    def _compiler(self) -> str:
        return nvcc()

    def _flags(self) -> tuple:
        return NVCC_FLAGS

    def _headers(self) -> list:
        return sorted(glob.glob(
            os.path.join(os.path.dirname(self.src), "*.cuh")))

    def path(self) -> str:
        """The library's file: named by the bytes of the source, of every
        ``*.cuh`` in the source's directory (the sources include them) and
        of the flags."""
        digest = hashlib.sha1(" ".join(self._flags()).encode())
        for name in [self.src] + self._headers():
            with open(name, "rb") as f:
                digest.update(os.path.basename(name).encode() + b"\0"
                              + f.read())
        return os.path.join(self.build_dir,
                            f"lib{self.name}_{digest.hexdigest()[:12]}.so")

    def build(self, force: bool = False) -> str:
        so = self.path()
        if os.path.exists(so) and not force:
            return so
        os.makedirs(self.build_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        compiler = self._compiler()
        proc = subprocess.run([compiler, *self._flags(), "-o", tmp, self.src],
                              capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                               f"{self.src}:\n{self.build_log}")
        os.replace(tmp, so)
        return so

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._bind(lib)
                self._lib = lib
            return self._lib


class HostLibrary(CudaLibrary):
    """A C++ source under ``csrc/`` built by the host's compiler with
    ``CXX_FLAGS`` (it includes no ``*.cuh``). A failed compile raises, as
    nvcc's does; ``cxx()`` says beforehand whether there is a compiler."""

    def _compiler(self) -> str:
        compiler = cxx()
        if compiler is None:
            raise RuntimeError("no C++ compiler (c++) on PATH")
        return compiler

    def _flags(self) -> tuple:
        return CXX_FLAGS

    def _headers(self) -> list:
        return []
