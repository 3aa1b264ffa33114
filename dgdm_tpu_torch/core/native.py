"""Build-on-first-use loader of the port's native code under
``dgdm_tpu_torch/csrc/`` and the launch the rollout kernels share (no JAX
counterpart: the JAX package's kernels are Pallas, compiled by JAX).

Each source has a plain C interface. On first use ``NativeLibrary`` compiles
it into a shared library under ``dgdm_tpu_torch/_build/`` (named by a hash of
the source, of the headers beside it and of the flags, so a change to any of
them rebuilds) and loads it with ctypes. Two toolchains: ``NVCC`` builds a
``.cu`` kernel for ``sm_90a`` with ``NVCC_FLAGS`` and hashes every ``*.cuh``
in its directory; ``CXX`` builds a ``.cpp`` host source with the host's
``c++`` and ``CXX_FLAGS`` and hashes no header. Each reads its compiler and
flags from this module when it builds. Nothing here runs at import: the CPU
tests import every module on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional, Sequence

import torch

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


def _host_compiler() -> str:
    compiler = cxx()
    if compiler is None:
        raise RuntimeError("no C++ compiler (c++) on PATH")
    return compiler


# the two toolchains, as NativeLibrary's keyword arguments
NVCC = dict(compiler=lambda: nvcc(), flags=lambda: NVCC_FLAGS,
            headers="*.cuh")
CXX = dict(compiler=_host_compiler, flags=lambda: CXX_FLAGS, headers=None)


class NativeLibrary:
    """One source under ``csrc/``: ``build()`` compiles it with
    ``compiler()`` and ``flags()`` unless this source's library exists (with
    ``force`` even then; ``build_log`` holds the compiler's output, ``ptxas
    -v`` included, when this process compiled); ``get()`` loads it and lets
    ``bind`` set the C signatures. ``headers`` is the glob, beside the
    source, of the files it includes, or None. A failed compile raises."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None],
                 compiler: Callable[[], str],
                 flags: Callable[[], Sequence[str]],
                 headers: Optional[str]):
        self.name = os.path.splitext(source)[0]
        self.src = os.path.join(_PKG, "csrc", source)
        self.build_dir = _BUILD
        self._bind = bind
        self._compiler = compiler
        self._flags = flags
        self._headers = headers
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""

    def path(self) -> str:
        """The library's file: named by the bytes of the source, of every
        header in the source's directory (the source includes them) and of
        the flags."""
        headers = sorted(glob.glob(os.path.join(
            os.path.dirname(self.src), self._headers))) if self._headers \
            else []
        digest = hashlib.sha1(" ".join(self._flags()).encode())
        for name in [self.src] + headers:
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


# what a rollout kernel's launcher writes back: threads per rollout, blocks
# per cluster, threads per block, cudaOccupancyMaxActiveClusters and bytes
# of shared memory a block
PLAN_FIELDS = ("threads_per_rollout", "cluster", "threads",
               "max_active_clusters", "shared_bytes")
Plan = ctypes.c_int * len(PLAN_FIELDS)


def check_inputs(tensors: Sequence[torch.Tensor]) -> None:
    """A rollout's inputs: float32 tensors on one device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"rollout inputs must be float32, got {t.dtype}")


def launch(entry, inputs: Sequence[torch.Tensor], out_shape: tuple,
           sizes: Sequence[int], params: ctypes.Structure, plan: dict,
           launches: dict, counter: str) -> torch.Tensor:
    """Launch a rollout kernel on the current stream of the inputs' device:
    ``entry(*inputs, out, *sizes, params, &plan, stream)`` returns a CUDA
    error code. ``sizes`` opens with the batch and the point count. The
    launch plan goes into ``plan`` even when the launch fails; a launch
    that succeeds counts under ``launches[counter]``. -> the float32
    output of ``out_shape``."""
    check_inputs(inputs)
    ins = [t.contiguous() for t in inputs]
    device = ins[-1].device
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    c_plan = Plan()
    err = entry(*[t.data_ptr() for t in ins], out.data_ptr(), *sizes, params,
                ctypes.byref(c_plan), stream)
    plan.update(zip(PLAN_FIELDS, c_plan))
    if err != 0:
        raise RuntimeError(
            f"{counter} kernel launch failed: CUDA error {err} (launch plan "
            f"{plan}; the shared memory a block needs grows with the point "
            f"count, {sizes[1]} here)")
    launches[counter] += 1
    return out
