"""The build-on-first-use loader of the port's CUDA kernels
(dgdm_tpu_torch/core/native.py) names a library by a hash of everything
that goes into it: the source, every header beside it and the flags. Needs
no nvcc: ``path()`` is exercised on sources in a temporary directory, and
``build()`` with a stand-in for the compiler.
No JAX counterpart (the JAX package's kernels are compiled by JAX)."""

import os
import subprocess

from dgdm_tpu_torch.core import native
from dgdm_tpu_torch.sim import rollout2d, rollout3d


def _library(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kernel.cu").write_text('#include "common.cuh"\nint f();\n')
    (src / "common.cuh").write_text("// shared parts\n")
    lib = native.NativeLibrary("kernel.cu", lambda _lib: None, **native.NVCC)
    lib.src = str(src / "kernel.cu")
    lib.build_dir = str(tmp_path / "_build")
    return lib, src


def test_path_changes_with_a_header(tmp_path):
    lib, src = _library(tmp_path)
    before = lib.path()
    assert lib.path() == before
    assert os.path.dirname(before) == lib.build_dir
    (src / "common.cuh").write_text("// shared parts, edited\n")
    after = lib.path()
    assert after != before
    # a new header beside the source counts too; another file type does not
    (src / "extra.cuh").write_text("// more\n")
    assert lib.path() != after
    with_extra = lib.path()
    (src / "notes.txt").write_text("not a source\n")
    assert lib.path() == with_extra


def test_path_changes_with_the_source_and_the_flags(tmp_path, monkeypatch):
    lib, src = _library(tmp_path)
    before = lib.path()
    (src / "kernel.cu").write_text('#include "common.cuh"\nint g();\n')
    changed = lib.path()
    assert changed != before
    monkeypatch.setattr(native, "NVCC_FLAGS",
                        native.NVCC_FLAGS + ("-DX=1",))
    assert lib.path() != changed


def test_both_kernels_depend_on_the_shared_header():
    """rollout_common.cuh is included by both sources and hashed into both
    libraries' names."""
    for lib in (rollout2d.LIBRARY, rollout3d.LIBRARY):
        with open(lib.src) as f:
            assert '#include "rollout_common.cuh"' in f.read()
        assert os.path.exists(os.path.join(os.path.dirname(lib.src),
                                           "rollout_common.cuh"))
        assert lib.path().endswith(".so")


def test_build_reuses_a_library_unless_forced(tmp_path, monkeypatch):
    """A library that exists is not rebuilt; ``force`` compiles all the same
    and ``build_log`` then holds what the compiler said (``ptxas -v``:
    registers, spills). The compiler is a stand-in here."""
    lib, _ = _library(tmp_path)
    so = lib.path()
    os.makedirs(lib.build_dir)
    with open(so, "wb") as f:
        f.write(b"old")
    calls = []

    def fake_run(cmd, **_kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"new")
        return subprocess.CompletedProcess(
            cmd, 0, "", "ptxas info    : Used 128 registers\n")

    monkeypatch.setattr(native, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    assert lib.build() == so
    assert not calls and lib.build_log == ""
    assert lib.build(force=True) == so
    assert len(calls) == 1 and calls[0][-1] == lib.src
    assert "Used 128 registers" in lib.build_log
    with open(so, "rb") as f:
        assert f.read() == b"new"
