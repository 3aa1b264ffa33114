"""How the port builds, loads and falls back from its C++ jaw mass
(``dgdm_tpu_torch/geom/jawmass.py``, ``core/native.NativeLibrary`` with
the ``CXX`` toolchain), and
the spans ``make_scene`` opens around it:

- the library is named by a hash of its source and ``CXX_FLAGS``, which
  keep multiply-adds unfused and name no host instruction set;
- a broken source makes the build raise, and ``available()`` with it,
  rather than fall back; only a host with no C++ compiler falls back;
- ``make_scene`` with the library made unavailable gives scenes equal bit
  for bit to the native path's;
- a traced ``make_scene`` on a fresh design opens ``scene.jaw_mass.native``
  once a jaw, inside ``scene.fingers``, and none on a cache hit."""

import dataclasses

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.core import native
from dgdm_tpu_torch.core.cache import LRU
from dgdm_tpu_torch.core.config import GRIPPER_2D
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.geom import jawmass
from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
from dgdm_tpu_torch.geom.fingers import denormalize_y
from dgdm_tpu_torch.sim import engine2d
from tests import torch_parity  # noqa: F401  (one torch thread)


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty finger cache for the test (the module's is left as it was)."""
    monkeypatch.setattr(engine2d, "_FINGER_CACHE_2D", LRU(4096))


@pytest.fixture
def tracer():
    TRACER.start()
    try:
        yield TRACER
    finally:
        TRACER.stop()
        TRACER.start()
        TRACER.stop()


def _designs(seed, count):
    rng = np.random.default_rng(seed)
    y = denormalize_y(rng.uniform(-1.0, 1.0, (count, 2 * GRIPPER_2D.num_ctrl)))
    n = GRIPPER_2D.num_ctrl
    return [(row[:n], row[n:]) for row in y]


def _host_library(tmp_path, source_text):
    (tmp_path / "jawmass.cpp").write_text(source_text)
    lib = native.NativeLibrary("jawmass.cpp", jawmass._bind, **native.CXX)
    lib.src = str(tmp_path / "jawmass.cpp")
    lib.build_dir = str(tmp_path / "_build")
    return lib


def test_flags_keep_the_mass_independent_of_the_host():
    flags = native.CXX_FLAGS
    assert "-ffp-contract=off" in flags
    assert not any(f.startswith(("-ffast-math", "-march", "-Ofast",
                                 "-mtune")) for f in flags)
    assert jawmass.LIBRARY.src.endswith("csrc/jawmass.cpp")


def test_path_changes_with_the_source_and_the_flags(tmp_path, monkeypatch):
    with open(jawmass.LIBRARY.src) as f:
        text = f.read()
    lib = _host_library(tmp_path, text)
    before = lib.path()
    assert before.endswith(".so") and lib.path() == before
    (tmp_path / "jawmass.cpp").write_text(text + "\n// edited\n")
    edited = lib.path()
    assert edited != before
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert lib.path() != edited


def test_a_copy_of_the_source_builds_and_loads(tmp_path):
    with open(jawmass.LIBRARY.src) as f:
        lib = _host_library(tmp_path, f.read())
    loaded = lib.get()
    x = np.linspace(0.0, 1.0, 8)
    y = np.zeros(8)
    hi = y + 2.0
    bounds = np.array([0, 3, 7], np.int64)
    # the strip [0, 1] x [0, 2] and two slabs [0, 3/7] and [3/7, 1] wide
    area = loaded.jaw_area(x.ctypes.data, y.ctypes.data, hi.ctypes.data, 8,
                           bounds.ctypes.data, 2)
    assert area == pytest.approx(4.0, rel=1e-15)


def test_a_broken_source_raises_instead_of_falling_back(tmp_path,
                                                        monkeypatch):
    with open(jawmass.LIBRARY.src) as f:
        lib = _host_library(tmp_path, f.read() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="failed on"):
        lib.build()
    monkeypatch.setattr(jawmass, "LIBRARY", lib)
    jawmass.available.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed on"):
            jawmass.available()
        yl, yr = _designs(1, 1)[0]
        monkeypatch.setattr(engine2d, "_FINGER_CACHE_2D", LRU(4096))
        with pytest.raises(RuntimeError, match="failed on"):
            engine2d.make_scene(yl, yr, extract_contours(synthetic_icon(0)))
    finally:
        jawmass.available.cache_clear()


def test_no_compiler_falls_back_to_python(monkeypatch, fresh_cache, tracer):
    monkeypatch.setattr(native, "cxx", lambda: None)
    jawmass.available.cache_clear()
    try:
        assert not jawmass.available()
        yl, yr = _designs(2, 1)[0]
        engine2d.make_scene(yl, yr, extract_contours(synthetic_icon(0)))
    finally:
        jawmass.available.cache_clear()
    names = [s[0] for s in tracer.spans()]
    assert names.count("scene.jaw_mass.python") == 2
    assert "scene.jaw_mass.native" not in names


def test_fallback_scenes_equal_native_scenes(monkeypatch):
    contours = [extract_contours(synthetic_icon(i)) for i in (0, 3)]
    designs = _designs(3, 8)
    assert jawmass.available()

    def scenes():
        monkeypatch.setattr(engine2d, "_FINGER_CACHE_2D", LRU(4096))
        return [engine2d.make_scene(yl, yr, c)
                for c in contours for yl, yr in designs]

    native = scenes()
    monkeypatch.setattr(jawmass, "available", lambda: False)
    python = scenes()
    for a, b in zip(native, python):
        for field in dataclasses.fields(a):
            ta, tb = getattr(a, field.name), getattr(b, field.name)
            if isinstance(ta, torch.Tensor):
                assert torch.equal(ta, tb), field.name
                assert ta.dtype == tb.dtype
            else:
                assert ta is None and tb is None, field.name


def test_traced_scene_opens_native_span_on_a_miss_only(fresh_cache, tracer):
    assert jawmass.available()
    contour = extract_contours(synthetic_icon(0))
    yl, yr = _designs(4, 1)[0]
    engine2d.make_scene(yl, yr, contour)
    first = tracer.stop()
    names = [s[0] for s in first]
    assert names.count("scene.jaw_mass.native") == 2
    assert "scene.jaw_mass.python" not in names
    fingers = [s for s in first if s[0] == "scene.fingers"]
    assert len(fingers) == 1
    for s in first:
        if s[0] == "scene.jaw_mass.native":
            assert fingers[0][1] <= s[1] and s[2] <= fingers[0][2]
    tracer.start()
    engine2d.make_scene(yl, yr, contour)
    names = [s[0] for s in tracer.stop()]
    assert names.count("scene.fingers") == 1
    assert not [n for n in names if n.startswith("scene.jaw_mass.")]

