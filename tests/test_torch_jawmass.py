"""The 2D jaw mass in the port's C++ (``dgdm_tpu_torch/geom/jawmass.py``,
``csrc/jawmass.cpp``) against the Python body it replaces on the main path
(``polygon.finger_cross_section_area_py``) and against the JAX package's
``finger_cross_section_area``:

- 10,000 designs drawn as ``denormalize_y`` of seeded uniform noise, in 20
  cases of 500, and the edge designs (all zero, every control at either
  clip, straight ramps) and edge curves (exactly collinear samples,
  repeated samples, a strip of no width): the float32 mass the scene
  carries (``SIM.density * height * area``) is equal bit for bit, and so
  is the float64 area;
- a few hundred designs against the JAX package's Python hull."""

import numpy as np
import pytest

from dgdm_tpu.geom import polygon as jpolygon
from dgdm_tpu_torch.core.config import GRIPPER_2D, SIM
from dgdm_tpu_torch.geom import jawmass
from dgdm_tpu_torch.geom import polygon as tpolygon
from dgdm_tpu_torch.geom.fingers import denormalize_y
from dgdm_tpu_torch.sim import engine2d

JAWS_PER_CASE = 500


def _curves(designs):
    """Each design's (y_curve, x_curve), as make_scene samples it."""
    _, x_curve, basis = engine2d._finger_operators_2d()
    return [(basis @ np.asarray(y, np.float64), x_curve) for y in designs]


def _seeded_designs(seed, count):
    rng = np.random.default_rng(seed)
    noise = rng.uniform(-1.0, 1.0, (count, GRIPPER_2D.num_ctrl))
    return denormalize_y(noise)


def _mass32(area):
    return np.float32(SIM.density * GRIPPER_2D.height * area)


def _assert_same(native, python):
    native, python = np.asarray(native), np.asarray(python)
    assert native.dtype == python.dtype == np.float64
    # the same double, not only within a few ulp: the source repeats numpy's
    # summation order and the hull's predicate, and a change to either
    # (a sequential sum, popping on < 0) fails here
    np.testing.assert_array_equal(native, python)
    m_nat = np.array([_mass32(a) for a in native])
    m_py = np.array([_mass32(a) for a in python])
    np.testing.assert_array_equal(m_nat.view(np.uint32), m_py.view(np.uint32))


@pytest.fixture(scope="module", autouse=True)
def native_library():
    assert jawmass.available(), "the host has a C++ compiler"


@pytest.mark.parametrize("seed", range(20))
def test_native_equals_python_on_seeded_designs(seed):
    curves = _curves(_seeded_designs(seed, JAWS_PER_CASE))
    w = GRIPPER_2D.width
    native = [jawmass.jaw_area(y, x, w) for y, x in curves]
    python = [tpolygon.finger_cross_section_area_py(y, x, w)
              for y, x in curves]
    _assert_same(native, python)
    # the dispatcher takes the native path here
    y, x = curves[0]
    assert tpolygon.finger_cross_section_area(y, x, w) == native[0]


def _edge_design(kind):
    g = GRIPPER_2D
    n = g.num_ctrl
    return {
        "zero": np.zeros(n),
        "upper_clip": np.full(n, g.ctrl_y_max),
        "lower_clip": np.full(n, g.ctrl_y_min),
        "ramp_up": np.linspace(g.ctrl_y_min, g.ctrl_y_max, n),
        "ramp_down": np.linspace(g.ctrl_y_max, g.ctrl_y_min, n),
    }[kind]


@pytest.mark.parametrize("kind", ["zero", "upper_clip", "lower_clip",
                                  "ramp_up", "ramp_down"])
def test_native_equals_python_on_edge_designs(kind):
    (y, x), = _curves([_edge_design(kind)])
    w = GRIPPER_2D.width
    _assert_same([jawmass.jaw_area(y, x, w)],
                 [tpolygon.finger_cross_section_area_py(y, x, w)])


def _edge_curve(kind):
    g = GRIPPER_2D
    x = np.linspace(g.ctrl_x_min, g.ctrl_x_max, g.num_curve_points)
    if kind == "collinear":      # one line up to rounding: turns of ~0
        return 0.25 * x - 0.01, x, g.width
    if kind == "flat":
        return np.full_like(x, -0.02), x, g.width
    if kind == "repeated":       # every sample twice: the dedupe removes it
        xr = np.repeat(x[::2], 2)
        return 0.1 * np.sin(30.0 * xr), xr, g.width
    if kind == "no_width":       # both edges of the strip coincide
        return 0.1 * np.sin(30.0 * x), x, 0.0
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["collinear", "flat", "repeated",
                                  "no_width"])
def test_native_equals_python_on_edge_curves(kind):
    y, x, w = _edge_curve(kind)
    _assert_same([jawmass.jaw_area(y, x, w)],
                 [tpolygon.finger_cross_section_area_py(y, x, w)])


@pytest.mark.parametrize("seed", [100, 101, 102])
def test_native_equals_jax_package(seed):
    curves = _curves(_seeded_designs(seed, 100))
    w = GRIPPER_2D.width
    native = [jawmass.jaw_area(y, x, w) for y, x in curves]
    jax_ref = [jpolygon.finger_cross_section_area(y, x, w) for y, x in curves]
    _assert_same(native, jax_ref)
