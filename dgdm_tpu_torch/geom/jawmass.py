"""The 2D jaw mass in the port's own C++: ``csrc/jawmass.cpp``, the hull of
a jaw's whole strip plus its 50 slab hulls, as
``polygon.finger_cross_section_area_py`` computes them in Python, giving the
same double (the source says how). No JAX counterpart: the JAX package
computes the mass in Python.

The library is built on first use by the host's C++ compiler with
``core/native.CXX_FLAGS`` into ``dgdm_tpu_torch/_build/`` (named by a hash
of the source and the flags) and bound with ctypes. ``available()`` is False
only where the host has no C++ compiler; then ``finger_cross_section_area``
takes its Python body. A failed compile raises, so a broken source never
falls back to the slow path unnoticed.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from dgdm_tpu_torch.core import native


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.jaw_area.restype = ctypes.c_double
    lib.jaw_area.argtypes = [ptr, ptr, ptr, i64, ptr, i64]


LIBRARY = native.NativeLibrary("jawmass.cpp", _bind, **native.CXX)


@functools.lru_cache(maxsize=None)
def available() -> bool:
    """Whether the native jaw mass runs here: builds (or finds) and loads
    the library on the first call; raises if the compiler refuses it."""
    if native.cxx() is None:
        return False
    LIBRARY.get()
    return True


@functools.lru_cache(maxsize=None)
def _slab_bounds(n: int, num_slabs: int) -> np.ndarray:
    # the Python body's bounds, as int64
    return np.linspace(0, n - 1, num_slabs + 1).astype(np.int64)


def jaw_area(y_curve: np.ndarray, x_curve: np.ndarray, width: float,
             num_slabs: int = 50) -> float:
    """``finger_cross_section_area`` in C++ (the library must be
    ``available()``). The strip's upper edge ``y_curve + width`` is taken
    here, in the input's precision, as the Python body takes it."""
    y_curve = np.asarray(y_curve)
    x = np.ascontiguousarray(x_curve, dtype=np.float64)
    y_lo = np.ascontiguousarray(y_curve, dtype=np.float64)
    y_hi = np.ascontiguousarray(y_curve + width, dtype=np.float64)
    n = len(x)
    if y_lo.shape != (n,) or x.shape != (n,):
        raise ValueError(f"jaw_area: curves of shapes {x.shape} and "
                         f"{y_lo.shape}, not two of ({n},)")
    bounds = _slab_bounds(n, num_slabs)
    return LIBRARY.get().jaw_area(x.ctypes.data, y_lo.ctypes.data,
                                  y_hi.ctypes.data, n, bounds.ctypes.data,
                                  num_slabs)
