"""ctypes bindings for the shared native geometry kernel
(native/geomkit.cpp) — the port's own copy of ``dgdm_tpu/geom/native.py``'s
loader.

Every entry point has a pure-Python fallback in ``dgdm_tpu_torch.geom``; this
module exposes the fast native paths when the shared library is available,
building it on first use into the port's ``.gitignore``d build directory
(``dgdm_tpu_torch/_build/``) if a compiler is present.

Build manually:  python -m dgdm_tpu_torch.geom.native
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "geomkit.cpp")
_BUILD = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD, "libgeomkit.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build() -> bool:
    try:
        os.makedirs(_BUILD, exist_ok=True)
        # build to a private name and rename, so that concurrent processes
        # never load a half-written library
        tmp = f"{_SO}.{os.getpid()}.tmp"
        subprocess.run(
            ["c++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True,
        )
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) and os.path.exists(_SRC):
        build()
    if not os.path.exists(_SO):
        return None
    lib = ctypes.CDLL(_SO)
    c_d = ctypes.POINTER(ctypes.c_double)
    c_u8 = ctypes.POINTER(ctypes.c_uint8)
    c_i32 = ctypes.POINTER(ctypes.c_int32)
    c_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.trace_largest_contour.restype = ctypes.c_int64
    lib.trace_largest_contour.argtypes = [
        c_u8, ctypes.c_int64, ctypes.c_int64, c_d, ctypes.c_int64,
    ]
    lib.resample_contour.restype = None
    lib.resample_contour.argtypes = [c_d, ctypes.c_int64, ctypes.c_int64, c_i32]
    lib.ear_clip.restype = ctypes.c_int64
    lib.ear_clip.argtypes = [c_d, ctypes.c_int64, c_i64]
    lib.points_in_polygon.restype = None
    lib.points_in_polygon.argtypes = [
        c_d, ctypes.c_int64, c_d, ctypes.c_int64, c_u8,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def trace_largest_contour(mask: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask != 0, dtype=np.uint8)
    h, w = mask.shape
    cap = 4 * h * w
    out = np.empty((cap, 2), dtype=np.float64)
    n = lib.trace_largest_contour(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap,
    )
    if n <= 0:
        return None
    return out[:n]


def resample_contour(xy: np.ndarray, m: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    out = np.empty((m, 2), dtype=np.int32)
    lib.resample_contour(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(xy), m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def ear_clip(poly: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    poly = np.ascontiguousarray(poly, dtype=np.float64)
    n = len(poly)
    tris = np.empty((2 * n, 3), dtype=np.int64)
    nt = lib.ear_clip(
        poly.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return tris[:nt] if nt > 0 else None


def points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    poly = np.ascontiguousarray(poly, dtype=np.float64)
    out = np.empty(len(pts), dtype=np.uint8)
    lib.points_in_polygon(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pts),
        poly.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(poly),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)


if __name__ == "__main__":
    ok = build()
    print("built" if ok else "build FAILED", _SO)
