"""Polygon mass properties and support sampling — the on-device replacement
for the reference's V-HACD + MuJoCo inertia pipeline (``sim/sim_2d.py:26-71``,
MuJoCo's mesh inertia). Everything is closed-form or static-shape masked, so
object batches live as dense arrays in HBM.

PyTorch port: numpy copy of ``dgdm_tpu/geom/polygon.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def polygon_area_centroid_inertia(
    verts: np.ndarray,
) -> Tuple[float, np.ndarray, float]:
    """Exact signed area, centroid and second polar moment (about centroid,
    per unit density, i.e. integral of r^2 dA) of a simple polygon."""
    x, y = verts[:, 0], verts[:, 1]
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    cross = x * y1 - x1 * y
    a = 0.5 * np.sum(cross)
    cx = np.sum((x + x1) * cross) / (6.0 * a)
    cy = np.sum((y + y1) * cross) / (6.0 * a)
    ixx = np.sum((y * y + y * y1 + y1 * y1) * cross) / 12.0
    iyy = np.sum((x * x + x * x1 + x1 * x1) * cross) / 12.0
    i0 = ixx + iyy - (cx * cx + cy * cy) * a  # parallel axis to centroid
    return float(a), np.array([cx, cy]), float(i0)


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull of a 2D point set, CCW. Host-side numpy.

    Used to reproduce MuJoCo's mass model exactly: vertex-only meshes (the
    oracle's finger slabs / visual meshes, and the reference's V-HACD parts)
    are convex-hulled by MuJoCo before inertia computation."""
    pts = np.unique(np.asarray(pts, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(pp):
        h: list = []
        for p in pp:
            while len(h) >= 2 and (
                (h[-1][0] - h[-2][0]) * (p[1] - h[-2][1])
                - (h[-1][1] - h[-2][1]) * (p[0] - h[-2][0])
            ) <= 0.0:
                h.pop()
            h.append(p)
        return h

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def points_in_polygon(pts: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Vectorized crossing-number test. pts (P, 2), verts (N, 2) -> (P,) bool."""
    x, y = pts[:, 0:1], pts[:, 1:2]                      # (P, 1)
    vx, vy = verts[None, :, 0], verts[None, :, 1]        # (1, N)
    vx1, vy1 = np.roll(verts[:, 0], -1)[None], np.roll(verts[:, 1], -1)[None]
    cond = (vy > y) != (vy1 > y)
    denom = np.where(vy1 - vy == 0.0, 1.0, vy1 - vy)
    xint = vx + (y - vy) / denom * (vx1 - vx)
    crossings = np.sum(cond & (x < xint), axis=1)
    return (crossings % 2) == 1


def support_points(
    verts: np.ndarray, grid: int = 12
) -> Tuple[np.ndarray, np.ndarray]:
    """Static-shape plane-contact support set: a ``grid x grid`` lattice over
    the polygon bbox with per-point weights (inside-mask normalized to sum 1).
    The weights approximate a uniform pressure distribution, which is what
    MuJoCo's solver realizes for a flat-bottomed rigid body at rest.

    Returns (pts (grid*grid, 2), weights (grid*grid,))."""
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    # cell centers so boundary cells are representative
    gx = lo[0] + (hi[0] - lo[0]) * (np.arange(grid) + 0.5) / grid
    gy = lo[1] + (hi[1] - lo[1]) * (np.arange(grid) + 0.5) / grid
    xx, yy = np.meshgrid(gx, gy, indexing="ij")
    pts = np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1)
    inside = points_in_polygon(pts, verts)
    if not inside.any():  # degenerate: fall back to centroid
        _, c, _ = polygon_area_centroid_inertia(verts)
        pts = np.tile(c, (grid * grid, 1))
        w = np.full(grid * grid, 1.0 / (grid * grid))
        return pts, w
    w = inside.astype(np.float64)
    return pts, w / w.sum()


def merge_mass_parts(parts) -> Tuple[float, np.ndarray, float]:
    """Combine per-part (area, centroid, polar inertia about own centroid)
    into totals about the combined centroid — how MuJoCo sums geom masses
    into a body's mass/COM/inertia."""
    a_tot = sum(p[0] for p in parts)
    com = sum(p[0] * p[1] for p in parts) / a_tot
    i0 = sum(p[2] + p[0] * float(np.sum((p[1] - com) ** 2)) for p in parts)
    return float(a_tot), com, float(i0)


def object_mass_properties_2d(poly: np.ndarray) -> Tuple[float, np.ndarray, float]:
    """Per-unit-(density*height) mass properties of the oracle's 2D object
    body: the ear-clip collision prisms partition the polygon exactly, and
    the vertex-only visual mesh is convex-hulled by MuJoCo — so the body is
    polygon + hull, each contributing area/centroid/inertia. Verified to
    machine precision against MjModel.body(\"object\").mass."""
    a_p, c_p, i_p = polygon_area_centroid_inertia(poly)
    hull = convex_hull(poly)
    a_h, c_h, i_h = polygon_area_centroid_inertia(hull)
    return merge_mass_parts([(a_p, c_p, i_p), (a_h, c_h, i_h)])


def finger_cross_section_area(
    y_curve: np.ndarray, x_curve: np.ndarray, width: float, num_slabs: int = 50
) -> float:
    """Per-unit-(density*height) mass of one oracle jaw: the convex hull of
    the full strip (the vertex-only visual mesh) plus the 50 overlapping slab
    hulls (the collision decomposition, ``sim/oracle.py:_finger_slabs``).
    Slab spans share a boundary sample, so the sum over slabs deliberately
    over-counts exactly as MuJoCo does. Verified to machine precision against
    MjModel jaw masses; per-finger mass sets the kp=10 servo timing, which
    controls where in the grip transient the 200-step profile snapshot lands.

    Computed by the port's C++ (``geom/jawmass.py``, the same double) where
    the host has a C++ compiler, else by ``finger_cross_section_area_py``."""
    from dgdm_tpu_torch.geom import jawmass

    if jawmass.available():
        return jawmass.jaw_area(y_curve, x_curve, width, num_slabs)
    return finger_cross_section_area_py(y_curve, x_curve, width, num_slabs)


def finger_cross_section_area_py(
    y_curve: np.ndarray, x_curve: np.ndarray, width: float, num_slabs: int = 50
) -> float:
    """``finger_cross_section_area`` in Python and numpy: the fallback where
    the host has no C++ compiler, and the oracle of the C++ path's tests."""
    pts = np.concatenate(
        [
            np.stack([x_curve, y_curve], -1),
            np.stack([x_curve, y_curve + width], -1),
        ]
    )
    area = polygon_area_centroid_inertia(convex_hull(pts))[0]
    n = len(x_curve)
    bounds = np.linspace(0, n - 1, num_slabs + 1).astype(int)
    for i in range(num_slabs):
        lo, hi = bounds[i], bounds[i + 1] + 1
        p = np.concatenate(
            [
                np.stack([x_curve[lo:hi], y_curve[lo:hi]], -1),
                np.stack([x_curve[lo:hi], y_curve[lo:hi] + width], -1),
            ]
        )
        area += polygon_area_centroid_inertia(convex_hull(p))[0]
    return float(area)
