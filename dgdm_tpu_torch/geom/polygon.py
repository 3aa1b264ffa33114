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


def ear_clip(verts: np.ndarray) -> np.ndarray:
    """Ear-clipping triangulation of a simple CCW polygon. Host-side only
    (used to build oracle collision meshes). Returns (T, 3) vertex indices.

    Uses the native geomkit kernel when available (~100x the Python loop),
    falling back to the pure-Python implementation below."""
    from dgdm_tpu_torch.geom import native

    nat = native.ear_clip(np.asarray(verts, dtype=np.float64))
    if nat is not None and len(nat) == len(verts) - 2:
        return nat
    n = len(verts)
    idx = list(range(n))
    tris = []

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    guard = 0
    while len(idx) > 3 and guard < 10 * n * n:
        guard += 1
        m = len(idx)
        clipped = False
        for k in range(m):
            i0, i1, i2 = idx[(k - 1) % m], idx[k], idx[(k + 1) % m]
            a, b, c = verts[i0], verts[i1], verts[i2]
            if cross(a, b, c) <= 1e-16:
                continue  # reflex or degenerate
            # no other polygon vertex inside the candidate ear
            others = [j for j in idx if j not in (i0, i1, i2)]
            if others:
                p = verts[others]
                s0 = (b[0] - a[0]) * (p[:, 1] - a[1]) - (b[1] - a[1]) * (p[:, 0] - a[0])
                s1 = (c[0] - b[0]) * (p[:, 1] - b[1]) - (c[1] - b[1]) * (p[:, 0] - b[0])
                s2 = (a[0] - c[0]) * (p[:, 1] - c[1]) - (a[1] - c[1]) * (p[:, 0] - c[0])
                if np.any((s0 > 0) & (s1 > 0) & (s2 > 0)):
                    continue
            tris.append((i0, i1, i2))
            idx.pop(k)
            clipped = True
            break
        if not clipped:
            # tolerate slight non-simplicity: clip the most convex corner
            best, bestv = None, -np.inf
            for k in range(m):
                i0, i1, i2 = idx[(k - 1) % m], idx[k], idx[(k + 1) % m]
                v = cross(verts[i0], verts[i1], verts[i2])
                if v > bestv:
                    best, bestv = k, v
            i0, i1, i2 = idx[(best - 1) % m], idx[best], idx[(best + 1) % m]
            tris.append((i0, i1, i2))
            idx.pop(best)
    if len(idx) == 3:
        tris.append(tuple(idx))
    return np.asarray(tris, dtype=np.int64)


def earclip_anchor_weights(poly: np.ndarray,
                           variant: str = "default",
                           mode: str = "perp") -> np.ndarray:
    """Per-vertex crack-fan anchor weights of the oracle's ear-clip object
    decomposition (sim/oracle.py:_object_prisms).

    MuJoCo never collides the smooth object contour: it collides the
    ear-clip triangle PRISMS, and a finger face that penetrates the hull
    near a vertex contacts the crack walls of every incident triangle —
    measured ~40 contacts with normals spanning 120 deg at a single rim
    vertex (docs/PARITY.md), an omni-directional anchor whose strength
    follows the local fan DEGREE of the triangulation. The weight is the
    incident-triangle count per vertex, normalized to mean 1 so the fitted
    ``rough`` gain keeps its calibrated scale; ``variant="rolled"``
    matches the oracle's rolled-start triangulation (the decisive
    decomposition-sensitivity experiment).

    Returns (P,) float64 weights aligned with ``poly``'s vertices; falls
    back to uniform 1.0 if ear-clipping drops vertices (degenerate input).
    """
    from dgdm_tpu_torch.geom.contour import ensure_ccw

    poly = np.asarray(poly, dtype=np.float64)
    p = ensure_ccw(poly)
    # ensure_ccw reverses CW input — compute in CCW order but return weights
    # indexed by the CALLER's order (the docstring contract; engine2d
    # make_scene attaches them to scene.anchor by index). Same area test.
    x, y = poly[:, 0], poly[:, 1]
    reversed_in = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) < 0
    n = len(p)
    if variant == "rolled":
        r = n // 3
        tris = [tuple((i + r) % n for i in t)
                for t in ear_clip(np.roll(p, -r, axis=0))]
    else:
        tris = ear_clip(p)
    tris = np.asarray(tris, dtype=np.int64)
    if mode == "degree":
        deg = np.zeros(n, dtype=np.float64)
        for t in tris.reshape(-1):
            if 0 <= t < n:
                deg[t] += 1.0
        if deg.sum() <= 0:
            return np.ones(n)
        out = deg / deg.mean()
        return out[::-1] if reversed_in else out
    # mode == "perp": crack walls only block tangential sliding to the
    # extent they stand perpendicular to the local surface — weight each
    # INTERIOR edge at the vertex by |sin(angle to the contour tangent)|.
    boundary = {(i, (i + 1) % n) for i in range(n)}
    boundary |= {(b, a) for a, b in boundary}
    tang = p[(np.arange(n) + 1) % n] - p[np.arange(n) - 1]
    tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-12)
    w = np.zeros(n, dtype=np.float64)
    seen = set()
    for t in tris:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            if (a, b) in boundary or (a, b) in seen or (b, a) in seen:
                continue
            seen.add((a, b))
            e = p[b] - p[a]
            e /= max(np.linalg.norm(e), 1e-12)
            w[a] += abs(e[0] * tang[a][1] - e[1] * tang[a][0])
            w[b] += abs(e[0] * tang[b][1] - e[1] * tang[b][0])
    if w.sum() <= 0:
        return np.ones(n)
    out = w / w.mean()
    return out[::-1] if reversed_in else out


def dedupe_polygon(verts: np.ndarray, tol: float = 1e-12) -> np.ndarray:
    """Drop consecutive duplicate vertices (int-quantized contours have them)."""
    keep = np.ones(len(verts), dtype=bool)
    d = np.linalg.norm(verts - np.roll(verts, 1, axis=0), axis=1)
    keep &= d > tol
    if not keep.any():
        return verts[:1]
    return verts[keep]
