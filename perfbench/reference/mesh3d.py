"""Triangle-mesh utilities (OBJ IO, surface sampling, volume integrals) —
port of ``dgdm_tpu/geom/mesh3d.py``, a numpy copy.

Replaces the reference's trimesh/open3d dependencies
(``dynamics/utils.py:14-18`` uniform surface sampling,
``assets/scan_object_process.py:8-40`` bbox filtering, MuJoCo's mesh inertia).
Pure numpy, host-side.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader: vertices (V, 3) float64, faces (F, 3) int64.
    Polygons are fan-triangulated; v/vt/vn indices use the vertex slot."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int64)


def triangle_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)


def sample_surface(
    verts: np.ndarray, faces: np.ndarray, n: int, seed: int = 0
) -> np.ndarray:
    """Uniform area-weighted surface sampling (open3d
    ``sample_points_uniformly`` equivalent)."""
    rng = np.random.RandomState(seed)
    areas = triangle_areas(verts, faces)
    probs = areas / areas.sum()
    tri = rng.choice(len(faces), size=n, p=probs)
    u = rng.rand(n, 1)
    v = rng.rand(n, 1)
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    a = verts[faces[tri, 0]]
    b = verts[faces[tri, 1]]
    c = verts[faces[tri, 2]]
    return a + u * (b - a) + v * (c - a)


def mass_properties(
    verts: np.ndarray, faces: np.ndarray, density: float = 1000.0
) -> Tuple[float, np.ndarray, np.ndarray]:
    """(mass, com (3,), inertia tensor about COM (3, 3)) of a closed mesh via
    signed-tetrahedron integrals (the same construction MuJoCo uses for
    legacy-inertia mesh geoms)."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    det = np.einsum("ij,ij->i", a, np.cross(b, c))       # 6 * signed volume
    vol = det.sum() / 6.0
    com = ((a + b + c) / 4.0 * det[:, None]).sum(0) / (6.0 * vol)

    # canonical tetra inertia integrals (covariance form)
    cov = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            s = (
                np.einsum("k,k->", det,
                          (a[:, i] * a[:, j] + b[:, i] * b[:, j] + c[:, i] * c[:, j])
                          + 0.5 * (a[:, i] * b[:, j] + b[:, i] * a[:, j]
                                   + a[:, i] * c[:, j] + c[:, i] * a[:, j]
                                   + b[:, i] * c[:, j] + c[:, i] * b[:, j]))
            )
            cov[i, j] = s / 60.0
    cov -= vol * np.outer(com, com)
    inertia = np.eye(3) * np.trace(cov) - cov
    return density * vol, com, density * inertia


def bbox(verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return verts.min(0), verts.max(0)


