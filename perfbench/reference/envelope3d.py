"""Convex-hull contact envelopes of the 3D finger surface — port of
``dgdm_tpu/geom/envelope3d.py``, with the port's own copies of the surface
grid and slab helpers that the JAX package keeps in ``sim/oracle3d.py``
(``_surface_grid``, ``_finger_slab_meshes``).

The reference never contacts the smooth B-spline sheet: fingers are
V-HACD-decomposed into convex hulls (``sim/sim_3d.py:25-70``, ``-h 32``) and
MuJoCo contacts the HULLS, whose faces bridge every concavity of the sheet
with planar chords. The engine and the rollout kernel contact the per-patch
convex envelope of the 12x2 slab decomposition (24 hulls, the V-HACD
budget); see the JAX module for the measurements behind that choice.

The sheet comes from ``BSplineSurfaceY.height`` in float32 and feeds
``scipy.spatial.ConvexHull``, so its values decide facet choices.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.config import GRIPPER_3D
from perfbench.reference.spline import (
    bspline_basis,
    clamped_knot_vector,
    gripper3d_surface,
)

# The decomposition the engine and the kernel contact: 12 x-slabs x 2 z-slabs.
DEFAULT_DECOMPS: Tuple[Tuple[int, int], ...] = ((12, 2),)


def _surface_grid(y_ctrl: np.ndarray, sample_size: int = 25) -> np.ndarray:
    """(S, S, 3) surface points on the geomdl grid (x varies along axis 0)."""
    g = GRIPPER_3D
    uu = np.linspace(0, 1, sample_size)
    ku = clamped_knot_vector(g.degree_u, g.nu)
    kv = clamped_knot_vector(g.degree_v, g.nv)
    xs = bspline_basis(g.degree_u, ku, g.nu, uu) @ np.linspace(
        g.ctrl_x_min, g.ctrl_x_max, g.nu
    )
    zs = bspline_basis(g.degree_v, kv, g.nv, uu) @ np.linspace(
        g.ctrl_z_min, g.ctrl_z_max, g.nv
    )
    gx = np.repeat(xs, sample_size)
    gz = np.tile(zs, sample_size)
    ys = gripper3d_surface().height(
        *(torch.as_tensor(a, dtype=torch.float32) for a in
          (np.asarray(y_ctrl).reshape(g.nu, g.nv), gx, gz))
    ).numpy()
    return np.stack([gx, ys, gz], -1).reshape(sample_size, sample_size, 3)


def _finger_slab_meshes(y_ctrl: np.ndarray, num_slabs: int = 12,
                        sample_size: int = 25, num_z: int = 1) -> list:
    """Convex slabs: surface patches (x-strips, optionally z-split) plus their
    +width copies. MuJoCo convex-hulls each patch, so the effective contact
    face is the patch's convex envelope."""
    g = GRIPPER_3D
    grid = _surface_grid(y_ctrl, sample_size)          # (S, S, 3)
    bx = np.linspace(0, sample_size - 1, num_slabs + 1).astype(int)
    bz = np.linspace(0, sample_size - 1, num_z + 1).astype(int)
    slabs = []
    for i in range(num_slabs):
        for j in range(num_z):
            sheet = grid[bx[i]: bx[i + 1] + 1,
                         bz[j]: bz[j + 1] + 1].reshape(-1, 3)
            verts = np.concatenate([sheet, sheet + [0, g.width, 0]])
            slabs.append(verts)
    return slabs


def _patch_upper_facets(sheet: np.ndarray):
    """Upper-y facet planes of hull(sheet): rows (nx, ny, nz, off) with
    ny > 0 and plane eval y = (-off - nx x - nz z)/ny. Falls back to the
    least-squares plane for (near-)degenerate patches."""
    from scipy.spatial import ConvexHull, QhullError

    try:
        eqs = ConvexHull(sheet).equations
        up = eqs[eqs[:, 1] > 1e-9]
        if len(up):
            return up
    except QhullError:
        pass
    # planar patch: single fitted plane
    a = np.stack([sheet[:, 0], sheet[:, 2], np.ones(len(sheet))], -1)
    cx, cz, c0 = np.linalg.lstsq(a, sheet[:, 1], rcond=None)[0]
    # y = cx x + cz z + c0  ->  (-cx) x + 1 y + (-cz) z + (-c0) = 0
    return np.asarray([[-cx, 1.0, -cz, -c0]])


def _envelope_one(y_ctrl: np.ndarray, qx: np.ndarray, qz: np.ndarray,
                  nx_slabs: int, nz_slabs: int, sample_size: int):
    """Upper envelope (height, dy/dx, dy/dz) of one decomposition."""
    grid = _surface_grid(np.asarray(y_ctrl), sample_size)   # (S, S, 3)
    bx = np.linspace(0, sample_size - 1, nx_slabs + 1).astype(int)
    bz = np.linspace(0, sample_size - 1, nz_slabs + 1).astype(int)
    y_env = np.full(qx.shape, -np.inf)
    sx = np.zeros_like(qx)
    sz = np.zeros_like(qx)
    for i in range(nx_slabs):
        for j in range(nz_slabs):
            sheet = grid[bx[i]: bx[i + 1] + 1,
                         bz[j]: bz[j + 1] + 1].reshape(-1, 3)
            up = _patch_upper_facets(sheet)
            ys = (
                -up[:, 3][None, :]
                - up[:, 0][None, :] * qx[:, None]
                - up[:, 2][None, :] * qz[:, None]
            ) / up[:, 1][None, :]
            k = np.argmin(ys, 1)
            y_here = ys[np.arange(len(qx)), k]
            inside = (
                (qx >= sheet[:, 0].min() - 1e-9)
                & (qx <= sheet[:, 0].max() + 1e-9)
                & (qz >= sheet[:, 2].min() - 1e-9)
                & (qz <= sheet[:, 2].max() + 1e-9)
            )
            take = inside & (y_here > y_env)
            y_env = np.where(take, y_here, y_env)
            nrm = up[k]
            sx = np.where(take, -nrm[:, 0] / nrm[:, 1], sx)
            sz = np.where(take, -nrm[:, 2] / nrm[:, 1], sz)
    return y_env, sx, sz


def finger_envelope(
    y_ctrl: np.ndarray,
    qx: np.ndarray,
    qz: np.ndarray,
    side: str,
    decomps: Sequence[Tuple[int, int]] = DEFAULT_DECOMPS,
    sample_size: int = 25,
):
    """Decomposition-mean hull-envelope height + slopes at (qx, qz).

    side='upper' for the LEFT finger (inner face points +y),
    side='lower' for the RIGHT (inner face points -y; the lower envelope is
    computed as the negated upper envelope of the negated sheet)."""
    qx = np.asarray(qx, np.float64).reshape(-1)
    qz = np.asarray(qz, np.float64).reshape(-1)
    yc = np.asarray(y_ctrl, np.float64)
    sgn = 1.0 if side == "upper" else -1.0
    hs, xs, zs = [], [], []
    for nx_s, nz_s in decomps:
        h, sx, sz = _envelope_one(sgn * yc, qx, qz, nx_s, nz_s, sample_size)
        hs.append(sgn * h)
        xs.append(sgn * sx)
        zs.append(sgn * sz)
    return (np.mean(hs, 0), np.mean(xs, 0), np.mean(zs, 0))
