"""Piecewise-polynomial fit of the 3D finger contact surface in world
coordinates — port of ``dgdm_tpu/sim/surface_fit.py``.

The contact surface is the convex-hull envelope of the finger's 12x2 slab
decomposition (``geom/envelope3d.py``): piecewise planar with its dominant
ridges on the 12 x-slab boundaries and the mid-z split. The fit grid mirrors
that structure: one cubic-in-x x quadratic-in-z polynomial per (x-slab,
z-slab) cell, so no polynomial straddles a dominant ridge. The rollout
kernel evaluates a cell with a direct index ``seg = xseg * NZ_SEG + zseg``
and a bivariate Horner. Host-side numpy; the smooth-sheet path evaluates the
B-spline with torch.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.config import GRIPPER_3D
from perfbench.reference.spline import gripper3d_surface

N_SEG = 12      # x cells, aligned to the 12 envelope slab boundaries
NZ_SEG = 2      # z cells, aligned to the 12x2 decomposition's mid-z split
TOT_SEG = N_SEG * NZ_SEG
DEG_X, DEG_Z = 3, 2


def _cell_samples(samples_per_seg: int, samples_z: int):
    """Per-cell local sample offsets (t, s) and world sample grids."""
    g = GRIPPER_3D
    h = (g.ctrl_x_max - g.ctrl_x_min) / N_SEG
    hz = (g.ctrl_z_max - g.ctrl_z_min) / NZ_SEG
    t = np.linspace(0.0, h, samples_per_seg)
    s = np.linspace(0.0, hz, samples_z)
    xs, zs = [], []
    for xseg in range(N_SEG):
        for zseg in range(NZ_SEG):
            xs.append(g.ctrl_x_min + xseg * h + t)
            zs.append(g.ctrl_z_min + zseg * hz + s)
    return h, hz, t, s, np.asarray(xs), np.asarray(zs)


def fit_surface_batch(y_ctrls: np.ndarray, samples_per_seg: int = 12,
                      samples_z: int = 9, sides=None) -> np.ndarray:
    """(B, 21) or (B, 7, 3) -> (B, TOT_SEG, DEG_X+1, DEG_Z+1).

    ``sides`` (len B, 'upper'/'lower') switches each row to the hull-
    envelope contact surface when engine3d.CONTACT_SURFACE_3D='envelope'
    (the left jaw's inner face points +y -> 'upper'; right -> 'lower').

    ``y(x, z) = sum_{a,b} C[seg, a, b] * t^a * s^b`` with
    seg = xseg * NZ_SEG + zseg, t = x - cell_x0, s = z - cell_z0."""
    from perfbench.reference import scene3d as engine3d

    g = GRIPPER_3D
    ycs = np.asarray(y_ctrls).reshape(-1, g.nu, g.nv)
    h, hz, t, s, xs, zs = _cell_samples(samples_per_seg, samples_z)
    # world sample grid per cell: (TOT_SEG, samples_per_seg, samples_z)
    gx = np.broadcast_to(xs[:, :, None],
                         (TOT_SEG, samples_per_seg, samples_z))
    gz = np.broadcast_to(zs[:, None, :],
                         (TOT_SEG, samples_per_seg, samples_z))
    if engine3d.CONTACT_SURFACE_3D == "envelope" and sides is not None:
        from perfbench.reference.envelope3d import finger_envelope

        vals = np.stack([
            finger_envelope(yc, gx.reshape(-1), gz.reshape(-1),
                            side=sides[k])[0]
            for k, yc in enumerate(ycs.reshape(len(ycs), -1))
        ]).reshape(len(ycs), TOT_SEG, samples_per_seg * samples_z)
    else:
        fx = torch.as_tensor(gx.reshape(-1), dtype=torch.float32)
        fz = torch.as_tensor(gz.reshape(-1), dtype=torch.float32)
        vals = gripper3d_surface().height(
            torch.as_tensor(ycs, dtype=torch.float32), fx, fz
        ).numpy().reshape(len(ycs), TOT_SEG, samples_per_seg * samples_z)
    # the design matrix is identical for every cell: precompute its pinv
    tt = np.tile(t[:, None], (1, samples_z)).reshape(-1)
    ss = np.tile(s[None, :], (samples_per_seg, 1)).reshape(-1)
    cols = [tt**a * ss**b for a in range(DEG_X + 1) for b in range(DEG_Z + 1)]
    pinv = np.linalg.pinv(np.stack(cols, -1))
    return np.einsum("cn,bsn->bsc", pinv, vals).reshape(
        len(ycs), TOT_SEG, DEG_X + 1, DEG_Z + 1
    )


