"""Planar contact engine, host part — port of ``dgdm_tpu/sim/engine2d.py``
(``Calib``, the fitted constants, the contact constants, ``make_scene`` with
its finger host-work LRU, and ``pose_grid``).

The 2D scene is strictly planar: an extruded icon polygon on a frictional
plane (3 in-plane DOF plus a vertical drop DOF) between two slide jaws
(kp = 10, damping 1, ctrl clamped to +-0.1) whose inner faces are cubic
splines. The per-step physics of the port lives in the rollout kernel
(``sim/rollout2d.py``, ``csrc/rollout2d.cu``) and its plain PyTorch version
(``sim/rollout2d_ref.py``). ``step_newton``/``step_jacobi`` and the
differentiable rollout of the JAX engine wait for the port of
``design/graddesign.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from dgdm_tpu_torch.core.config import GRIPPER_2D, OBJECT_2D, SIM
from dgdm_tpu_torch.geom import contour as contour_lib
from dgdm_tpu_torch.geom import polygon as polygon_lib
from dgdm_tpu_torch.geom.spline import cubic_basis_matrix, cubic_coef_operator
from dgdm_tpu_torch.sim.types import Scene2D


@dataclasses.dataclass(frozen=True)
class Calib:
    """Effective-parameter knobs fitted against the MuJoCo oracle (see
    ``dgdm_tpu/sim/engine2d.py:Calib`` for the derivation of each): the
    eight that the 2D Newton solve reads, and ``restitution``, which the 3D
    rollout kernel reads (an exact no-op at its default 0.0). The JAX
    package's other 3D probe knobs (all no-ops at their defaults) and its
    jacobi-solver table ``FITTED_2D`` wait for the slices that port those
    paths."""

    mu_plane: float            # effective object-plane sliding friction
    mu_finger: float           # finger-object sliding friction
    mu_torsion: float          # torsional coefficient (meters)
    k_contact: float           # normal constraint stiffness (1/s^2)
    b_contact: float           # normal constraint damping (1/s)
    unload: float              # grip-induced plane-unloading gain
    rough: float               # crack-capture tangential stiction gain (1/s)
    c_r: float                 # constraint compliance scale (Newton solver)
    restitution: float = 0.0   # finger-row velocity restitution (3D Newton)


CALIB_FIELDS = tuple(f.name for f in dataclasses.fields(Calib))


# Fitted for the coupled Newton solver at the shipped 3-iteration
# configuration with a held-out split (runs/calib/calib2d_search_nit3.json).
FITTED_2D_NEWTON = {
    "mu_plane": 0.606041,
    "mu_finger": 0.933939,
    "mu_torsion": 0.00373120,
    "k_contact": 10766.1,
    "b_contact": 103.611,
    "unload": 0.695116,
    "rough": 211.673,
    "c_r": 0.0254995,
}

# contact solver of the JAX package's default configuration: the coupled
# semi-smooth Newton solve on the 5-DOF soft-constraint energy ("jacobi" is
# not ported yet)
SOLVER = "newton"


def default_calib() -> Calib:
    """FITTED_2D_NEWTON rounded to float32, as the JAX package stores it."""
    return Calib(**{k: float(np.float32(v))
                    for k, v in FITTED_2D_NEWTON.items()})


# contact gains (acceleration units, MuJoCo solref-style); the plane gains are
# stiffer, matching the ~1e-4 m resting penetration the oracle shows
K_CONTACT = SIM.contact_k
B_CONTACT = SIM.contact_b
K_PLANE = 1.0e5
B_PLANE = 650.0
# grip-induced plane-unloading gain (dimensionless; 0 disables)
UNLOAD = 0.0
# saturation depth for the elastic wedge term (stability clamp)
DEPTH_EL_CAP = 0.003
# crack-capture gain (fitted; 0 disables) and its saturation depth
ROUGH = 0.0
ROUGH_SAT = 5.0e-4
# contact-solver iterations of the jacobi solver; MuJoCo solimp d
SOLVER_ITERS = 6
IMPEDANCE = 0.95
# coupled Newton solve: iterations and line-search step sizes
NEWTON_ITERS = 3
_LS_ALPHAS = (1.0, 0.5)


def upsample_contour(poly: np.ndarray, k: int) -> np.ndarray:
    """Insert k-1 evenly spaced points on every polygon edge (densifies the
    point-vs-heightfield contact set; see the JAX engine's notes)."""
    if k <= 1:
        return poly
    nxt = np.roll(poly, -1, axis=0)
    fr = np.arange(k, dtype=np.float64)[None, :, None] / k
    dense = poly[:, None, :] * (1.0 - fr) + nxt[:, None, :] * fr
    return dense.reshape(-1, poly.shape[1])


# Per-jaw host work: the cubic coefficient transform is cheap, but the exact
# MuJoCo jaw mass (hull of the full strip + 50 overlapping slab hulls) costs
# ~8 ms/jaw, so it is computed once per gripper and kept in an LRU.
_FINGER_CACHE_2D: "dict[bytes, tuple]" = {}
_FINGER_CACHE_2D_MAX = 4096


def _finger_host_work_2d(y: np.ndarray):
    g = GRIPPER_2D
    key = y.tobytes()
    hit = _FINGER_CACHE_2D.pop(key, None)
    if hit is not None:
        _FINGER_CACHE_2D[key] = hit     # pop+reinsert: true LRU, not FIFO
        return hit
    coef_op = cubic_coef_operator(g.num_ctrl, g.ctrl_x_min, g.ctrl_x_max)
    coef = np.einsum("skn,n->sk", coef_op, y)
    x_curve = np.linspace(g.ctrl_x_min, g.ctrl_x_max, g.num_curve_points)
    basis = cubic_basis_matrix(g.num_ctrl, g.ctrl_x_min, g.ctrl_x_max, x_curve)
    fmass = SIM.density * g.height * polygon_lib.finger_cross_section_area(
        basis @ y, x_curve, g.width
    )
    if len(_FINGER_CACHE_2D) >= _FINGER_CACHE_2D_MAX:
        _FINGER_CACHE_2D.pop(next(iter(_FINGER_CACHE_2D)))
    out = (coef, float(fmass))
    _FINGER_CACHE_2D[key] = out
    return out


def make_scene(
    yl: np.ndarray,
    yr: np.ndarray,
    contour: np.ndarray,
    support_grid: int = 8,
    contour_upsample: int = 1,
    triangulation: str = "uniform",
) -> Scene2D:
    """Host-side scene construction from raw control points + object contour.

    Mass/COM/inertia reproduce MuJoCo's model of the oracle scene exactly
    (geom/polygon.py). Pure numpy until the final float32 tensors, which stay
    on the host: ``rollout2d.scene_arrays`` moves a stacked batch to the
    device in one copy per array."""
    coef_l, ml = _finger_host_work_2d(np.asarray(yl, np.float64))
    coef_r, mr = _finger_host_work_2d(np.asarray(yr, np.float64))
    fmass = np.array([ml, mr])
    poly = contour_lib.ensure_ccw(np.asarray(contour, dtype=np.float64))
    area, com, i0 = polygon_lib.object_mass_properties_2d(poly)
    poly_c = upsample_contour(poly, contour_upsample)
    spts, sw = polygon_lib.support_points(poly, grid=support_grid)
    mass = SIM.density * area * OBJECT_2D.height
    inertia = SIM.density * OBJECT_2D.height * i0
    if triangulation == "uniform":
        anchor = np.ones(1, np.float64)
    else:
        anchor = polygon_lib.earclip_anchor_weights(
            poly, variant=triangulation)
        if contour_upsample > 1:
            k = contour_upsample
            fr = np.arange(k, dtype=np.float64)[None, :] / k
            nxt = np.roll(anchor, -1)
            anchor = (anchor[:, None] * (1.0 - fr)
                      + nxt[:, None] * fr).reshape(-1)[: len(poly_c)]
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32)
    return Scene2D(
        coef_l=f32(coef_l),
        coef_r=f32(coef_r),
        contour=f32(poly_c),
        com=f32(com),
        mass=f32(mass),
        inertia=f32(inertia),
        support_pts=f32(spts),
        support_w=f32(sw),
        finger_mass=f32(fmass),
        anchor=f32(anchor),
    )


def pose_grid(
    grid_size: int = SIM.grid_size,
    num_pos: int = SIM.num_pos,
    pos_extent: float = SIM.pos_extent,
) -> np.ndarray:
    """The reference datagen pose lattice (sim/sim_2d.py:139-143), flattened in
    the same (rot-major, then x, then y) order the npz arrays use."""
    z_rots = np.arange(grid_size) * (2.0 * np.pi / grid_size)
    if num_pos == 1:
        locs = np.zeros(1)
    else:
        locs = -pos_extent + 2.0 * pos_extent * np.arange(num_pos) / (num_pos - 1)
    k, i, j = np.meshgrid(z_rots, locs, locs, indexing="ij")
    return np.stack([i.reshape(-1), j.reshape(-1), k.reshape(-1)], -1).astype(
        np.float32
    )
