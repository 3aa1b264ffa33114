"""The 2D scene of the benchmark's reference: a frozen copy of the scene
half of ``dgdm_tpu_torch/sim/engine2d.py`` (``Calib``, the fitted tables,
the contact constants, ``make_scene``, ``pose_grid``), of
``sim/datagen.py``'s ``stack_scenes`` and ``pad_poses`` and of
``sim/rollout2d.py``'s ``scene_arrays``, so that the reference builds every
scene again from the gripper's control values and the object's contour
without importing the program. The solver is the configuration's: the
coupled Newton solve.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import numpy as np
import torch

from perfbench.reference.config import GRIPPER_2D, OBJECT_2D, SIM
from perfbench.reference import contour as contour_lib
from perfbench.reference import polygon as polygon_lib
from perfbench.reference.spline import cubic_basis_matrix, cubic_coef_operator
from perfbench.reference.scene_types import Scene2D

# poses a block of the rollout kernel
LANE = 128
# per-pair scalar slots of the kernel's input
N_SCALARS = 16


@dataclasses.dataclass(frozen=True)
class Calib:
    """Effective-parameter knobs fitted against the MuJoCo oracle (see
    ``dgdm_tpu/sim/engine2d.py:Calib`` for the derivation of each): the
    eight that the 2D Newton solve reads, and ``restitution`` (read by the
    3D rollout kernel). The kernels' callers write ``float()`` of each
    field into their scalar slots."""

    mu_plane: float            # effective object-plane sliding friction
    mu_finger: float           # finger-object sliding friction
    mu_torsion: float          # torsional coefficient (meters)
    k_contact: float           # normal constraint stiffness (1/s^2)
    b_contact: float           # normal constraint damping (1/s)
    unload: float              # grip-induced plane-unloading gain
    rough: float               # crack-capture tangential stiction gain (1/s)
    c_r: float                 # constraint compliance scale (Newton solver)
    restitution: float = 0.0   # finger-row velocity restitution (3D Newton)


# Fitted for the coupled Newton solver (the configuration's) at the shipped
# 3-iteration configuration with a held-out split
# (runs/calib/calib2d_search_nit3.json).
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


def default_calib() -> Calib:
    """The Newton solver's fitted table rounded to float32, as the JAX
    package stores it."""
    return Calib(**{k: float(np.float32(v))
                    for k, v in FITTED_2D_NEWTON.items()})


# contact gains (acceleration units, MuJoCo solref-style); the plane gains are
# stiffer, matching the ~1e-4 m resting penetration the oracle shows
K_CONTACT = SIM.contact_k
B_CONTACT = SIM.contact_b
K_PLANE = 1.0e5
B_PLANE = 650.0
# saturation depth for the elastic wedge term (stability clamp)
DEPTH_EL_CAP = 0.003
# saturation depth of the crack-capture term
ROUGH_SAT = 5.0e-4
# MuJoCo solimp d
IMPEDANCE = 0.95
# coupled Newton solve: iterations
NEWTON_ITERS = 3


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



def stack_scenes(scenes):
    """Stack Scene2D or Scene3D pairs along a new leading dimension (a field
    that is None in every pair stays None)."""
    cls = type(scenes[0])
    out = {}
    for f in dataclasses.fields(cls):
        vals = [getattr(s, f.name) for s in scenes]
        out[f.name] = (None if all(v is None for v in vals)
                       else torch.stack(vals))
    return cls(**out)


def pad_poses(poses: np.ndarray, lane: int = LANE) -> np.ndarray:
    """Pad the pose axis with the last pose to a multiple of ``lane``."""
    pad = (-poses.shape[0]) % lane
    if not pad:
        return poses
    filler = np.broadcast_to(poses[-1], (pad,) + poses.shape[1:])
    return np.concatenate([poses, filler], axis=0)


def scene_arrays(scenes, calib: Optional[Calib] = None,
                 device="cuda") -> Tuple[torch.Tensor, ...]:
    """Stacked Scene2D (leading dim B) -> the dense float32 inputs of
    ``profile_batch`` on ``device``: coefs (B, 2, 6, 4), contour (B, P, 2),
    support (B, S, 4), scalars (B, 1, 16). ``calib`` rides in the scalar
    slots (layout: dgdm_tpu/sim/pallas2d.py:scene_arrays)."""
    if calib is None:
        calib = default_calib()
    anc = scenes.anchor.numpy()
    if anc.ndim and anc.shape[-1] > 1 and not np.allclose(anc, 1.0):
        warnings.warn(
            "scene_arrays: non-uniform Scene2D.anchor is ignored by the "
            "rollout kernel", stacklevel=2)
    coefs = np.stack([scenes.coef_l.numpy(), scenes.coef_r.numpy()], axis=1)
    spts = scenes.support_pts.numpy()
    b, s_ = spts.shape[:2]
    support = np.concatenate(
        [spts, scenes.support_w.numpy()[..., None],
         np.zeros((b, s_, 1), np.float32)], axis=-1)
    com = scenes.com.numpy()
    fmass = scenes.finger_mass.numpy()
    scal = np.zeros((b, 1, N_SCALARS), np.float32)
    scal[:, 0, 0] = scenes.mass.numpy()
    scal[:, 0, 1] = scenes.inertia.numpy()
    scal[:, 0, 2] = fmass[..., 0]
    scal[:, 0, 3] = com[:, 0]
    scal[:, 0, 4] = com[:, 1]
    scal[:, 0, 5] = fmass[..., 1]
    for k, name in enumerate(("mu_plane", "mu_finger", "mu_torsion",
                              "k_contact", "b_contact", "unload", "rough",
                              "c_r"), start=6):
        scal[:, 0, k] = float(getattr(calib, name))
    # broad-phase bounds of the no-contact fast path: finger contact is
    # impossible unless cy <= A + ql (left) or cy >= B + qr (right); A/B fold
    # the dense-grid spline extremum (padded by 1e-3) and the object's max
    # COM radius (conservative: ignores the x-window)
    g = GRIPPER_2D
    h = (g.ctrl_x_max - g.ctrl_x_min) / (g.num_ctrl - 1)
    t = np.linspace(0.0, h, 64, dtype=np.float64)
    vals = (coefs[..., 0:1] + coefs[..., 1:2] * t + coefs[..., 2:3] * t**2
            + coefs[..., 3:4] * t**3)                   # (B, 2, 6, T)
    fmax_l = vals[:, 0].max(axis=(1, 2)) + 1e-3
    fmin_r = vals[:, 1].min(axis=(1, 2)) - 1e-3
    rel = scenes.contour.numpy() - com[:, None, :]
    r_max = np.sqrt((rel**2).sum(-1)).max(axis=1)
    scal[:, 0, 14] = (-g.jaw_offset + g.width) + fmax_l + r_max   # A
    scal[:, 0, 15] = g.jaw_offset + fmin_r - r_max                 # B
    return tuple(torch.as_tensor(a).to(device)
                 for a in (coefs, scenes.contour.numpy(), support, scal))
