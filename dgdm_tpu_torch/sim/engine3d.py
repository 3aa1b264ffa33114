"""3D contact engine, host part — port of ``dgdm_tpu/sim/engine3d.py``
(the contact constants, the fitted Newton calibration, ``finger_masses_3d``,
``object_properties_3d``, ``corner_weights_3d`` and ``make_scene`` with its
per-gripper host-work LRU).

The object is a 6-DOF rigid body (quaternion attitude) described by surface
sample points; each jaw is a 1-DOF slide joint along y carrying a B-spline
surface finger whose inner face is the heightfield y = f(x, z), contacted
through the convex-hull envelope of its slab decomposition
(``geom/envelope3d.py``). The per-step physics of the port lives in the
rollout kernel (``sim/rollout3d.py``, ``csrc/rollout3d.cu``) and its plain
PyTorch version (``sim/rollout3d_ref.py``). The JAX package's pure engine
(``step*``, ``bake_height_grids`` and the ``hgrid`` it bakes) waits for a
later slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dgdm_tpu_torch.core.config import GRIPPER_3D, SIM
from dgdm_tpu_torch.sim.engine2d import Calib
from dgdm_tpu_torch.sim.types import Scene3D

K_PLANE3 = 2.5e4
B_PLANE3 = 300.0
# iterations of the jacobi solver (not ported; kept for constant parity)
SOLVER_ITERS = 8
# closing speed (m/s) above which finger-row restitution fires
V_REST_THRESH = 0.05
# contact surface model of the fingers: "envelope" = the convex-hull
# envelope of the slab decomposition (what MuJoCo contacts); "smooth" = the
# bare B-spline sheet
CONTACT_SURFACE_3D = "envelope"

# Fitted for the coupled Newton solver through the fused rollout kernel at
# 192 contact points and one Newton iteration (see the JAX module for the
# search and its statistics). mu_torsion is inert in the 3D Newton path.
FITTED_3D_NEWTON = {
    "mu_plane": 0.1098595585158766,
    "mu_finger": 0.16985552065762255,
    "mu_torsion": 0.00458153,
    "k_contact": 15724.569062772094,
    "b_contact": 115.80794925673753,
    "unload": 2.702276478255927,
    "rough": 126.34874804571092,
    "c_r": 0.3690845085780728,
}

# contact solver: the coupled semi-smooth Newton solve ("jacobi" and
# "pyramid" are not ported)
SOLVER3 = "newton"
# full-solve Newton iterations per step (the rollout kernel's count)
NEWTON_ITERS3 = 1


def default_calib3() -> Calib:
    """FITTED_3D_NEWTON rounded to float32, as the JAX package stores it."""
    return Calib(**{k: float(np.float32(v))
                    for k, v in FITTED_3D_NEWTON.items()})


def finger_masses_3d(yl: np.ndarray, yr: np.ndarray,
                     decomps=((12, 2),)) -> np.ndarray:
    """Per-jaw masses of the oracle scene: MuJoCo convex-hulls every
    vertex-only mesh, so a jaw = hull(visual sheet) + the slab hulls of the
    12x2 decomposition the engine models."""
    from scipy.spatial import ConvexHull

    from dgdm_tpu_torch.geom.envelope3d import (
        _finger_slab_meshes,
        _surface_grid,
    )

    g = GRIPPER_3D
    out = []
    for y in (yl, yr):
        grid = _surface_grid(np.asarray(y)).reshape(-1, 3)
        vis = ConvexHull(
            np.concatenate([grid, grid + [0, g.width, 0]])
        ).volume
        per_dec = []
        for nx_s, nz_s in decomps:
            vol = vis
            for slab in _finger_slab_meshes(np.asarray(y), nx_s, num_z=nz_s):
                vol += ConvexHull(slab).volume
            per_dec.append(SIM.density * vol)
        out.append(float(np.mean(per_dec)))
    return np.asarray(out)


def object_properties_3d(verts: np.ndarray, faces: np.ndarray,
                         num_points: int = 256, seed: int = 0):
    """Object-side host work of make_scene (mass/inertia integration +
    surface point sampling). Compute once per object and pass to make_scene
    via ``obj_props`` when building a gripper block. Note the default of 256
    points: every caller on the kernel's paths (verification, datagen) uses
    it, so the kernel runs at P = 256, not at make_scene's documented 192."""
    from dgdm_tpu_torch.geom import mesh3d

    mass, com, inertia = mesh3d.mass_properties(verts, faces, SIM.density)
    mass *= SIM.mass_factor
    inertia = inertia * SIM.mass_factor
    pts = mesh3d.sample_surface(verts, faces, num_points, seed=seed)
    return mass, com, inertia, pts, corner_weights_3d(pts)


def corner_weights_3d(pts: np.ndarray, z_tol: float = 2e-3,
                      r_tol: float = 2.5e-3) -> np.ndarray:
    """Per-point plane-support corner weight in [0, 1]: 1 for sampled
    surface points on the bottom face near a footprint convex-hull vertex,
    0 elsewhere."""
    pts = np.asarray(pts, np.float64)
    zmin = pts[:, 2].min()
    bottom = pts[:, 2] <= zmin + z_tol
    w = np.zeros(pts.shape[0], np.float32)
    bxy = pts[bottom, :2]
    if bxy.shape[0] >= 3:
        from scipy.spatial import ConvexHull, QhullError

        try:
            hull_xy = bxy[ConvexHull(bxy).vertices]
        except QhullError:                  # collinear footprint
            hull_xy = bxy
        d2 = ((pts[:, None, :2] - hull_xy[None]) ** 2).sum(-1).min(-1)
        w = (bottom & (d2 <= r_tol**2)).astype(np.float32)
    if w.sum() < 3.0:                       # degenerate: keep the patch
        w = bottom.astype(np.float32)
    return w


# Per-gripper host work (the exact hull masses, ~0.03 s a gripper) is done
# once per gripper and kept in an LRU, as the JAX package keeps its bake.
_GRIP_CACHE: "dict[bytes, np.ndarray]" = {}
_GRIP_CACHE_MAX = 1024


def _gripper_host_work(yl: np.ndarray, yr: np.ndarray) -> np.ndarray:
    key = yl.tobytes() + yr.tobytes()
    hit = _GRIP_CACHE.pop(key, None)
    if hit is not None:
        _GRIP_CACHE[key] = hit          # pop+reinsert: true LRU, not FIFO
        return hit
    out = finger_masses_3d(yl, yr)
    if len(_GRIP_CACHE) >= _GRIP_CACHE_MAX:
        _GRIP_CACHE.pop(next(iter(_GRIP_CACHE)))
    _GRIP_CACHE[key] = out
    return out


def make_scene(
    yl: np.ndarray,
    yr: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    num_points: int = 192,
    seed: int = 0,
    obj_props=None,
) -> Scene3D:
    """yl/yr: (21,) finger ctrl y values (x-major grid order); verts/faces:
    the object mesh (watertight). ``obj_props`` is ``object_properties_3d``'s
    result, shared by a gripper block; without it the object is sampled at
    ``num_points`` contact points here.

    Pure numpy until the final float32 tensors, which stay on the host:
    ``rollout3d.scene_arrays_3d`` moves a stacked batch to the device."""
    g = GRIPPER_3D
    fmass = _gripper_host_work(np.asarray(yl), np.asarray(yr))
    if obj_props is None:
        obj_props = object_properties_3d(verts, faces, num_points, seed)
    mass, com, inertia, pts, corner_w = obj_props
    f32 = functools.partial(np.asarray, dtype=np.float32)
    t = torch.from_numpy
    return Scene3D(
        yl=t(f32(np.asarray(yl).reshape(g.nu, g.nv))),
        yr=t(f32(np.asarray(yr).reshape(g.nu, g.nv))),
        points=t(f32(pts)),
        com=t(f32(com)),
        mass=t(f32(mass)),
        inertia=t(f32(inertia)),
        inv_inertia=t(f32(np.linalg.inv(inertia))),
        bottom_w=t(f32(corner_w)),
        finger_mass=t(f32(fmass)),
    )
