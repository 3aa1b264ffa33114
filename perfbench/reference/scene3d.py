"""The 3D scene of the benchmark's reference: a frozen copy of the scene
half of ``dgdm_tpu_torch/sim/engine3d.py`` (the fitted tables, the contact
constants, the jaws' hull masses, ``object_properties_3d``,
``make_scene``) and of ``sim/rollout3d.py``'s ``scene_arrays_3d`` (its
surface fits made anew every call: no cache), so that the reference builds
every scene again from the gripper's control values and the object's mesh
without importing the program.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from perfbench.reference.config import GRIPPER_3D, SIM
from perfbench.reference.scene2d import Calib
from perfbench.reference.scene_types import Scene3D
from perfbench.reference.surface_fit import (
    DEG_X,
    DEG_Z,
    N_SEG,
    NZ_SEG,
    TOT_SEG,
    fit_surface_batch,
)

# per-pair scalar slots of the kernel's input
N_SCALARS = 32

K_PLANE3 = 2.5e4
B_PLANE3 = 300.0
# closing speed (m/s) above which finger-row restitution fires
V_REST_THRESH = 0.05

# contact surface model of the fingers: "envelope" = the convex-hull
# envelope of the slab decomposition (what MuJoCo contacts); "smooth" = the
# bare B-spline sheet
CONTACT_SURFACE_3D = "envelope"

# Fitted for the coupled Newton solver (the configuration's) through the
# fused rollout kernel at 192 contact points and one Newton iteration (see
# the JAX module for the search and its statistics). mu_torsion is inert in
# the 3D Newton path.
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


def default_calib3() -> Calib:
    """The Newton solver's fitted table rounded to float32, as the JAX
    package stores it (dgdm_tpu/sim/engine3d.py:112-128)."""
    return Calib(**{k: float(np.float32(v))
                    for k, v in FITTED_3D_NEWTON.items()})


def finger_masses_3d(yl: np.ndarray, yr: np.ndarray,
                     decomps=((12, 2),)) -> np.ndarray:
    """Per-jaw masses of the oracle scene: MuJoCo convex-hulls every
    vertex-only mesh, so a jaw = hull(visual sheet) + the slab hulls of the
    12x2 decomposition the engine models."""
    from scipy.spatial import ConvexHull

    from perfbench.reference.envelope3d import (
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
    from perfbench.reference import mesh3d

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


# Per-gripper host work, done once per gripper and kept in a bounded LRU
# keyed on the control points and the contact-surface mode: the exact hull
# masses (~0.03 s a gripper, every scene).
_GRIP_CACHE: "dict[bytes, np.ndarray]" = {}
_GRIP_CACHE_MAX = 1024


def _lru(cache: dict, key: bytes, make):
    hit = cache.pop(key, None)
    if hit is None:
        hit = make()
        if len(cache) >= _GRIP_CACHE_MAX:
            cache.pop(next(iter(cache)))
    cache[key] = hit                # pop+reinsert: true LRU, not FIFO
    return hit


def _gripper_host_work(yl: np.ndarray, yr: np.ndarray) -> np.ndarray:
    key = yl.tobytes() + yr.tobytes() + CONTACT_SURFACE_3D.encode()
    return _lru(_GRIP_CACHE, key, lambda: finger_masses_3d(yl, yr))


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
    ``scene_arrays_3d`` moves a stacked batch to the device. The height
    grid is left unset (the rollout kernel does not read it)."""
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
        bottom_pts=t(f32(np.asarray(pts)[:1])),
        bottom_w=t(f32(corner_w)),
        finger_mass=t(f32(fmass)),
    )



def scene_arrays_3d(scenes, calib: Optional[Calib] = None,
                    device="cuda") -> Tuple[torch.Tensor, ...]:
    """Stacked Scene3D (leading dim B) -> the dense float32 inputs of
    ``profile_batch`` on ``device``: coefs (B, 2, 24, 4, 3), points
    (B, P, 4), scalars (B, 1, 32) (slot layout:
    dgdm_tpu/sim/pallas3d.py:scene_arrays_3d). The per-jaw surface fits are
    made anew."""
    yls = scenes.yl.numpy()                          # (B, 7, 3)
    yrs = scenes.yr.numpy()
    b = yls.shape[0]
    both = np.concatenate([yls, yrs], 0)             # (2B, 7, 3)
    # first half = left jaws (inner face +y), second half = right (-y)
    sides = ["upper"] * b + ["lower"] * b
    fitted = fit_surface_batch(both, sides=sides)   # (2B, TOT_SEG, 4, 3)
    coefs = np.stack([fitted[:b], fitted[b:]], axis=1).astype(np.float32)
    pts = scenes.points.numpy()
    points = np.concatenate(
        [pts, np.zeros((b, pts.shape[1], 1), np.float32)], axis=-1)

    if calib is None:
        calib = default_calib3()
    scal = np.zeros((b, 1, N_SCALARS), np.float32)
    fmass = scenes.finger_mass.numpy()
    inv_i = scenes.inv_inertia.numpy()               # (B, 3, 3)
    ib = scenes.inertia.numpy()
    scal[:, 0, 0] = scenes.mass.numpy()
    scal[:, 0, 1] = fmass[..., 0]
    scal[:, 0, 2:5] = scenes.com.numpy()
    scal[:, 0, 5] = inv_i[:, 0, 0]
    scal[:, 0, 6] = inv_i[:, 1, 1]
    scal[:, 0, 7] = inv_i[:, 2, 2]
    scal[:, 0, 8] = inv_i[:, 0, 1]
    scal[:, 0, 9] = inv_i[:, 0, 2]
    scal[:, 0, 10] = inv_i[:, 1, 2]
    scal[:, 0, 11] = fmass[..., 1]
    scal[:, 0, 12] = float(calib.mu_plane)
    scal[:, 0, 13] = float(calib.mu_finger)
    scal[:, 0, 14] = float(calib.k_contact)
    scal[:, 0, 15] = float(calib.b_contact)
    scal[:, 0, 16] = float(calib.unload)
    scal[:, 0, 17] = float(calib.rough)
    scal[:, 0, 18] = ib[:, 0, 0]
    scal[:, 0, 19] = ib[:, 1, 1]
    scal[:, 0, 20] = ib[:, 2, 2]
    scal[:, 0, 21] = ib[:, 0, 1]
    scal[:, 0, 22] = ib[:, 0, 2]
    scal[:, 0, 23] = ib[:, 1, 2]
    scal[:, 0, 24] = float(calib.c_r)
    scal[:, 0, 27] = float(calib.restitution)
    # broad-phase surface extrema for the kernel's no-contact fast path
    # (dense-grid evaluation of the fitted per-cell polynomials, padded by
    # 1e-3 to stay conservative)
    g = GRIPPER_3D
    h3 = (g.ctrl_x_max - g.ctrl_x_min) / N_SEG
    t3 = np.linspace(0.0, h3, 24)
    s3 = np.linspace(0.0, (g.ctrl_z_max - g.ctrl_z_min) / NZ_SEG, 16)
    basis = np.stack(
        [t3[:, None] ** a * s3[None, :] ** b_
         for a in range(DEG_X + 1) for b_ in range(DEG_Z + 1)], -1
    )  # (T, S, C)
    cflat = coefs.reshape(b, 2, TOT_SEG, -1)         # (B, 2, TOT_SEG, C)
    vals3 = np.einsum("bfnc,tsc->bfnts", cflat, basis)
    scal[:, 0, 25] = vals3[:, 0].max(axis=(1, 2, 3)) + 1e-3   # left max
    scal[:, 0, 26] = vals3[:, 1].min(axis=(1, 2, 3)) - 1e-3   # right min
    return tuple(torch.as_tensor(a).to(device)
                 for a in (coefs, points, scal))

