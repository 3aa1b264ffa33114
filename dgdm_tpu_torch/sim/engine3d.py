"""3D contact engine — port of ``dgdm_tpu/sim/engine3d.py``: the contact
constants, the fitted calibration tables and the solver switch,
``finger_masses_3d``, ``object_properties_3d``, ``corner_weights_3d``,
``make_scene`` with its per-gripper host-work LRU, the finger height-grid
bake (``bake_height_grids``), and the pure, differentiable engine
(``init_state``, ``step`` and its three solvers ``step_jacobi3``,
``step_newton3`` and ``step_newton3_pyramid``, ``rollout``,
``rollout_trace3d``, ``profile``, ``profile_batch``).

The object is a 6-DOF rigid body (quaternion attitude) described by surface
sample points; each jaw is a 1-DOF slide joint along y carrying a B-spline
surface finger whose inner face is the heightfield y = f(x, z), contacted
through the convex-hull envelope of its slab decomposition
(``geom/envelope3d.py``). Two engines compute its squeeze:

- the rollout kernel (``sim/rollout3d.py``, ``csrc/rollout3d.cu``) and its
  plain PyTorch version (``sim/rollout3d_ref.py``): datagen and
  verification, on per-cell polynomial fits of the finger surfaces;
- the pure engine below: autograd tensor code written batched over leading
  dimensions (a state's fields carry any leading shape, e.g. pairs x poses;
  a scene's fields a shape that broadcasts against it, ``expand_scene3``),
  on the fingers' baked height grid (``Scene3D.hgrid``, bilinear lookups).
  It is the JAX package's route off the TPU (``eval_rollout_batch_3d``,
  ``profile_pairs_3d(use_pallas=False)``, ``rollout_trace3d``). The two are
  different functions: the baked grid against the fitted polynomials,
  separate finger contact sets against the kernel's merged ones, and gates
  per pose against the kernel's per 128-pose group.

``make_scene`` leaves ``hgrid`` unset, so the kernel's paths never pay for
the bake (~0.2 s a gripper); the pure engine's entry points fill it from an
LRU on first use (``with_hgrid``), with the values of the JAX package's bake.

``SOLVER3`` selects the contact solver, read at call time by
``default_calib3``, ``step`` and the rollout kernel's wrapper: the coupled
semi-smooth Newton solve ("newton", the default), projected Jacobi with an
explicit elastic wedge term ("jacobi"), or pyramidal-cone finger rows
("pyramid", the pure engine only; the kernel runs its Newton branch with the
pyramid table for it, as the Pallas kernel does). Each has its fitted table.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from dgdm_tpu_torch.core.cache import LRU
from dgdm_tpu_torch.core.config import GRIPPER_3D, SIM
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.sim.engine2d import (
    B_CONTACT,
    DEPTH_EL_CAP,
    IMPEDANCE,
    K_CONTACT,
    ROUGH_SAT,
    Calib,
    _clip,
    _max,
    _min,
    _t,
)
from dgdm_tpu_torch.sim.types import Scene3D, State3D

K_PLANE3 = 2.5e4
B_PLANE3 = 300.0
# iterations of the Jacobi solver (engine and kernel)
SOLVER_ITERS = 8
# closing speed (m/s) above which finger-row restitution fires
V_REST_THRESH = 0.05
# height-grid resolution over (x, z): nodes on the 12 x-slab boundaries and
# the mid-z split of the envelope, so its dominant ridges interpolate exactly
HGRID_H, HGRID_W = 193, 65

# fitted contact parameters of the Jacobi solver (see engine2d for the
# physical meaning of each knob)
UNLOAD3 = 0.0
ROUGH3 = 0.0
K_MULT3 = 1.0

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

# Fitted for the pyramidal-cone solver (step_newton3_pyramid) by held-out
# engine-side random search; the per-edge compliance c_r is ~4x the Newton
# row's (four parallel edge rows share the load).
FITTED_3D_PYRAMID = {
    "mu_plane": 0.559093,
    "mu_finger": 1.117325,
    "k_contact": 2397.16,
    "b_contact": 302.934,
    "unload": 0.751029,
    "c_r": 0.729647,
}

# contact solver, read at call time (see the module docstring)
SOLVER3 = "newton"
SOLVERS3 = ("newton", "jacobi", "pyramid")
# full-solve Newton iterations a step of the pure engine (the rollout
# kernel's count is rollout3d.NEWTON_KERNEL_ITERS3); the no-finger-contact
# plane subproblem always gets 3
NEWTON_ITERS3 = 1
_LS_ALPHAS3 = (1.0, 0.5)


def resolve_solver3(solver: Optional[str] = None) -> str:
    """``solver`` or, when None, ``SOLVER3`` now; an unknown one raises."""
    if solver is None:
        solver = SOLVER3
    if solver not in SOLVERS3:
        raise ValueError(f"unknown contact solver {solver!r}; one of "
                         f"{SOLVERS3}")
    return solver


def default_calib3() -> Calib:
    """The fitted table of the current ``SOLVER3`` rounded to float32, as
    the JAX package stores it (dgdm_tpu/sim/engine3d.py:112-128)."""
    solver = resolve_solver3()
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    if solver == "pyramid":
        vals = dict(FITTED_3D_NEWTON, rough=0.0, **FITTED_3D_PYRAMID)
        return Calib(**{k: f32(v) for k, v in vals.items()})
    if solver == "newton":
        return Calib(**{k: f32(v) for k, v in FITTED_3D_NEWTON.items()})
    return Calib(
        mu_plane=f32(SIM.friction_slide),
        mu_finger=f32(SIM.friction_slide),
        mu_torsion=f32(SIM.friction_torsion),
        k_contact=f32(K_CONTACT * K_MULT3),
        b_contact=f32(B_CONTACT * K_MULT3),
        unload=f32(UNLOAD3),
        rough=f32(ROUGH3),
        c_r=f32(0.0526),    # read by the Newton solvers only
    )


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


def bake_height_grids(yl: np.ndarray, yr: np.ndarray) -> np.ndarray:
    """Both finger surfaces and their slopes on the dense (x, z) lattice ->
    (2, H, W, 3) float32: [height, dh/dx, dh/dz]. The contact surface is
    ``CONTACT_SURFACE_3D``'s: the hull envelope, or the bare B-spline sheet
    evaluated in float32 (``gripper3d_surface``)."""
    g = GRIPPER_3D
    xs = np.linspace(g.ctrl_x_min, g.ctrl_x_max, HGRID_H)
    zs = np.linspace(g.ctrl_z_min, g.ctrl_z_max, HGRID_W)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    out = np.zeros((2, HGRID_H, HGRID_W, 3), dtype=np.float32)
    use_env = CONTACT_SURFACE_3D == "envelope"
    for i, y in enumerate((yl, yr)):
        if use_env:
            from dgdm_tpu_torch.geom.envelope3d import finger_envelope

            h, sx, sz = finger_envelope(
                np.asarray(y), gx.reshape(-1), gz.reshape(-1),
                side="upper" if i == 0 else "lower")
        else:
            from dgdm_tpu_torch.geom.spline import gripper3d_surface

            surf = gripper3d_surface()
            yc = torch.as_tensor(np.asarray(y).reshape(g.nu, g.nv),
                                 dtype=torch.float32)
            fx = torch.as_tensor(gx.reshape(-1), dtype=torch.float32)
            fz = torch.as_tensor(gz.reshape(-1), dtype=torch.float32)
            h = surf.height(yc, fx, fz).numpy()
            sx, sz = (v.numpy() for v in surf.slopes(yc, fx, fz))
        out[i, ..., 0] = np.asarray(h).reshape(HGRID_H, HGRID_W)
        out[i, ..., 1] = np.asarray(sx).reshape(HGRID_H, HGRID_W)
        out[i, ..., 2] = np.asarray(sz).reshape(HGRID_H, HGRID_W)
    return out


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


# Per-gripper host work, done once per gripper and kept in bounded LRUs
# keyed on the control points and the contact-surface mode: the exact hull
# masses (~0.03 s a gripper, every scene) and, for the pure engine only, the
# height-grid bake (~0.2 s a gripper; 1,024 entries of (2, 193, 65, 3)
# float32 are ~300 MB).
_GRIP_CACHE = LRU(1024)
_HGRID_CACHE = LRU(1024)


def _gripper_host_work(yl: np.ndarray, yr: np.ndarray) -> np.ndarray:
    key = yl.tobytes() + yr.tobytes() + CONTACT_SURFACE_3D.encode()
    return _GRIP_CACHE.get(key, lambda: finger_masses_3d(yl, yr))


def height_grids(yl: np.ndarray, yr: np.ndarray) -> np.ndarray:
    """``bake_height_grids(yl, yr)`` through its LRU."""
    key = yl.tobytes() + yr.tobytes() + CONTACT_SURFACE_3D.encode()
    return _HGRID_CACHE.get(key, lambda: bake_height_grids(yl, yr))


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
    ``rollout3d.scene_arrays_3d`` moves a stacked batch to the device. The
    height grid is left unset (``with_hgrid`` fills it)."""
    g = GRIPPER_3D
    with TRACER.span("scene3d.fingers"):
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


def with_hgrid(scene: Scene3D) -> Scene3D:
    """The scene (one pair or a stack of pairs) with ``hgrid`` baked from
    its finger control points, one LRU lookup a pair, on the scene's device;
    a scene that has one is returned as it is. The bake reads the float32
    control points the scene holds."""
    if scene.hgrid is not None:
        return scene
    yl = scene.yl.detach().cpu().numpy().astype(np.float64)
    yr = scene.yr.detach().cpu().numpy().astype(np.float64)
    lead = yl.shape[:-2]
    yl, yr = yl.reshape((-1,) + yl.shape[-2:]), yr.reshape(
        (-1,) + yr.shape[-2:])
    grids = np.stack([height_grids(yl[i].reshape(-1), yr[i].reshape(-1))
                      for i in range(yl.shape[0])])
    hgrid = torch.from_numpy(grids.reshape(lead + grids.shape[1:])).to(
        scene.points.device)
    return dataclasses.replace(scene, hgrid=hgrid)


# ---------------------------------------------------------------------------
# The pure engine (engine3d.py:202-222, 346-1285 of the JAX package)
# ---------------------------------------------------------------------------

# trailing (per-pair) dimensions of each Scene3D field
_SCENE_NDIM = {"yl": 2, "yr": 2, "points": 2, "com": 1, "mass": 0,
               "inertia": 2, "inv_inertia": 2, "bottom_pts": 2,
               "bottom_w": 1, "finger_mass": 1, "hgrid": 4}


def expand_scene3(scene: Scene3D, k: int) -> Scene3D:
    """Insert k singleton dimensions after a scene's batch dimensions, so
    that stacked pairs (B,) broadcast against states of shape (B, N...)."""
    out = {}
    for f, nd in _SCENE_NDIM.items():
        v = getattr(scene, f)
        if v is None:
            out[f] = None
            continue
        lead = v.shape[:v.ndim - nd]
        out[f] = v.reshape(lead + (1,) * k + v.shape[v.ndim - nd:])
    return Scene3D(**out)


def _bilerp(grid: torch.Tensor, x: torch.Tensor,
            z: torch.Tensor) -> torch.Tensor:
    """grid (..., H, W, 3); x, z (..., P) clipped coordinates -> (..., P, 3):
    flat-index gathers of the four corners. The gradient flows through the
    weights (x, z) and the gathered values."""
    g = GRIPPER_3D
    fx = (x - g.ctrl_x_min) / (g.ctrl_x_max - g.ctrl_x_min) * (HGRID_H - 1)
    fz = (z - g.ctrl_z_min) / (g.ctrl_z_max - g.ctrl_z_min) * (HGRID_W - 1)
    fx = _clip(fx, 0.0, HGRID_H - 1.0)
    fz = _clip(fz, 0.0, HGRID_W - 1.0)
    i0 = torch.clamp(fx.to(torch.int32), 0, HGRID_H - 2)
    j0 = torch.clamp(fz.to(torch.int32), 0, HGRID_W - 2)
    wx = (fx - i0)[..., None]
    wz = (fz - j0)[..., None]
    flat = grid.reshape(grid.shape[:-3] + (HGRID_H * HGRID_W, 3))
    idx = (i0 * HGRID_W + j0).long()
    lead = torch.broadcast_shapes(flat.shape[:-2], idx.shape[:-1])
    flat = flat.expand(lead + flat.shape[-2:])
    idx = idx.expand(lead + idx.shape[-1:])

    def at(off):
        return torch.gather(flat, -2,
                            (idx + off)[..., None].expand(idx.shape + (3,)))

    g00, g01 = at(0), at(1)
    g10, g11 = at(HGRID_W), at(HGRID_W + 1)
    return ((1 - wx) * ((1 - wz) * g00 + wz * g01)
            + wx * ((1 - wz) * g10 + wz * g11))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (w, x, y, z) -> (..., 3, 3) rotations."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_integrate(q: torch.Tensor, om: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """q <- normalize(q + dt/2 * om_quat * q), om (..., 3) in world frame."""
    w, x, y, z = q.unbind(-1)
    ox, oy, oz = om.unbind(-1)
    dq = 0.5 * torch.stack([
        -ox * x - oy * y - oz * z,
        ox * w + oy * z - oz * y,
        -ox * z + oy * w + oz * x,
        ox * y - oy * x + oz * w,
    ], -1)
    q = q + dt * dq
    return q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-12)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrices (..., 3, 3) times vectors (..., 3), elementwise products and
    sums (no matrix unit touches them)."""
    return (m * v[..., None, :]).sum(-1)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3), elementwise."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _vec(vals, like: torch.Tensor) -> torch.Tensor:
    """A constant vector filled on ``like``'s device."""
    return torch.stack([_t(v, like) for v in vals])


def _z_angle(q: torch.Tensor) -> torch.Tensor:
    """Axis-angle magnitude for near-z rotations in [0, 2pi)."""
    return torch.remainder(2.0 * torch.atan2(q[..., 3], q[..., 0]),
                           2.0 * math.pi)


def init_state(scene: Scene3D, pose: torch.Tensor) -> State3D:
    """pose = (..., 3): body origin offset (x, y) and z-rotation theta (z
    position starts at 0)."""
    th = pose[..., 2]
    zero = torch.zeros_like(th)
    q = torch.stack([torch.cos(th / 2), zero, zero, torch.sin(th / 2)], -1)
    origin = torch.stack([pose[..., 0], pose[..., 1], zero], -1)
    pos = origin + _mv(quat_to_mat(q), scene.com)
    lead = pos.shape[:-1]
    z3 = torch.zeros_like(pos)
    z2 = pos.new_zeros(lead + (2,))
    return State3D(pos=pos, quat=q.expand(lead + (4,)), vel=z3, om=z3, q=z2,
                   qd=z2)


def _regrasp(new: State3D, regrasp) -> State3D:
    """Gripper reset (jaws to 0) that also zeroes all velocities."""
    if regrasp is None or regrasp is False:
        return new
    if regrasp is True:
        return State3D(pos=new.pos, quat=new.quat,
                       vel=torch.zeros_like(new.vel),
                       om=torch.zeros_like(new.om),
                       q=torch.zeros_like(new.q),
                       qd=torch.zeros_like(new.qd))
    rg = regrasp[..., None]
    return State3D(pos=new.pos, quat=new.quat,
                   vel=torch.where(rg, torch.zeros_like(new.vel), new.vel),
                   om=torch.where(rg, torch.zeros_like(new.om), new.om),
                   q=torch.where(rg, torch.zeros_like(new.q), new.q),
                   qd=torch.where(rg, torch.zeros_like(new.qd), new.qd))


def _integrate(state: State3D, vel, om, qd, dt, regrasp) -> State3D:
    return _regrasp(State3D(pos=state.pos + dt * vel,
                            quat=quat_integrate(state.quat, om, dt),
                            vel=vel, om=om, q=state.q + dt * qd, qd=qd),
                    regrasp)


def _ctrl_force(state: State3D, ctrl) -> torch.Tensor:
    """Servo force of both jaws (..., 2), ctrl clamped to the actuator
    range like MuJoCo."""
    g = GRIPPER_3D
    ctrl = torch.as_tensor(ctrl, dtype=torch.float32, device=state.q.device)
    ctrl_c = torch.stack([_clip(ctrl[0], 0.0, g.ctrl_clamped),
                          _clip(ctrl[1], -g.ctrl_clamped, 0.0)])
    return g.kp * (ctrl_c - state.q) - g.joint_damping * state.qd


@dataclasses.dataclass
class _Contacts:
    """Contact geometry of one step: world lever arms r (..., P, 3), world
    points pw, per-row depth (..., 3, P) and activity, normals (..., 3, P,
    3) for the rows (left finger, right finger, plane), the rotation and
    the finger rows' normals n_l, n_r (..., P, 3)."""

    rot: torch.Tensor
    r: torch.Tensor
    pw: torch.Tensor
    depth: torch.Tensor
    n: torch.Tensor
    act: torch.Tensor
    n_l: torch.Tensor
    n_r: torch.Tensor


def _contacts(scene: Scene3D, state: State3D) -> _Contacts:
    g = GRIPPER_3D
    rot = quat_to_mat(state.quat)
    rel = scene.points - scene.com[..., None, :]
    r = (rel[..., :, None, :] * rot[..., None, :, :]).sum(-1)   # (..., P, 3)
    pw = state.pos[..., None, :] + r
    x, y, z = pw.unbind(-1)
    in_dom = ((x >= g.ctrl_x_min) & (x <= g.ctrl_x_max)
              & (z >= g.ctrl_z_min) & (z <= g.ctrl_z_max))
    xc = _clip(x, g.ctrl_x_min, g.ctrl_x_max)
    zc = _clip(z, g.ctrl_z_min, g.ctrl_z_max)
    hl = _bilerp(scene.hgrid[..., 0, :, :, :], xc, zc)
    hr = _bilerp(scene.hgrid[..., 1, :, :, :], xc, zc)
    f_l, sx_l, sz_l = hl.unbind(-1)
    f_r, sx_r, sz_r = hr.unbind(-1)
    surf_l = -g.jaw_offset + state.q[..., 0:1] + f_l + g.width
    surf_r = g.jaw_offset + state.q[..., 1:2] + f_r
    inv_nl = torch.rsqrt(1.0 + sx_l ** 2 + sz_l ** 2)
    inv_nr = torch.rsqrt(1.0 + sx_r ** 2 + sz_r ** 2)
    one = torch.ones_like(sx_l)
    n_l = torch.stack([-sx_l, one, -sz_l], -1) * inv_nl[..., None]
    n_r = torch.stack([sx_r, -one, sz_r], -1) * inv_nr[..., None]
    depth_l = (surf_l - y) * inv_nl
    depth_r = (y - surf_r) * inv_nr
    act_l = ((depth_l > 0.0) & in_dom).to(torch.float32)
    act_r = ((depth_r > 0.0) & in_dom).to(torch.float32)
    depth_p = SIM.plane_z - z
    act_p = (depth_p > 0.0).to(torch.float32)
    ez = _vec((0.0, 0.0, 1.0), z).expand(n_l.shape)
    return _Contacts(rot=rot, r=r, pw=pw,
                     depth=torch.stack([depth_l, depth_r, depth_p], -2),
                     n=torch.stack([n_l, n_r, ez], -3),
                     act=torch.stack([act_l, act_r, act_p], -2),
                     n_l=n_l, n_r=n_r)


def _finger_vel(qd: torch.Tensor, e_y: torch.Tensor) -> torch.Tensor:
    """The rows' surface velocities (..., 3, 3): qd_l e_y, qd_r e_y, 0."""
    return torch.stack([qd[..., 0:1] * e_y, qd[..., 1:2] * e_y,
                        torch.zeros_like(qd[..., 0:1] * e_y)], -2)


def _fing_inv(c: _Contacts, inv_fm: torch.Tensor) -> torch.Tensor:
    return torch.stack([c.n_l[..., 1] ** 2 * inv_fm[..., 0:1],
                        c.n_r[..., 1] ** 2 * inv_fm[..., 1:2],
                        torch.zeros_like(c.depth[..., 2, :])], -2)


def _psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (row, point) dims of (..., 3, P, 3) -> (..., 3)."""
    return x.sum(dim=(-3, -2))


def step(scene: Scene3D, state: State3D, ctrl, dt: float = SIM.dt,
         regrasp=None, solver_iters: int = SOLVER_ITERS,
         calib: Optional[Calib] = None) -> State3D:
    """One semi-implicit Euler step, dispatching on ``SOLVER3`` (read at
    call time; an unknown solver raises)."""
    solver = resolve_solver3()
    if solver == "newton":
        return step_newton3(scene, state, ctrl, dt, regrasp=regrasp,
                            calib=calib)
    if solver == "pyramid":
        return step_newton3_pyramid(scene, state, ctrl, dt, regrasp=regrasp,
                                    calib=calib)
    return step_jacobi3(scene, state, ctrl, dt, regrasp=regrasp,
                        solver_iters=solver_iters, calib=calib)


def step_jacobi3(scene: Scene3D, state: State3D, ctrl, dt: float = SIM.dt,
                 regrasp=None, solver_iters: int = SOLVER_ITERS,
                 calib: Optional[Calib] = None) -> State3D:
    """One step with mass-split projected Jacobi over the three contact
    rows of every point (left finger, right finger, plane): the explicit
    elastic wedge impulse on the finger rows under its global energy clamp,
    plane unloading by the grip, then ``solver_iters`` sweeps with vector
    friction cones."""
    if calib is None:
        calib = default_calib3()
    ref = state.pos
    k_con, b_con = _t(calib.k_contact, ref), _t(calib.b_contact, ref)
    mu_f, mu_p = _t(calib.mu_finger, ref), _t(calib.mu_plane, ref)
    unload, rough = _t(calib.unload, ref), _t(calib.rough, ref)
    m, fm = scene.mass, scene.finger_mass
    inv_m, inv_fm = 1.0 / m, 1.0 / fm
    c = _contacts(scene, state)
    inv_i = _mm(_mm(c.rot, scene.inv_inertia), c.rot.transpose(-1, -2))
    r, n, depth, act = c.r, c.n, c.depth, c.act
    rb = r[..., None, :, :]                                   # (..., 1, P, 3)
    inv_i2 = inv_i[..., None, None, :, :]
    inv_m2 = inv_m[..., None, None]
    inv_m1 = inv_m[..., None]

    cnt = _max(act.sum(-1, keepdim=True), 1.0)
    w_c = act / cnt
    rxn = _cross(rb, n)                                       # (..., 3, P, 3)
    ang = (rxn * _mv(inv_i2, rxn)).sum(-1)
    m_eff_n = 1.0 / (inv_m2 + ang + _fing_inv(c, inv_fm))
    k_c = _vec((K_CONTACT, K_CONTACT, K_PLANE3), ref)[:, None]
    b_c = _vec((B_CONTACT, B_CONTACT, B_PLANE3), ref)[:, None]
    e_y = _vec((0.0, 1.0, 0.0), ref)

    vp0 = state.vel[..., None, :] + _cross(state.om[..., None, :], r)
    vrel0 = vp0[..., None, :, :] - _finger_vel(state.qd, e_y)[..., None, :]
    vn0 = (vrel0 * n).sum(-1)
    d_imp = IMPEDANCE
    target_n = (1.0 - d_imp * b_c * dt) * vn0 + d_imp * dt * k_c * depth

    # explicit elastic wedge on the finger rows, clamped so that the summed
    # wrench cannot overshoot any contact's pushout cap
    el_row = _vec((1.0, 1.0, 0.0), ref)[:, None]
    depth_el = el_row * act * _clip(depth, 0.0, DEPTH_EL_CAP)
    v_cap = d_imp * dt * k_con * depth_el
    dv_el = _clip(d_imp * dt * (k_con * depth_el - b_con * vn0), 0.0,
                  _max(v_cap - vn0, 0.0)) * el_row * act
    imp_mag = m_eff_n * dv_el
    imp_el = imp_mag[..., None] * n
    dvel_u = _psum(imp_el) * inv_m1
    dom_u = _mv(inv_i, _psum(_cross(rb, imp_el)))
    dqd_u = -torch.stack([imp_el[..., 0, :, 1].sum(-1),
                          imp_el[..., 1, :, 1].sum(-1)], -1) * inv_fm
    dv_pts = dvel_u[..., None, :] + _cross(dom_u[..., None, :], r)
    dqd_rows = _finger_vel(dqd_u, e_y)
    dvn_ind = ((dv_pts[..., None, :, :] - dqd_rows[..., None, :]) * n).sum(-1)
    headroom = _max(v_cap - vn0, 0.0)
    take = (dv_el > 0) & (dvn_ind > 1e-9)
    # double where keeps the unselected branch's gradient finite
    denom = torch.where(take, dvn_ind, torch.ones_like(dvn_ind))
    ratio = torch.where(take, headroom / denom,
                        torch.full_like(dvn_ind, float("inf")))
    s_el = _clip(ratio.amin(dim=(-2, -1)), 0.0, 1.0)
    imp_mag = s_el[..., None, None] * imp_mag
    imp_el = s_el[..., None, None, None] * imp_el

    # mean-field plane unloading of the plane-row friction cap
    grip_ratio = imp_mag.sum(dim=(-2, -1)) / (dt * m * SIM.gravity)
    plane_fric_scale = 1.0 / (1.0 + unload * grip_ratio)

    # unconstrained update
    f_fing = _ctrl_force(state, ctrl)
    gvec = _vec((0.0, 0.0, -SIM.gravity), ref)
    vel = state.vel + dt * gvec + _psum(imp_el) * inv_m1
    om = state.om + _mv(inv_i, _psum(_cross(rb, imp_el)))
    qd = state.qd + dt * f_fing * inv_fm - torch.stack(
        [imp_el[..., 0, :, 1].sum(-1), imp_el[..., 1, :, 1].sum(-1)],
        -1) * inv_fm

    lam_n = torch.zeros_like(depth)
    lam_t = torch.zeros_like(n)
    mu_row = torch.stack([mu_f.expand_as(plane_fric_scale),
                          mu_f.expand_as(plane_fric_scale),
                          mu_p * plane_fric_scale], -1)[..., None]
    cap_r = rough * el_row * m_eff_n * _min(depth_el, ROUGH_SAT)
    for _ in range(solver_iters):
        vp = vel[..., None, :] + _cross(om[..., None, :], r)
        vrel = vp[..., None, :, :] - _finger_vel(qd, e_y)[..., None, :]
        vn = (vrel * n).sum(-1)
        new_n = _max(lam_n + w_c * m_eff_n * (target_n - vn), 0.0)
        d_n = new_n - lam_n
        # friction: tangential component, vector cone clamp; caps include
        # the elastic wedge load, crack capture on the finger rows and the
        # unloading on the plane row
        vt = vrel - vn[..., None] * n
        cand = lam_t + (-w_c[..., None] * m_eff_n[..., None] * vt)
        cap = mu_row * (new_n + imp_mag) + cap_r
        nrm = torch.sqrt((cand * cand).sum(-1) + 1e-20)
        cand = cand * _min(cap / nrm, 1.0)[..., None]
        d_t = cand - lam_t
        imp = d_n[..., None] * n + d_t
        vel = vel + _psum(imp) * inv_m1
        om = om + _mv(inv_i, _psum(_cross(rb, imp)))
        qd = qd - torch.stack([imp[..., 0, :, 1].sum(-1),
                               imp[..., 1, :, 1].sum(-1)], -1) * inv_fm
        lam_n, lam_t = new_n, cand
    return _integrate(state, vel, om, qd, dt, regrasp)


def _arm(r: torch.Tensor) -> torch.Tensor:
    """The velocity map of a point (..., P, 3, 6): (v, omega) -> v +
    omega x r, the part of every row's map G = [I3 | -skew(r) | finger]
    that does not depend on the row."""
    rx, ry, rz = r.unbind(-1)
    zz = torch.zeros_like(rx)
    nskew = torch.stack([
        torch.stack([zz, rz, -ry], -1),
        torch.stack([-rz, zz, rx], -1),
        torch.stack([ry, -rx, zz], -1),
    ], -2)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(nskew.shape)
    return torch.cat([eye, nskew], -1)


def _vrel(u: torch.Tensor, r: torch.Tensor, e_y: torch.Tensor):
    """G u of the three rows for u (..., 8) (any extra leading dims) ->
    (..., 3, P, 3): v + omega x r - qd_row e_y (the plane row's surface is
    still)."""
    vp = u[..., None, :3] + _cross(u[..., None, 3:6], r)
    return vp[..., None, :, :] - _finger_vel(u[..., 6:], e_y)[..., None, :]


def _row_jac(n: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """n^T G of the three rows (..., 3, P, 8): (n, r x n, the row's jaw
    column -n_y; none on the plane row)."""
    rxn = _cross(r[..., None, :, :], n)
    ny = n[..., 1]
    zero = torch.zeros_like(ny[..., 0:1, :])
    jaw_l = torch.cat([-ny[..., 0:1, :], zero, zero], -2)
    jaw_r = torch.cat([zero, -ny[..., 1:2, :], zero], -2)
    return torch.cat([n, rxn, jaw_l[..., None], jaw_r[..., None]], -1)


def _gt_sum(f: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """sum over rows and points of G^T f for row forces f (..., 3, P, 3) ->
    (..., 8): (sum f, sum r x f, -sum f_y of each finger row)."""
    return torch.cat([f.sum(dim=(-3, -2)),
                      _cross(r[..., None, :, :], f).sum(dim=(-3, -2)),
                      -f[..., :2, :, 1].sum(-1)], -1)


def _gram(w: torch.Tensor, a: torch.Tensor, rows: int) -> torch.Tensor:
    """sum over the ``rows`` dims before the last of w * a_k a_l: a
    (..., R..., K), w broadcasting against a's (..., R...) -> (..., K, K)."""
    lead = a.shape[:a.ndim - rows - 1]
    af = a.reshape(lead + (-1, a.shape[-1]))
    wf = w.expand(a.shape[:-1]).reshape(lead + (-1, 1))
    return (af * wf).transpose(-1, -2) @ af


def _gram_g(fac: torch.Tensor, arm: torch.Tensor) -> torch.Tensor:
    """sum over rows and points of fac G^T G for row weights fac (..., 3, P)
    -> (..., 8, 8): the rows share the (v, omega) block; a finger row adds
    its jaw column (-e_y)."""
    s = fac.sum(-2)                                           # (..., P)
    h6 = _gram(s[..., None], arm, 2)                          # (..., 6, 6)
    ay = arm[..., 1, :]                                       # (..., P, 6)
    col_l = -(fac[..., 0, :, None] * ay).sum(-2)              # (..., 6)
    col_r = -(fac[..., 1, :, None] * ay).sum(-2)
    d_l, d_r = fac[..., 0, :].sum(-1), fac[..., 1, :].sum(-1)
    zero = torch.zeros_like(d_l)
    top = torch.cat([h6, col_l[..., None], col_r[..., None]], -1)
    bottom = torch.stack([torch.cat([col_l, torch.stack([d_l, zero], -1)],
                                    -1),
                          torch.cat([col_r, torch.stack([zero, d_r], -1)],
                                    -1)], -2)
    return torch.cat([top, bottom], -2)


def _huber(vt_norm, w_t, cap_t):
    q_br = 0.5 * w_t * vt_norm ** 2
    lin = cap_t * vt_norm - 0.5 * cap_t ** 2 / _max(w_t, 1e-12)
    return torch.where(w_t * vt_norm <= cap_t, q_br, lin)


def _mass_matrix(m, i_w, fm) -> torch.Tensor:
    """blockdiag(m I3, I_world, diag(fm)) (..., 8, 8)."""
    lead = i_w.shape[:-2]
    hm = i_w.new_zeros(lead + (8, 8))
    eye = torch.eye(3, dtype=torch.float32, device=i_w.device)
    hm[..., :3, :3] = m[..., None, None] * eye
    hm[..., 3:6, 3:6] = i_w
    hm[..., 6, 6] = fm[..., 0].expand(lead)
    hm[..., 7, 7] = fm[..., 1].expand(lead)
    return hm



def _newton_loop(newton_iter, u_unc, any_f):
    """The scan of ``max(NEWTON_ITERS3, 3)`` iterations: a pose with finger
    contact keeps ``NEWTON_ITERS3`` of them, one without keeps 3 (gated per
    pose)."""
    u = u_unc
    for i in range(max(NEWTON_ITERS3, 3)):
        u2 = newton_iter(u)
        nit_ok = torch.where(any_f, i < NEWTON_ITERS3, i < 3)
        u = torch.where(nit_ok[..., None], u2, u)
    return u


def step_newton3(scene: Scene3D, state: State3D, ctrl, dt: float = SIM.dt,
                 regrasp=None, calib: Optional[Calib] = None,
                 return_diag: bool = False):
    """Coupled semi-smooth Newton step on the 8-DOF system u = (v, omega,
    qd): MuJoCo's convex soft-constraint energy minimised by damped Newton
    (8x8 solves + a line search over the full and half step and u, ties to
    the first): normals as one-sided quadratics with compliance r_i = c_r *
    A_ii, friction as vector Huber potentials in the contact tangent plane
    (caps lagged one iteration), plane-row caps scaled by the mean-field
    unload gain; ``NEWTON_ITERS3`` iterations, 3 for a pose without finger
    contact. The clamp-snap probe knobs of ``Calib`` enter as in the JAX
    engine (exact no-ops at their defaults). With ``return_diag`` also a
    dict of the converged contact impulses and solver internals (JAX's
    keys). Differentiable; the contractions over the contact rows go
    through matrix products, so parity runs keep TF32 off."""
    if calib is None:
        calib = default_calib3()
    ref = state.pos
    kn = {k: _t(getattr(calib, k), ref) for k in (
        "k_contact", "b_contact", "mu_finger", "mu_plane", "unload", "rough",
        "c_r", "restitution", "w_fmult", "plane_corner", "clamp_k",
        "clamp_w", "ram", "clamp_press", "mu_ballistic", "om_release",
        "v_gate", "lam_sat")}
    m, fm = scene.mass, scene.finger_mass
    inv_m, inv_fm = 1.0 / m, 1.0 / fm
    c = _contacts(scene, state)
    rot_t = c.rot.transpose(-1, -2)
    inv_i = _mm(_mm(c.rot, scene.inv_inertia), rot_t)
    i_w = _mm(_mm(c.rot, scene.inertia), rot_t)
    r, n, depth, act = c.r, c.n, c.depth, c.act
    rb = r[..., None, :, :]

    e_y = _vec((0.0, 1.0, 0.0), ref)
    arm = _arm(r)                                             # (..., P, 3, 6)
    Jn = _row_jac(n, r)                                       # (..., 3, P, 8)
    rxn = _cross(rb, n)
    ang = (rxn * _mv(inv_i[..., None, None, :, :], rxn)).sum(-1)
    a_nn = inv_m[..., None, None] + ang + _fing_inv(c, inv_fm)
    w_n = act / (kn["c_r"] * a_nn)
    el_row = _vec((1.0, 1.0, 0.0), ref)[:, None]              # finger rows
    w_n = w_n * (1.0 + (kn["w_fmult"] - 1.0) * el_row)

    # corner-support plane contact (exact no-op at plane_corner = 0)
    act_p_row = act[..., 2, :]
    cw = scene.bottom_w * act_p_row
    corner_full = cw * (act_p_row.sum(-1, keepdim=True)
                        / _max(cw.sum(-1, keepdim=True), 1e-6))
    pc = kn["plane_corner"]
    plane_scale = (1.0 - pc) + pc * corner_full
    w_n = w_n * torch.stack([torch.ones_like(plane_scale),
                             torch.ones_like(plane_scale), plane_scale], -2)

    # clamp-regime coupled bracing (exact no-op at clamp_k = 0, clamp_w = 1)
    u0 = torch.cat([state.vel, state.om, state.qd], -1)
    vn0 = (_vrel(u0, r, e_y) * n).sum(-1)
    wp_b = w_n[..., 2, :] * act[..., 2, :]                    # (..., P)
    # the plane row's normal and tangential (x, y) rows, no jaw columns
    jp = torch.stack([arm[..., 2, :], arm[..., 0, :], arm[..., 1, :]], -3)
    jp = torch.cat([jp, torch.zeros_like(jp[..., :2])], -1)
    hm = _mass_matrix(m, i_w, fm)
    mb = hm + _gram(wp_b[..., None, :], jp, 2)
    jf = Jn[..., :2, :, :].reshape(Jn.shape[:-3] + (-1, 8))  # (..., 2P, 8)
    x_b = torch.linalg.solve(mb, jf.transpose(-1, -2))       # (..., 8, 2P)
    a_b = _max((jf * x_b.transpose(-1, -2)).sum(-1), 1e-9).reshape(
        jf.shape[:-2] + (2, -1))
    exc_f = _max(-vn0[..., :2, :] - V_REST_THRESH, 0.0)
    g_f = exc_f / (V_REST_THRESH + exc_f)
    boost = (1.0 + kn["clamp_k"] * g_f * (a_nn[..., :2, :] / a_b - 1.0)) \
        * (1.0 + g_f * (kn["clamp_w"] - 1.0))
    w_n = w_n * torch.cat([boost, torch.ones_like(w_n[..., 2:, :])], -2)
    w_t = w_n                                                 # PGS shortcut

    k_c = torch.stack([kn["k_contact"], kn["k_contact"],
                       _t(K_PLANE3, ref)])[:, None]
    b_c = torch.stack([kn["b_contact"], kn["b_contact"],
                       _t(B_PLANE3, ref)])[:, None]
    d_imp = IMPEDANCE
    target = (1.0 - d_imp * b_c * dt) * vn0 + d_imp * dt * k_c * depth
    # finger-row restitution, ram absorption and the clamp-press target
    # override (exact no-ops at restitution = ram = clamp_press = 0)
    target = target + kn["restitution"] * el_row * _max(
        -vn0 - V_REST_THRESH, 0.0)
    exc = _max(-vn0 - V_REST_THRESH, 0.0)
    w_ram = kn["ram"] * el_row * exc / (V_REST_THRESH + exc)
    target = (1.0 - w_ram) * target
    b_mj, k_mj = 100.0, 2500.0
    tgt_mj = (1.0 - d_imp * b_mj * dt) * vn0 + d_imp * dt * k_mj * depth
    g_cp = kn["clamp_press"] * el_row * (exc / (V_REST_THRESH + exc))
    target = (1.0 - g_cp) * target + g_cp * tgt_mj

    depth_el = el_row * act * _clip(depth, 0.0, DEPTH_EL_CAP)
    m_eff = 1.0 / a_nn
    cap_rough = kn["rough"] * m_eff * depth_el

    # ballistic-snap friction gates (exact no-ops at their defaults)
    om_sp = torch.sqrt((state.om * state.om).sum(-1) + 1e-12)
    rel_b = kn["mu_ballistic"] + (1.0 - kn["mu_ballistic"]) / (
        1.0 + (om_sp * kn["om_release"]) ** 2)
    gate_c = (kn["v_gate"] > 0.0) & ((-vn0 - kn["v_gate"]) > 0.0)
    rel_c = torch.where(gate_c, kn["mu_ballistic"], torch.ones_like(vn0))
    fric_scale = el_row * (rel_b[..., None, None] * rel_c) + (1.0 - el_row)

    f_fing = _ctrl_force(state, ctrl)
    u_unc = u0 + dt * torch.cat([
        _vec((0.0, 0.0, -SIM.gravity), ref).expand(u0.shape[:-1] + (3,)),
        torch.zeros_like(u0[..., :3]), f_fing * inv_fm], -1)
    mg_dt = _max(m * SIM.gravity * dt, 1e-9)
    mu_f, mu_p = kn["mu_finger"], kn["mu_plane"]
    lam_sat = kn["lam_sat"]

    def forces(u):
        vrel = _vrel(u, r, e_y)
        vn = (vrel * n).sum(-1)
        vt = vrel - vn[..., None] * n
        res = _max(target - vn, 0.0)
        lam_n = w_n * res
        grip = (el_row * lam_n).sum(dim=(-2, -1)) / mg_dt
        scale_p = 1.0 / (1.0 + kn["unload"] * grip)
        mu_row = torch.stack([mu_f.expand_as(scale_p),
                              mu_f.expand_as(scale_p),
                              mu_p * scale_p], -1)[..., None]
        lam_c = torch.where(lam_sat > 0.0,
                            lam_sat * torch.tanh(lam_n / _max(lam_sat, 1e-9)),
                            lam_n)
        lam_fric = el_row * lam_c + (1.0 - el_row) * lam_n
        cap_t = (mu_row * lam_fric + cap_rough) * fric_scale
        vt_norm = torch.sqrt((vt * vt).sum(-1) + 1e-16)
        fac = _min(w_t, cap_t / vt_norm)
        return vrel, vn, vt, res, lam_n, cap_t, vt_norm, fac

    def energy(u, cap_t):
        """Energies of candidates u (K, ..., 8) -> (K, ...)."""
        vrel = _vrel(u, r, e_y)
        vn = (vrel * n).sum(-1)
        vt = vrel - vn[..., None] * n
        res = _max(target - vn, 0.0)
        e_n = 0.5 * w_n * res * res
        vt_norm = torch.sqrt((vt * vt).sum(-1) + 1e-16)
        e_t = _huber(vt_norm, w_t, cap_t)
        du = u - u_unc
        e_u = 0.5 * (du * (hm @ du[..., None])[..., 0]).sum(-1)
        return e_u + e_n.sum(dim=(-2, -1)) + e_t.sum(dim=(-2, -1))

    def newton_iter(u):
        _, _, vt, res, lam_n, cap_t, _, fac = forces(u)
        f_t = fac[..., None] * vt
        grad = (hm @ (u - u_unc)[..., None])[..., 0]
        grad = grad - (lam_n[..., None] * Jn).sum(dim=(-3, -2))
        grad = grad + _gt_sum(f_t, r)
        on_n = w_n * (res > 0.0)
        hmat = hm + _gram(on_n, Jn, 2)
        hmat = hmat + _gram_g(fac, arm)
        hmat = hmat - _gram(fac, Jn, 2)
        delta = torch.linalg.solve(hmat, -grad[..., None])[..., 0]
        cands = torch.stack([u + a * delta for a in _LS_ALPHAS3] + [u])
        best = energy(cands, cap_t).argmin(dim=0)
        idx = best[None, ..., None].expand((1,) + u.shape)
        return torch.gather(cands, 0, idx)[0]

    # no-finger-contact fast phase (gated per pose; the kernel gates per
    # 128-pose group)
    any_f = act[..., :2, :].sum(dim=(-2, -1)) > 0.0
    u = _newton_loop(newton_iter, u_unc, any_f)
    vel, om, qd = u[..., :3], u[..., 3:6], u[..., 6:]
    new = _integrate(state, vel, om, qd, dt, regrasp)
    if not return_diag:
        return new
    vrel, vn, vt, res, lam_n, cap_t, vt_norm, fac = forces(u)
    f_t = -fac[..., None] * vt
    tq_n = (lam_n[..., None] * rxn).sum(-2)                   # (..., 3, 3)
    tq_t = _cross(rb, f_t).sum(-2)
    diag = {
        "lam_n": lam_n.sum(-1),
        "fric": (fac * vt_norm).sum(-1),
        "nact": act.sum(-1),
        "tqz_n": tq_n[..., 2],
        "tqz_t": tq_t[..., 2],
        "depth_max": (depth * act).amax(-1),
        "lam_pt": lam_n,
        "n_pt": n,
        "pw": c.pw,
        "a_nn": a_nn,
        "target": target,
        "vn0": vn0,
        "vn1": vn,
    }
    return new, diag


def step_newton3_pyramid(scene: Scene3D, state: State3D, ctrl,
                         dt: float = SIM.dt, regrasp=None,
                         calib: Optional[Calib] = None) -> State3D:
    """Pyramidal-cone finger contacts: each finger contact becomes the 4
    pyramid edge rows e_i = (n + mu s_i) / sqrt(1 + mu^2), s_i in {+t1, -t1,
    +t2, -t2}, each a one-sided quadratic with its own edge-projected
    admittance and the shared penetration target; the plane keeps
    ``step_newton3``'s model (one-sided normal + Huber tangent + unload).
    The pure engine only (the kernel has no pyramid branch)."""
    if calib is None:
        calib = default_calib3()
    ref = state.pos
    k_con, b_con = _t(calib.k_contact, ref), _t(calib.b_contact, ref)
    mu, mu_p = _t(calib.mu_finger, ref), _t(calib.mu_plane, ref)
    unload, c_r = _t(calib.unload, ref), _t(calib.c_r, ref)
    m, fm = scene.mass, scene.finger_mass
    inv_m, inv_fm = 1.0 / m, 1.0 / fm
    c = _contacts(scene, state)
    rot_t = c.rot.transpose(-1, -2)
    inv_i = _mm(_mm(c.rot, scene.inv_inertia), rot_t)
    i_w = _mm(_mm(c.rot, scene.inertia), rot_t)
    r = c.r
    arm = _arm(r)                                             # (..., P, 3, 6)
    n_f = torch.stack([c.n_l, c.n_r], -3)                     # (..., 2, P, 3)
    act_f, depth_f = c.act[..., :2, :], c.depth[..., :2, :]
    act_p, depth_p = c.act[..., 2, :], c.depth[..., 2, :]
    xhat = _vec((1.0, 0.0, 0.0), ref)
    t1 = _cross(n_f, xhat.expand(n_f.shape))
    t1 = t1 * torch.rsqrt((t1 * t1).sum(-1, keepdim=True) + 1e-12)
    t2 = _cross(n_f, t1)
    c_e = torch.rsqrt(1.0 + mu * mu)
    sdir = torch.stack([t1, -t1, t2, -t2], -2)                # (..., 2, P, 4, 3)
    e_dir = (n_f[..., None, :] + mu * sdir) * c_e
    rxe = _cross(r[..., None, :, None, :].expand(e_dir.shape), e_dir)
    # e^T G of the edge rows (..., 2, P, 4, 8): (e, r x e, own jaw -e_y)
    ey = e_dir[..., 1]
    zero = torch.zeros_like(ey[..., 0:1, :, :])
    J_e = torch.cat([e_dir, rxe,
                     torch.cat([-ey[..., 0:1, :, :], zero], -3)[..., None],
                     torch.cat([zero, -ey[..., 1:2, :, :]], -3)[..., None]],
                    -1)
    ang_e = (rxe * _mv(inv_i[..., None, None, None, :, :], rxe)).sum(-1)
    fing_e = e_dir[..., 1] ** 2 * inv_fm[..., :, None, None]
    a_e = inv_m[..., None, None, None] + ang_e + fing_e
    w_e = act_f[..., None] / (c_r * a_e)

    u0 = torch.cat([state.vel, state.om, state.qd], -1)
    d_imp = IMPEDANCE
    ve0 = (J_e * u0[..., None, None, None, :]).sum(-1)
    tgt_e = (1.0 - d_imp * b_con * dt) * ve0 \
        + d_imp * dt * k_con * depth_f[..., None]

    # plane row: step_newton3's model
    Jn_p = torch.cat([arm[..., 2, :], torch.zeros_like(arm[..., 2, :2])],
                     -1)                                      # (..., P, 8)
    rxn_p = _cross(r, _vec((0.0, 0.0, 1.0), ref).expand(r.shape))
    ang_p = (rxn_p * _mv(inv_i[..., None, :, :], rxn_p)).sum(-1)
    a_p = inv_m[..., None] + ang_p
    w_p = act_p / (c_r * a_p)
    vn0_p = (Jn_p * u0[..., None, :]).sum(-1)
    tgt_p = (1.0 - d_imp * B_PLANE3 * dt) * vn0_p \
        + d_imp * dt * K_PLANE3 * depth_p

    f_fing = _ctrl_force(state, ctrl)
    u_unc = u0 + dt * torch.cat([
        _vec((0.0, 0.0, -SIM.gravity), ref).expand(u0.shape[:-1] + (3,)),
        torch.zeros_like(u0[..., :3]), f_fing * inv_fm], -1)
    hm = _mass_matrix(m, i_w, fm)
    mg_dt = _max(m * SIM.gravity * dt, 1e-9)
    def plane_vel(u):
        vrel_p = u[..., None, :3] + _cross(u[..., None, 3:6], r)
        vt_p = torch.cat([vrel_p[..., :2],
                          torch.zeros_like(vrel_p[..., 2:])], -1)
        return vrel_p[..., 2], vt_p

    def forces(u):
        ve = (J_e * u[..., None, None, None, :]).sum(-1)
        res_e = _max(tgt_e - ve, 0.0)
        lam_e = w_e * res_e
        vn_p, vt_p = plane_vel(u)
        res_p = _max(tgt_p - vn_p, 0.0)
        lam_p = w_p * res_p
        grip = lam_e.sum(dim=(-3, -2, -1)) * c_e / mg_dt
        scale_p = 1.0 / (1.0 + unload * grip)
        cap_p = mu_p * scale_p[..., None] * lam_p
        vt_norm = torch.sqrt((vt_p * vt_p).sum(-1) + 1e-16)
        fac_p = _min(w_p, cap_p / vt_norm)
        return res_e, lam_e, res_p, lam_p, cap_p, vt_p, vt_norm, fac_p

    def energy(u, cap_p):
        ve = (J_e * u[..., None, None, None, :]).sum(-1)
        res_e = _max(tgt_e - ve, 0.0)
        vn_p, vt_p = plane_vel(u)
        res_p = _max(tgt_p - vn_p, 0.0)
        vt_norm = torch.sqrt((vt_p * vt_p).sum(-1) + 1e-16)
        e_t = _huber(vt_norm, w_p, cap_p)
        du = u - u_unc
        return (0.5 * (du * (hm @ du[..., None])[..., 0]).sum(-1)
                + 0.5 * (w_e * res_e * res_e).sum(dim=(-3, -2, -1))
                + 0.5 * (w_p * res_p * res_p).sum(-1) + e_t.sum(-1))

    def newton_iter(u):
        res_e, lam_e, res_p, lam_p, cap_p, vt_p, _, fac_p = forces(u)
        grad = (hm @ (u - u_unc)[..., None])[..., 0]
        grad = grad - (lam_e[..., None] * J_e).sum(dim=(-4, -3, -2))
        grad = grad - (lam_p[..., None] * Jn_p).sum(-2)
        f_p = fac_p[..., None] * vt_p
        grad = grad + torch.cat([f_p.sum(-2), _cross(r, f_p).sum(-2),
                                 torch.zeros_like(f_p[..., 0, :2])], -1)
        on_e = w_e * (res_e > 0.0)
        hmat = hm + _gram(on_e, J_e, 3)
        on_p = w_p * (res_p > 0.0)
        hmat = hmat + _gram(on_p, Jn_p, 1)
        h6 = _gram(fac_p[..., None], arm, 2)
        hmat = hmat + torch.nn.functional.pad(h6, (0, 2, 0, 2))
        hmat = hmat - _gram(fac_p, Jn_p, 1)
        delta = torch.linalg.solve(hmat, -grad[..., None])[..., 0]
        cands = torch.stack([u + a * delta for a in _LS_ALPHAS3] + [u])
        best = energy(cands, cap_p).argmin(dim=0)
        idx = best[None, ..., None].expand((1,) + u.shape)
        return torch.gather(cands, 0, idx)[0]

    any_f = act_f.sum(dim=(-2, -1)) > 0.0
    u = _newton_loop(newton_iter, u_unc, any_f)
    return _integrate(state, u[..., :3], u[..., 3:6], u[..., 6:], dt,
                      regrasp)


def _squeeze_ctrl(device) -> torch.Tensor:
    return torch.tensor([SIM.ctrl_3d, -SIM.ctrl_3d], dtype=torch.float32,
                        device=device)


def _regrasp_at(i: int, regrasp_every: int):
    return (i % regrasp_every == 0 and i > 0) if regrasp_every else None


def _readout(scene: Scene3D, state: State3D, pose: torch.Tensor):
    """(delta_theta wrapped to +-pi, delta_pos (..., 2), final theta in
    [0, 2pi), upright validity) of a rollout from ``pose``."""
    theta_f = _z_angle(state.quat)
    d_theta = theta_f - torch.remainder(pose[..., 2], 2 * math.pi)
    d_theta = d_theta - 2 * math.pi * torch.round(d_theta / (2 * math.pi))
    origin = state.pos - _mv(quat_to_mat(state.quat), scene.com)
    d_pos = origin[..., :2] - pose[..., :2]
    valid = ((torch.abs(state.quat[..., 1]) < SIM.tipover_atol)
             & (torch.abs(state.quat[..., 2]) < SIM.tipover_atol))
    return d_theta, d_pos, theta_f, valid


def rollout(scene: Scene3D, pose: torch.Tensor, steps: int = SIM.steps_3d,
            dt: float = SIM.dt, regrasp_every: int = 0,
            solver_iters: int = SOLVER_ITERS,
            calib: Optional[Calib] = None):
    """Squeeze rollouts from poses (..., 3) of a scene that broadcasts
    against them -> (delta_theta (...), delta_pos (..., 2), final_theta
    (...), valid (...)); valid is False on tip-over (quaternion x/y beyond
    the reference's 1e-2 tolerance). Fills the scene's height grid first."""
    scene = with_hgrid(scene)
    state = init_state(scene, pose)
    ctrl = _squeeze_ctrl(pose.device)
    for i in range(steps):
        state = step(scene, state, ctrl, dt,
                     regrasp=_regrasp_at(i, regrasp_every),
                     solver_iters=solver_iters, calib=calib)
    return _readout(scene, state, pose)


def rollout_trace3d(scene: Scene3D, pose: torch.Tensor,
                    steps: int = SIM.steps_3d, every: int = 20,
                    regrasp_every: int = 0, calib: Optional[Calib] = None):
    """Trajectory-capturing rollout for visualisation: per sampled step
    (pos (3,), quat (4,), q (2,)) -> (..., ceil(steps / every), 9), the rows
    of steps 0, every, 2 * every, ... (the state after each)."""
    scene = with_hgrid(scene)
    state = init_state(scene, pose)
    ctrl = _squeeze_ctrl(pose.device)
    rows = []
    for i in range(steps):
        state = step(scene, state, ctrl,
                     regrasp=_regrasp_at(i, regrasp_every), calib=calib)
        if i % every == 0:
            rows.append(torch.cat([state.pos, state.quat, state.q], -1))
    return torch.stack(rows, -2)


def profile(scene: Scene3D, poses: torch.Tensor, steps: int = SIM.steps_3d,
            regrasp_every: int = 0, solver_iters: int = SOLVER_ITERS,
            calib: Optional[Calib] = None):
    """Interaction profile of one scene: poses (N, 3) -> (delta_theta (N,),
    delta_pos (N, 2), final_theta (N,), valid (N,))."""
    return rollout(scene, poses, steps=steps, regrasp_every=regrasp_every,
                   solver_iters=solver_iters, calib=calib)


def profile_batch(scenes: Scene3D, poses: torch.Tensor,
                  steps: int = SIM.steps_3d, calib: Optional[Calib] = None):
    """Batch over pairs AND poses: scenes with leading dim B, poses (N, 3)
    shared -> outputs (B, N, ...)."""
    return rollout(expand_scene3(with_hgrid(scenes), 1), poses, steps=steps,
                   calib=calib)
