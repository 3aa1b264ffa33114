"""Planar contact engine — port of ``dgdm_tpu/sim/engine2d.py``: ``Calib``,
both fitted tables and the solver switch, the contact constants,
``make_scene`` with its finger host-work LRU, ``pose_grid``, and the pure,
differentiable engine (``init_state``, ``step``, ``step_jacobi``,
``step_newton``, ``rollout``, ``rollout_trace``, ``profile``,
``profile_batch``).

The 2D scene is strictly planar: an extruded icon polygon on a frictional
plane (3 in-plane DOF plus a vertical drop DOF) between two slide jaws
(kp = 10, damping 1, ctrl clamped to +-0.1) whose inner faces are cubic
splines. Two engines compute its squeeze:

- the rollout kernel (``sim/rollout2d.py``, ``csrc/rollout2d.cu``) and its
  plain PyTorch version (``sim/rollout2d_ref.py``): datagen and
  verification;
- the pure engine below: autograd tensor code written batched over leading
  dimensions (a state's fields carry any leading shape, e.g. pairs x poses;
  a scene's fields a shape that broadcasts against it), the engine that
  ``design/graddesign.py`` optimises through and ``use_pallas=False`` runs.
  It gates its no-contact Newton phase per pose; the kernel gates per
  128-pose group, so the two are different functions that agree at
  convergence.

``SOLVER`` selects the contact solver of both, read at call time: the
coupled semi-smooth Newton solve ("newton", the default) or mass-split
projected Jacobi with an explicit elastic wedge term ("jacobi"), each with
its own fitted calibration table (``default_calib``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from dgdm_tpu_torch.core.cache import LRU
from dgdm_tpu_torch.core.config import GRIPPER_2D, OBJECT_2D, SIM
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.geom import contour as contour_lib
from dgdm_tpu_torch.geom import jawmass
from dgdm_tpu_torch.geom import polygon as polygon_lib
from dgdm_tpu_torch.geom.spline import cubic_basis_matrix, cubic_coef_operator
from dgdm_tpu_torch.sim.types import Scene2D, State2D


@dataclasses.dataclass(frozen=True)
class Calib:
    """Effective-parameter knobs fitted against the MuJoCo oracle (see
    ``dgdm_tpu/sim/engine2d.py:Calib`` for the derivation of each): the
    eight that the 2D solvers read, ``restitution`` (read by the 3D Newton
    step and the 3D rollout kernel), and the ten clamp-snap probe knobs that
    only the pure 3D Newton step reads (``engine3d.step_newton3``). Every
    knob after ``c_r`` is an exact no-op at its default.

    A field is a float or a 0-d tensor: the pure engine takes tensors as
    they are, so gradients reach them (``dataclasses.replace`` swaps one
    in); the kernels' callers write ``float()`` of each field into their
    scalar slots."""

    mu_plane: float            # effective object-plane sliding friction
    mu_finger: float           # finger-object sliding friction
    mu_torsion: float          # torsional coefficient (meters)
    k_contact: float           # normal constraint stiffness (1/s^2)
    b_contact: float           # normal constraint damping (1/s)
    unload: float              # grip-induced plane-unloading gain
    rough: float               # crack-capture tangential stiction gain (1/s)
    c_r: float                 # constraint compliance scale (Newton solver)
    restitution: float = 0.0   # finger-row velocity restitution (3D Newton)
    # the 3D Newton step's clamp-snap probes (all measured and rejected in
    # the JAX package, kept wired as documented negative results)
    lam_sat: float = 0.0       # pressure-saturating finger friction cap
    om_release: float = 0.0    # body-spin friction release
    v_gate: float = 0.0        # closing-speed friction gate (m/s)
    mu_ballistic: float = 1.0  # floor scale of om_release / v_gate
    ram: float = 0.0           # ram-contact inelastic absorption
    w_fmult: float = 1.0       # finger-row enforcement multiplicity
    clamp_k: float = 0.0       # clamp-regime plane-braced admittance boost
    clamp_press: float = 0.0   # clamp-press target toward MuJoCo's solref
    plane_corner: float = 0.0  # footprint-corner plane support blend
    clamp_w: float = 1.0       # clamp-regime scalar weight boost


CALIB_FIELDS = tuple(f.name for f in dataclasses.fields(Calib))


# Fitted for the Jacobi solver against the MuJoCo oracle suite
# (runs/calib/calib2d.json); c_r is (1-d)/d over an ~8x patch multiplicity.
FITTED_2D = {
    "mu_plane": 0.9661,
    "mu_finger": 1.3150,
    "mu_torsion": 0.002484,
    "k_contact": 177739.0,
    "b_contact": 701.45,
    "unload": 0.1384,
    "rough": 354.94,
    "c_r": 0.0526 / 8.0,
}

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

# contact solver: "newton" (coupled semi-smooth Newton on the 5-DOF
# soft-constraint energy, the default) or "jacobi" (mass-split projected
# impulses + explicit elastic wedge term). Both engines and both kernel
# branches implement both; read at call time.
SOLVER = "newton"
SOLVERS = ("newton", "jacobi")


def default_calib() -> Calib:
    """The fitted table of the current ``SOLVER`` rounded to float32, as the
    JAX package stores it."""
    table = FITTED_2D_NEWTON if SOLVER == "newton" else FITTED_2D
    return Calib(**{k: float(np.float32(v)) for k, v in table.items()})


def nominal_calib() -> Calib:
    """Uncalibrated solref/XML values (kept for ablation and tests)."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return Calib(
        mu_plane=f32(SIM.friction_slide),
        mu_finger=f32(SIM.friction_slide),
        mu_torsion=f32(SIM.friction_torsion),
        k_contact=f32(K_CONTACT),
        b_contact=f32(B_CONTACT),
        unload=f32(UNLOAD),
        rough=f32(ROUGH),
        c_r=f32((1.0 - IMPEDANCE) / IMPEDANCE),
    )


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


@functools.lru_cache(maxsize=None)
def _finger_operators_2d():
    """The jaw's coefficient operator, curve samples and curve basis (the
    same for every design)."""
    g = GRIPPER_2D
    coef_op = cubic_coef_operator(g.num_ctrl, g.ctrl_x_min, g.ctrl_x_max)
    x_curve = np.linspace(g.ctrl_x_min, g.ctrl_x_max, g.num_curve_points)
    basis = cubic_basis_matrix(g.num_ctrl, g.ctrl_x_min, g.ctrl_x_max, x_curve)
    return coef_op, x_curve, basis


# Per-jaw host work: the cubic coefficient transform and the exact MuJoCo jaw
# mass (hull of the full strip + 50 overlapping slab hulls; ~0.05 ms a jaw in
# the port's C++, geom/jawmass.py, ~10 ms in the Python fallback, on one x86
# core). An LRU keeps both per gripper: a hit (~1 us) is cheaper still, and 2D
# datagen reuses grippers across objects.
_FINGER_CACHE_2D = LRU(4096)


def _finger_host_work_2d(y: np.ndarray):
    return _FINGER_CACHE_2D.get(y.tobytes(), lambda: _make_finger_2d(y))


def _make_finger_2d(y: np.ndarray):
    g = GRIPPER_2D
    coef_op, x_curve, basis = _finger_operators_2d()
    coef = np.einsum("skn,n->sk", coef_op, y)
    path = "native" if jawmass.available() else "python"
    with TRACER.span(f"scene.jaw_mass.{path}"):
        area = polygon_lib.finger_cross_section_area(basis @ y, x_curve,
                                                     g.width)
    fmass = SIM.density * g.height * area
    return coef, float(fmass)


def make_scene(yl: np.ndarray, yr: np.ndarray,
               contour: np.ndarray) -> Scene2D:
    """Host-side scene construction from raw control points + object contour.

    Mass/COM/inertia reproduce MuJoCo's model of the oracle scene exactly
    (geom/polygon.py). Pure numpy until the final float32 tensors, which stay
    on the host: ``rollout2d.scene_arrays`` moves a stacked batch to the
    device in one copy per array."""
    with TRACER.span("scene.fingers"):
        coef_l, ml = _finger_host_work_2d(np.asarray(yl, np.float64))
        coef_r, mr = _finger_host_work_2d(np.asarray(yr, np.float64))
    with TRACER.span("scene.object"):
        fmass = np.array([ml, mr])
        poly = contour_lib.ensure_ccw(np.asarray(contour, dtype=np.float64))
        area, com, i0 = polygon_lib.object_mass_properties_2d(poly)
        spts, sw = polygon_lib.support_points(poly, grid=8)
        mass = SIM.density * area * OBJECT_2D.height
        inertia = SIM.density * OBJECT_2D.height * i0
        f32 = functools.partial(torch.as_tensor, dtype=torch.float32)
        return Scene2D(
            coef_l=f32(coef_l),
            coef_r=f32(coef_r),
            contour=f32(poly),
            com=f32(com),
            mass=f32(mass),
            inertia=f32(inertia),
            support_pts=f32(spts),
            support_w=f32(sw),
            finger_mass=f32(fmass),
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


# ---------------------------------------------------------------------------
# The pure engine (engine2d.py:365-1006 of the JAX package)
# ---------------------------------------------------------------------------

# trailing (per-pair) dimensions of each Scene2D field
_SCENE_NDIM = {"coef_l": 2, "coef_r": 2, "contour": 2, "com": 1, "mass": 0,
               "inertia": 0, "support_pts": 2, "support_w": 1,
               "finger_mass": 1}


def expand_scene(scene: Scene2D, k: int) -> Scene2D:
    """Insert k singleton dimensions after a scene's batch dimensions, so
    that stacked pairs (B,) broadcast against states of shape (B, N...)."""
    out = {}
    for f, nd in _SCENE_NDIM.items():
        v = getattr(scene, f)
        lead = v.shape[:v.ndim - nd]
        out[f] = v.reshape(lead + (1,) * k + v.shape[v.ndim - nd:])
    return Scene2D(**out)


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """A float or tensor knob as a float32 tensor beside ``like`` (tensors
    keep their graph; a float is filled on the device, which unlike a copy
    from the host does not wait for the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _max(x, y):
    """jnp.maximum with its balanced gradient at ties (torch.maximum's)."""
    return torch.maximum(x, _t(y, x) if not isinstance(y, torch.Tensor)
                         else y)


def _min(x, y):
    return torch.minimum(x, _t(y, x) if not isinstance(y, torch.Tensor)
                         else y)


def _clip(x, lo, hi):
    """jnp.clip: maximum, then minimum (gradients as JAX's at the bounds)."""
    return _min(_max(x, lo), hi)


def _e(x: torch.Tensor, k: int) -> torch.Tensor:
    """x with k trailing singleton dimensions."""
    return x.reshape(x.shape + (1,) * k)


def init_state(scene: Scene2D, pose: torch.Tensor) -> State2D:
    """pose = (..., 3): (x, y, theta) of the object BODY ORIGIN (the
    freejoint frame, reference sim/sim_2d.py:150-157)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    com_w = torch.stack([
        pose[..., 0] + (c * scene.com[..., 0] + (-s) * scene.com[..., 1]),
        pose[..., 1] + (s * scene.com[..., 0] + c * scene.com[..., 1]),
    ], -1)
    th = pose[..., 2].broadcast_to(com_w.shape[:-1])
    z = torch.zeros_like(th)
    z2 = torch.zeros_like(com_w)
    return State2D(com=com_w, theta=th, vel=z2, om=z, zb=z, vz=z, q=z2,
                   qd=z2)


def _point_kinematics(scene: Scene2D, state: State2D):
    """World lever arms (rx, ry) and positions (px, py) of the contour
    points, (..., P) each, and the orientation's (c, s)."""
    c, s = torch.cos(state.theta), torch.sin(state.theta)
    relx = scene.contour[..., 0] - scene.com[..., 0:1]          # (..., P)
    rely = scene.contour[..., 1] - scene.com[..., 1:2]
    c1, s1 = _e(c, 1), _e(s, 1)
    rx = relx * c1 + rely * (-s1)
    ry = relx * s1 + rely * c1
    px = state.com[..., 0:1] + rx
    py = state.com[..., 1:2] + ry
    return c, s, rx, ry, px, py


def _spline(coef: torch.Tensor, xc: torch.Tensor):
    """Value and slope of the cubic finger curve ``coef`` (..., 6, 4) at
    xc (..., P); the segment's coefficients picked by a where-chain (exact,
    like the JAX spline's one-hot contraction)."""
    g = GRIPPER_2D
    h = (g.ctrl_x_max - g.ctrl_x_min) / (g.num_ctrl - 1)
    seg = torch.clamp(((xc - g.ctrl_x_min) / h).to(torch.int32), 0,
                      g.num_ctrl - 2)
    t = xc - (g.ctrl_x_min + seg.to(torch.float32) * h)
    cs = []
    for k in range(4):
        acc = coef[..., 0, k:k + 1]
        for j in range(1, g.num_ctrl - 1):
            acc = torch.where(seg >= j, coef[..., j, k:k + 1], acc)
        cs.append(acc)
    val = ((cs[3] * t + cs[2]) * t + cs[1]) * t + cs[0]
    der = (3.0 * cs[3] * t + 2.0 * cs[2]) * t + cs[1]
    return val, der


def _finger_contacts(scene: Scene2D, state: State2D, px, py):
    """Contact sets against both finger heightfields, stacked (left,
    right) on dim -2: depth, normal (nx, ny) and activity, (..., 2, P)."""
    g = GRIPPER_2D
    x_in = (px >= g.ctrl_x_min) & (px <= g.ctrl_x_max)
    xc = _clip(px, g.ctrl_x_min, g.ctrl_x_max)
    f_l, d_l = _spline(scene.coef_l, xc)
    f_r, d_r = _spline(scene.coef_r, xc)
    surf_l = -g.jaw_offset + state.q[..., 0:1] + f_l + g.width
    surf_r = g.jaw_offset + state.q[..., 1:2] + f_r
    inv_l = torch.rsqrt(1.0 + d_l * d_l)
    inv_r = torch.rsqrt(1.0 + d_r * d_r)
    depth_l = (surf_l - py) * inv_l
    depth_r = (py - surf_r) * inv_r
    depth = torch.stack([depth_l, depth_r], -2)
    nx = torch.stack([-d_l * inv_l, d_r * inv_r], -2)
    ny = torch.stack([inv_l, -inv_r], -2)
    act = torch.stack([(depth_l > 0.0) & x_in, (depth_r > 0.0) & x_in],
                      -2).to(torch.float32)
    return depth, nx, ny, act


def _psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (finger, point) dims (-2, -1)."""
    return x.sum(dim=(-2, -1))


def _ctrl_force(state: State2D, ctrl) -> torch.Tensor:
    """Servo force of both jaws, (..., 2), ctrl clamped to the actuator
    range like MuJoCo."""
    g = GRIPPER_2D
    ctrl = torch.as_tensor(ctrl, dtype=torch.float32,
                           device=state.q.device)
    ctrl_c = torch.stack([_clip(ctrl[0], 0.0, g.ctrl_clamped),
                          _clip(ctrl[1], -g.ctrl_clamped, 0.0)])
    return g.kp * (ctrl_c - state.q) - g.joint_damping * state.qd


def _regrasp(new: State2D, regrasp) -> State2D:
    """Gripper state reset (eval re-grasp, dynamics/sim_test_mj.py:165-171):
    also zeroes all velocities like the reference's qvel reset."""
    if regrasp is None or regrasp is False:
        return new
    if regrasp is True:
        return State2D(com=new.com, theta=new.theta,
                       vel=torch.zeros_like(new.vel),
                       om=torch.zeros_like(new.om), zb=new.zb,
                       vz=torch.zeros_like(new.vz),
                       q=torch.zeros_like(new.q),
                       qd=torch.zeros_like(new.qd))
    rg = regrasp
    rg2 = _e(rg, 1)
    return State2D(
        com=new.com, theta=new.theta,
        vel=torch.where(rg2, torch.zeros_like(new.vel), new.vel),
        om=torch.where(rg, torch.zeros_like(new.om), new.om),
        zb=new.zb,
        vz=torch.where(rg, torch.zeros_like(new.vz), new.vz),
        q=torch.where(rg2, torch.zeros_like(new.q), new.q),
        qd=torch.where(rg2, torch.zeros_like(new.qd), new.qd),
    )


def step(scene: Scene2D, state: State2D, ctrl, dt: float = SIM.dt,
         regrasp=None, calib: Calib | None = None) -> State2D:
    """One semi-implicit Euler step, dispatching on ``SOLVER`` (read at
    call time)."""
    if SOLVER == "newton":
        return step_newton(scene, state, ctrl, dt, regrasp=regrasp,
                           calib=calib)
    if SOLVER == "jacobi":
        return step_jacobi(scene, state, ctrl, dt, regrasp=regrasp,
                           calib=calib)
    raise ValueError(f"unknown SOLVER {SOLVER!r}; one of {SOLVERS}")


def step_jacobi(scene: Scene2D, state: State2D, ctrl, dt: float = SIM.dt,
                regrasp=None, calib: Calib | None = None) -> State2D:
    """One semi-implicit Euler step with the implicit velocity-level
    impulse solver (mass-split Jacobi with projected accumulators, 6
    iterations) and the explicit elastic wedge impulse under its global
    energy clamp. ``ctrl`` = requested (left, right) jaw target."""
    if calib is None:
        calib = default_calib()
    th = state.theta
    k_con, b_con = _t(calib.k_contact, th), _t(calib.b_contact, th)
    mu_f, mu_p = _t(calib.mu_finger, th), _t(calib.mu_plane, th)
    mu_t, unload = _t(calib.mu_torsion, th), _t(calib.unload, th)
    rough = _t(calib.rough, th)
    m, inertia, fm = scene.mass, scene.inertia, scene.finger_mass
    inv_m, inv_i, inv_fm = 1.0 / m, 1.0 / inertia, 1.0 / fm
    m2, i2, inv_m2, inv_i2 = _e(m, 2), _e(inertia, 2), _e(inv_m, 2), \
        _e(inv_i, 2)

    c, s, rx, ry, px, py = _point_kinematics(scene, state)
    depth, nx, ny, act = _finger_contacts(scene, state, px, py)
    rx, ry = rx.unsqueeze(-2), ry.unsqueeze(-2)                 # (..., 1, P)

    # mass-splitting weights over each finger's active contacts
    cnt = _max(act.sum(dim=-1, keepdim=True), 1.0)
    w_c = act / cnt
    tx, ty = -ny, nx
    rxn = rx * ny - ry * nx
    rxt = rx * ty - ry * tx
    inv_fm_c = _e(inv_fm, 1)                                    # (..., 2, 1)
    m_eff_n = 1.0 / (inv_m2 + rxn * rxn * inv_i2 + ny ** 2 * inv_fm_c)
    m_eff_t = 1.0 / (inv_m2 + rxt * rxt * inv_i2 + ty ** 2 * inv_fm_c)

    depth_z = SIM.plane_z - state.zb
    n_total = m * _max(K_PLANE * depth_z - B_PLANE * state.vz, 0.0)
    sx = scene.support_pts[..., 0] - scene.com[..., 0:1]       # (..., S)
    sy = scene.support_pts[..., 1] - scene.com[..., 1:2]
    c1, s1 = _e(c, 1), _e(s, 1)
    rsx = sx * c1 + sy * (-s1)
    rsy = sx * s1 + sy * c1

    # soft-constraint velocity targets (from current-state v_n and depth)
    vx0, vy0 = _e(state.vel[..., 0], 2), _e(state.vel[..., 1], 2)
    om0 = _e(state.om, 2)
    qd_f = _e(state.qd, 1)                                      # (..., 2, 1)
    vpx0 = vx0 + om0 * (-ry)
    vpy0 = vy0 + om0 * rx
    vn0 = (vpx0 - qd_f * 0.0) * nx + (vpy0 - qd_f) * ny
    d_imp = IMPEDANCE
    target_n = (1.0 - d_imp * B_CONTACT * dt) * vn0 \
        + d_imp * dt * K_CONTACT * depth

    # explicit elastic wedge impulse, clamped to each contact's pushout cap
    depth_el = act * _clip(depth, 0.0, DEPTH_EL_CAP)
    v_cap = d_imp * dt * k_con * depth_el
    dv_el = _clip(d_imp * dt * (k_con * depth_el - b_con * vn0), 0.0,
                  _max(v_cap - vn0, 0.0))
    imp_mag = act * m_eff_n * dv_el
    imp_x, imp_y = imp_mag * nx, imp_mag * ny
    # global energy clamp on the summed elastic wrench
    dvx_u = _psum(imp_x) * inv_m
    dvy_u = _psum(imp_y) * inv_m
    dom_u = _psum(imp_mag * rxn) * inv_i
    dqd_u = -imp_y.sum(dim=-1) * inv_fm                         # (..., 2)
    dvpx = _e(dvx_u, 2) + _e(dom_u, 2) * (-ry)
    dvpy = _e(dvy_u, 2) + _e(dom_u, 2) * rx
    dvn_ind = (dvpx * nx + dvpy * ny) - _e(dqd_u, 1) * ny
    headroom = _max(v_cap - vn0, 0.0)
    # double where keeps the unselected branch's gradient finite (the raw
    # quotient has ~0 denominators on inactive contacts)
    take = (act > 0) & (dvn_ind > 1e-9)
    denom = torch.where(take, dvn_ind, torch.ones_like(dvn_ind))
    ratio = torch.where(take, headroom / denom,
                        torch.full_like(dvn_ind, float("inf")))
    s_el = _clip(ratio.amin(dim=(-2, -1)), 0.0, 1.0)
    s_el2 = _e(s_el, 2)
    imp_mag = s_el2 * imp_mag
    imp_x, imp_y = s_el2 * imp_x, s_el2 * imp_y
    f_el = imp_mag / dt

    # mean-field plane unloading from the grip load
    grip_ratio = _psum(f_el) / (m * SIM.gravity)
    n_i = scene.support_w * _e(n_total, 1) / (1.0 + unload * _e(grip_ratio, 1))

    # unconstrained velocity update (elastic wedge impulses included)
    f_fing = _ctrl_force(state, ctrl)
    vx = state.vel[..., 0] + _psum(imp_x) * inv_m
    vy = state.vel[..., 1] + _psum(imp_y) * inv_m
    om = state.om + _psum(dt * f_el * rxn) * inv_i
    vz = state.vz + dt * (-SIM.gravity + n_total * inv_m)
    qd = state.qd + dt * (f_fing * inv_fm) - imp_y.sum(dim=-1) * inv_fm

    # implicit contact solve (Jacobi + projected accumulators)
    lam_n = torch.zeros_like(depth)
    lam_t = torch.zeros_like(depth)
    lam_sx = torch.zeros_like(n_i)
    lam_sy = torch.zeros_like(n_i)
    lam_w = torch.zeros_like(n_i)
    cap_rough = rough * m_eff_t * _min(depth_el, ROUGH_SAT)
    cap_s = mu_p * n_i * dt
    cap_w = mu_t * n_i * dt
    sw = scene.support_w
    for _ in range(SOLVER_ITERS):
        om2 = _e(om, 2)
        vpx = _e(vx, 2) + om2 * (-ry)
        vpy = _e(vy, 2) + om2 * rx
        qd2 = _e(qd, 1)
        vrx, vry = vpx - qd2 * 0.0, vpy - qd2
        vn = vrx * nx + vry * ny
        vt = vrx * tx + vry * ty
        # normal: project the accumulated impulse to >= 0
        new_lam_n = _max(lam_n + w_c * m_eff_n * (target_n - vn), 0.0)
        d_n = new_lam_n - lam_n
        # friction: clamp the accumulated impulse to the cone (normal load
        # includes the elastic wedge impulse + crack-capture capacity)
        cap = mu_f * (new_lam_n + dt * f_el) + cap_rough
        new_lam_t = _clip(lam_t + (-w_c * m_eff_t * vt), -cap, cap)
        d_t = new_lam_t - lam_t
        ix = d_n * nx + d_t * tx
        iy = d_n * ny + d_t * ty
        vx = vx + _psum(ix) * inv_m
        vy = vy + _psum(iy) * inv_m
        om = om + _psum(d_n * rxn + d_t * rxt) * inv_i
        qd = qd - iy.sum(dim=-1) * inv_fm
        lam_n, lam_t = new_lam_n, new_lam_t

        # plane friction at support points (2D vector impulse per point)
        om1 = _e(om, 1)
        vsx = _e(vx, 1) + om1 * (-rsy)
        vsy = _e(vy, 1) + om1 * rsx
        nsx = lam_sx + (-sw) * _e(m, 1) * vsx
        nsy = lam_sy + (-sw) * _e(m, 1) * vsy
        norm_s = torch.sqrt(nsx * nsx + nsy * nsy + 1e-20)
        scale_s = _min(cap_s / norm_s, 1.0)
        nsx, nsy = nsx * scale_s, nsy * scale_s
        d_sx, d_sy = nsx - lam_sx, nsy - lam_sy
        vx = vx + d_sx.sum(dim=-1) * inv_m
        vy = vy + d_sy.sum(dim=-1) * inv_m
        om = om + (rsx * d_sy - rsy * d_sx).sum(dim=-1) * inv_i
        lam_sx, lam_sy = nsx, nsy
        # torsional friction
        new_lam_w = _clip(lam_w + (-sw) * _e(inertia, 1) * _e(om, 1),
                          -mu_t * n_i * dt, cap_w)
        om = om + (new_lam_w - lam_w).sum(dim=-1) * inv_i
        lam_w = new_lam_w

    vel = torch.stack([vx, vy], -1)
    new = State2D(com=state.com + dt * vel, theta=state.theta + dt * om,
                  vel=vel, om=om, zb=state.zb + dt * vz, vz=vz,
                  q=state.q + dt * qd, qd=qd)
    return _regrasp(new, regrasp)


def _hub(v, w, cap):
    """Huber potential: quadratic stick, linear slip."""
    q = 0.5 * w * v * v
    lin = cap * torch.abs(v) - 0.5 * cap * cap / _max(w, 1e-12)
    return torch.where(w * torch.abs(v) <= cap, q, lin)


def step_newton(scene: Scene2D, state: State2D, ctrl, dt: float = SIM.dt,
                regrasp=None, calib: Calib | None = None,
                return_forces: bool = False):
    """One semi-implicit step with a coupled semi-smooth Newton contact
    solve: damped Newton on MuJoCo's convex soft-constraint energy over
    u = (vx, vy, omega, qd_l, qd_r) with per-row compliance
    r_i = c_r * (J_i M^-1 J_i^T), a batched 5x5 solve, a line search over
    the full and half step and the current u (ties to the first), friction
    caps lagged one iteration; 3 iterations, 2 for a pose without finger
    contact. With ``return_forces`` also a dict of the final contact
    impulses and torques. Fully differentiable.

    Layout: u (..., 5) with the 5 DOF last (the batched solve's), the
    Jacobians DOF-first (5, ..., 2, P), the three line-search candidates on
    a new leading dim of u; the JAX
    package's ``precision="highest"`` contractions are elementwise products
    and sums here, so TF32 never touches them."""
    if calib is None:
        calib = default_calib()
    th = state.theta
    k_con, b_con = _t(calib.k_contact, th), _t(calib.b_contact, th)
    mu_f, mu_p = _t(calib.mu_finger, th), _t(calib.mu_plane, th)
    mu_t, unload = _t(calib.mu_torsion, th), _t(calib.unload, th)
    rough, c_r = _t(calib.rough, th), _t(calib.c_r, th)
    m, inertia, fm = scene.mass, scene.inertia, scene.finger_mass
    inv_m, inv_i, inv_fm = 1.0 / m, 1.0 / inertia, 1.0 / fm

    c, s, rx, ry, px, py = _point_kinematics(scene, state)
    depth, nx, ny, act = _finger_contacts(scene, state, px, py)
    rx, ry = rx.unsqueeze(-2), ry.unsqueeze(-2)                 # (..., 1, P)

    tx, ty = -ny, nx
    rxn = rx * ny - ry * nx
    rxt = rx * ty - ry * tx
    inv_fm_c = _e(inv_fm, 1)
    a_nn = _e(inv_m, 2) + rxn * rxn * _e(inv_i, 2) + ny ** 2 * inv_fm_c
    a_tt = _e(inv_m, 2) + rxt * rxt * _e(inv_i, 2) + ty ** 2 * inv_fm_c
    w_n = act / (c_r * a_nn)
    w_t = act / (c_r * a_tt)
    m_eff_t = 1.0 / a_tt

    # constraint rows d(v_rel . dir)/du for dir = n and t: the components
    # on (vx, vy, om) and, on the row's own jaw DOF only (qd_l for the left
    # finger's rows, qd_r for the right's), minus the y component
    comp_n, comp_t = (nx, ny, rxn), (tx, ty, rxt)

    def rows(comp, u):
        """J u for u (..., 5), any leading dims -> (..., 2, P)."""
        cx, cy, cr = comp
        return (cx * _e(u[..., 0], 2) + cy * _e(u[..., 1], 2)
                + cr * _e(u[..., 2], 2) - cy * u[..., 3:5, None])

    def contract(w, comp):
        """sum over (finger, point) of w * J -> (..., 5)."""
        cx, cy, cr = comp
        wy = (w * cy).sum(dim=-1)                               # (..., 2)
        return torch.stack([_psum(w * cx), wy.sum(dim=-1), _psum(w * cr),
                            -wy[..., 0], -wy[..., 1]], -1)

    def curvature(on, comp):
        """sum over points of on * J_a * J_b per finger, for the 6 distinct
        products of (cx, cy, cr) (the jaw component is -cy): (..., 2)
        each, keyed (a, b)."""
        cx, cy, cr = comp
        yx, yy, yr = on * cx, on * cy, on * cr
        return {(0, 0): (yx * cx).sum(dim=-1), (0, 1): (yx * cy).sum(dim=-1),
                (0, 2): (yx * cr).sum(dim=-1), (1, 1): (yy * cy).sum(dim=-1),
                (1, 2): (yy * cr).sum(dim=-1), (2, 2): (yr * cr).sum(dim=-1)}

    u0 = torch.cat([state.vel, state.om[..., None], state.qd], -1)
    d_imp = IMPEDANCE
    vn0 = rows(comp_n, u0)
    target = (1.0 - d_imp * b_con * dt) * vn0 + d_imp * dt * k_con * depth
    depth_el = act * _clip(depth, 0.0, DEPTH_EL_CAP)
    cap_rough = rough * m_eff_t * depth_el

    # plane support rows (normal handled by the explicit z penalty)
    depth_z = SIM.plane_z - state.zb
    n_total = m * _max(K_PLANE * depth_z - B_PLANE * state.vz, 0.0)
    sx = scene.support_pts[..., 0] - scene.com[..., 0:1]
    sy = scene.support_pts[..., 1] - scene.com[..., 1:2]
    c1, s1 = _e(c, 1), _e(s, 1)
    rsx = sx * c1 + sy * (-s1)
    rsy = sx * s1 + sy * c1
    a_s = _e(inv_m, 1) + (rsx * rsx + rsy * rsy) * _e(inv_i, 1) * 0.5
    w_s = 1.0 / (c_r * a_s)
    w_w = inertia / c_r

    mdiag = torch.stack(torch.broadcast_tensors(
        m, m, inertia, fm[..., 0], fm[..., 1]), -1)
    f_fing = _ctrl_force(state, ctrl)
    u_unc = u0 + dt * torch.cat(
        [torch.zeros_like(u0[..., :3]), f_fing * inv_fm], -1)
    mg_dt = _max(m * SIM.gravity * dt, 1e-9)
    sw = scene.support_w

    def caps_from(vn):
        """Friction caps at normal velocities vn = J_n u."""
        lam_n = w_n * _max(target - vn, 0.0)
        cap_t = mu_f * lam_n + cap_rough
        grip_ratio = _psum(lam_n) / mg_dt
        n_i = sw * _e(n_total, 1) / (1.0 + unload * _e(grip_ratio, 1))
        cap_s = mu_p * n_i * dt
        cap_w = mu_t * n_i.sum(dim=-1) * dt
        return cap_t, cap_s, cap_w

    def plane_vel(u):
        vsx = u[..., 0:1] - rsy * u[..., 2:3]
        vsy = u[..., 1:2] + rsx * u[..., 2:3]
        return vsx, vsy, torch.sqrt(vsx * vsx + vsy * vsy + 1e-16)

    def energy(u, vn, vt, cap_t, cap_s, cap_w):
        """u (..., 5) and its rows vn = J_n u, vt = J_t u, any leading dims
        that broadcast -> (...)."""
        e_n = 0.5 * w_n * _max(target - vn, 0.0) ** 2
        e_t = _hub(vt, w_t, cap_t)
        e_s = _hub(plane_vel(u)[2], w_s, cap_s)
        e_w = _hub(u[..., 2], w_w, cap_w)
        e_u = 0.5 * (mdiag * (u - u_unc) ** 2).sum(-1)
        return e_u + _psum(e_n) + _psum(e_t) + e_s.sum(dim=-1) + e_w

    def newton_iter(u):
        vn, vt = rows(comp_n, u), rows(comp_t, u)
        cap_t, cap_s, cap_w = caps_from(vn)
        res_n = _max(target - vn, 0.0)
        lam_n = w_n * res_n
        lam_t = _clip(w_t * vt, -cap_t, cap_t)
        vsx, vsy, vs = plane_vel(u)
        fac_s = _min(w_s, cap_s / vs)
        f_w = _clip(w_w * u[..., 2], -cap_w, cap_w)
        fx, fy = fac_s * vsx, fac_s * vsy
        zero = torch.zeros_like(f_w)
        plane = torch.stack([fx.sum(dim=-1), fy.sum(dim=-1),
                             (rsx * fy - rsy * fx).sum(dim=-1) + f_w, zero,
                             zero], -1)
        grad = mdiag * (u - u_unc)
        grad = grad - contract(lam_n, comp_n)
        grad = grad + contract(lam_t, comp_t)
        grad = grad + plane
        on_n = w_n * (res_n > 0.0)
        on_t = w_t * (torch.abs(w_t * vt) <= cap_t)
        qn, qt = curvature(on_n, comp_n), curvature(on_t, comp_t)
        q = {k: qn[k] + qt[k] for k in qn}                     # (..., 2)
        # plane rows (isotropic Gauss-Newton curvature fac_s)
        hs00 = fac_s.sum(dim=-1)
        hp = {(0, 0): hs00, (1, 1): hs00,
              (0, 2): (fac_s * (-rsy)).sum(dim=-1),
              (1, 2): (fac_s * rsx).sum(dim=-1),
              (2, 2): (fac_s * (rsx * rsx + rsy * rsy)).sum(dim=-1)
              + w_w * (torch.abs(w_w * u[..., 2]) <= cap_w)}
        hm = [[None] * 5 for _ in range(5)]
        for a in range(3):
            for b in range(a, 3):
                hab = q[(a, b)].sum(dim=-1)
                if a == b:
                    hab = mdiag[..., a] + hab
                if (a, b) in hp:
                    hab = hab + hp[(a, b)]
                hm[a][b] = hm[b][a] = hab
            # the jaw DOF: only its own finger's rows, component -cy
            q1 = q[(min(a, 1), max(a, 1))]
            hm[a][3] = hm[3][a] = -q1[..., 0]
            hm[a][4] = hm[4][a] = -q1[..., 1]
        hm[3][3] = mdiag[..., 3] + q[(1, 1)][..., 0]
        hm[4][4] = mdiag[..., 4] + q[(1, 1)][..., 1]
        hm[3][4] = hm[4][3] = torch.zeros_like(hm[3][3])
        hmat = torch.stack([torch.stack(row, -1) for row in hm], -2)
        delta = torch.linalg.solve_ex(hmat, -grad)[0]
        # the candidates u + a delta, a in (1, 0.5), and u; their rows by
        # linearity, J (u + a delta) = J u + a J delta
        dn, dt_ = rows(comp_n, delta), rows(comp_t, delta)
        cands = torch.stack([u + a * delta for a in _LS_ALPHAS] + [u])
        evals = energy(cands,
                       torch.stack([vn + a * dn for a in _LS_ALPHAS] + [vn]),
                       torch.stack([vt + a * dt_ for a in _LS_ALPHAS] + [vt]),
                       cap_t, cap_s, cap_w)
        best = evals.argmin(dim=0)
        idx = best[None, ..., None].expand((1,) + u.shape)
        return torch.gather(cands, 0, idx)[0]

    # no-contact fast phase: with no active finger contact the iteration
    # degenerates to the plane-friction subproblem and 2 suffice. Gated per
    # pose (the kernel gates per 128-pose group).
    any_f = _psum(act) > 0.0
    u = u_unc
    for i in range(NEWTON_ITERS):
        u2 = newton_iter(u)
        u = u2 if i < 2 else torch.where(any_f[..., None], u2, u)

    vel, om, qd = u[..., 0:2], u[..., 2], u[..., 3:5]
    vz = state.vz + dt * (-SIM.gravity + n_total * inv_m)
    new = _regrasp(State2D(
        com=state.com + dt * vel, theta=state.theta + dt * om, vel=vel,
        om=om, zb=state.zb + dt * vz, vz=vz, q=state.q + dt * qd, qd=qd),
        regrasp)
    if not return_forces:
        return new
    vn = rows(comp_n, u)
    cap_t, cap_s, cap_w = caps_from(vn)
    lam_n = w_n * _max(target - vn, 0.0)
    lam_t = _clip(w_t * rows(comp_t, u), -cap_t, cap_t)
    vsx, vsy, vs = plane_vel(u)
    fac_s = _min(w_s, cap_s / vs)
    diag = {
        "lam_n": lam_n, "lam_t": lam_t,            # (..., 2, P) impulses
        "torque_fing": _psum(lam_n * rxn - lam_t * rxt) / dt,
        "torque_plane": -(fac_s * (rsx * vsy - rsy * vsx)).sum(dim=-1) / dt,
        "n_active": _psum(act),
        "depth": depth, "act": act,
    }
    return new, diag


def _origin_of(scene: Scene2D, state: State2D) -> torch.Tensor:
    c, s = torch.cos(state.theta), torch.sin(state.theta)
    return torch.stack([
        state.com[..., 0] - (c * scene.com[..., 0] + (-s) * scene.com[..., 1]),
        state.com[..., 1] - (s * scene.com[..., 0] + c * scene.com[..., 1]),
    ], -1)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def _squeeze_ctrl(device) -> torch.Tensor:
    return torch.tensor([SIM.ctrl_2d, -SIM.ctrl_2d], dtype=torch.float32,
                        device=device)


def _regrasp_at(i: int, regrasp_every: int):
    return (i % regrasp_every == 0 and i > 0) if regrasp_every else None


def rollout(scene: Scene2D, pose: torch.Tensor, steps: int = SIM.steps_2d,
            dt: float = SIM.dt, regrasp_every: int = 0,
            calib: Calib | None = None):
    """Squeeze rollouts from poses (..., 3) of a scene that broadcasts
    against them -> (delta_theta wrapped to (-pi, pi] (...),
    delta_pos (..., 2), final_theta in [0, 2pi) (...)), the reference npz
    conventions (sim/sim_2d.py:172-180)."""
    state = init_state(scene, pose)
    ctrl = _squeeze_ctrl(pose.device)
    for i in range(steps):
        state = step(scene, state, ctrl, dt,
                     regrasp=_regrasp_at(i, regrasp_every), calib=calib)
    d_theta = _wrap(state.theta - pose[..., 2])
    d_pos = _origin_of(scene, state) - pose[..., :2]
    final_theta = torch.remainder(state.theta, 2.0 * math.pi)
    return d_theta, d_pos, final_theta


def rollout_trace(scene: Scene2D, pose: torch.Tensor,
                  steps: int = SIM.steps_2d, every: int = 10,
                  regrasp_every: int = 0, calib: Calib | None = None):
    """Trajectory-capturing rollout for visualisation: per sampled step
    (obj_x, obj_y, theta, ql, qr) -> (..., ceil(steps / every), 5), the
    rows of steps 0, every, 2 * every, ... (the state after each)."""
    state = init_state(scene, pose)
    ctrl = _squeeze_ctrl(pose.device)
    rows = []
    for i in range(steps):
        state = step(scene, state, ctrl,
                     regrasp=_regrasp_at(i, regrasp_every), calib=calib)
        if i % every == 0:
            origin = _origin_of(scene, state)
            rows.append(torch.stack([origin[..., 0], origin[..., 1],
                                     state.theta, state.q[..., 0],
                                     state.q[..., 1]], -1))
    return torch.stack(rows, -2)


def profile(scene: Scene2D, poses: torch.Tensor, steps: int = SIM.steps_2d,
            regrasp_every: int = 0, calib: Calib | None = None):
    """Interaction profile of one scene: poses (N, 3) -> (delta_theta (N,),
    delta_pos (N, 2), final_theta (N,))."""
    return rollout(scene, poses, steps=steps, regrasp_every=regrasp_every,
                   calib=calib)


def profile_batch(scenes: Scene2D, poses: torch.Tensor,
                  steps: int = SIM.steps_2d, calib: Calib | None = None):
    """Batch over pairs AND poses: scenes with leading dim B, poses (N, 3)
    shared -> outputs (B, N, ...)."""
    return rollout(expand_scene(scenes, 1), poses, steps=steps, calib=calib)
