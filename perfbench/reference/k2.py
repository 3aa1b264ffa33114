"""Plain PyTorch version of the 3D rollout kernel (K2) — the same math as
``dgdm_tpu/sim/pallas3d.py:_rollout3d_kernel`` with the configuration's
contact solver (the coupled Newton solve with its fixed iteration count),
on dense tensors, with a Python step loop.

Layout: lanes are poses, grouped in blocks of ``LANE`` = 128 exactly as the
Pallas grid groups them; the (pair, pose-block) cells are flattened to G =
B * N / 128 rows. Per-lane state is (G, L); per-surface-point work is
(G', P, L) on the rows G' that take a branch. The block-uniform branches of
the Pallas kernel (settled travel vs a normal step; full 8-DOF vs cheap
6-DOF solve) are decided per row with the same reductions, and each branch
runs on the rows that take it: a lane's result depends on its block-mates
exactly as in the TPU kernel and in ``csrc/rollout3d.cu``.

On the CPU this is the port's rollout path. On the card it serves the tests
and ``chip_smoke.py`` as the reference the CUDA kernel is held to. Every
expression keeps the Pallas kernel's operand order; ``rsqrt`` is spelled
``1 / sqrt`` so that the CPU and the card round it alike, and the float32
constants the Pallas kernel folds from scalars are folded here in float32
(``constants``). Sums over surface points accumulate in float64 and round
once to float32, here and in the kernel (``sim/point_sum.py``): that makes
them independent of the order of the reduction in all but rare cases, and
``sum_group=G`` reproduces the order of the kernel with G threads a rollout
exactly. State and elementwise physics stay float32.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference.config import GRIPPER_3D, SIM
from perfbench.reference.scene2d import (
    B_CONTACT,
    DEPTH_EL_CAP,
    IMPEDANCE,
    K_CONTACT,
    ROUGH_SAT,
)
from perfbench.reference.scene3d import B_PLANE3, K_PLANE3, V_REST_THRESH
from perfbench.reference.point_sum import point_sum
from perfbench.reference.surface_fit import DEG_X, DEG_Z, N_SEG, NZ_SEG, TOT_SEG

LANE = 128
# settled-travel fast-path gate (pallas3d.EPS_SETTLED)
EPS_SETTLED = 1e-4
# per-pair scalar slots (layout: rollout3d.scene_arrays_3d)
N_SCALARS = 32
# cheap-solve Newton iterations
CHEAP_ITERS = 3
# full-solve Newton iterations a step of the kernel
# (dgdm_tpu_torch/sim/rollout3d.py:NEWTON_KERNEL_ITERS3)
NEWTON_KERNEL_ITERS3 = 1
# the 12 raw outputs, in the kernel's order
OUT_NAMES = ("qw", "qz", "dpx", "dpy", "valid", "sqw", "sqz", "sdx", "sdy",
             "cfull", "ccheap", "citer")


def constants() -> Dict[str, float]:
    """Every constant of the step, as float32 values. Where the Pallas
    kernel combines float32 scalars (``d_imp * bp_ * dt``) the product is
    taken in float32 here too; python-float expressions of the kernel
    (``-jaw_offset + width``) are taken in float64 and rounded once, as JAX
    rounds a weakly typed constant."""
    g = GRIPPER_3D
    f = np.float32
    dt, d_imp = f(SIM.dt), f(IMPEDANCE)
    hseg = (g.ctrl_x_max - g.ctrl_x_min) / N_SEG
    hzseg = (g.ctrl_z_max - g.ctrl_z_min) / NZ_SEG
    ctrl = f(min(SIM.ctrl_3d, g.ctrl_clamped))
    c = {
        "dt": dt, "d_imp": d_imp,
        "ctrl_l": ctrl, "ctrl_r": -ctrl,
        "kp": f(g.kp), "damping": f(g.joint_damping),
        "x0f": f(g.ctrl_x_min), "x1f": f(g.ctrl_x_max),
        "z0f": f(g.ctrl_z_min), "z1f": f(g.ctrl_z_max),
        "hseg": f(hseg), "hzseg": f(hzseg),
        "inv_hseg": f(1.0 / hseg), "inv_hzseg": f(1.0 / hzseg),
        "surf_l0": f(-g.jaw_offset + g.width), "surf_r0": f(g.jaw_offset),
        "plane_z": f(SIM.plane_z),
        "tgt_p_v": f(1.0) - d_imp * f(B_PLANE3) * dt,
        "tgt_p_d": d_imp * dt * f(K_PLANE3),
        # the Jacobi branch's finger targets take the uncalibrated gains
        "tgt_fj_v": f(1.0) - d_imp * f(B_CONTACT) * dt,
        "tgt_fj_d": d_imp * dt * f(K_CONTACT),
        "rough_sat": f(ROUGH_SAT),
        "g_dt": dt * f(SIM.gravity), "gravity": f(SIM.gravity),
        "d_imp_dt": d_imp * dt,
        "v_rest": f(V_REST_THRESH), "depth_el_cap": f(DEPTH_EL_CAP),
        "eps_settled": f(EPS_SETTLED), "marg": f(1e-4),
        "tip_atol": f(SIM.tipover_atol),
    }
    return {k: float(v) for k, v in c.items()}


def _rsqrt(x):
    return 1.0 / torch.sqrt(x)


def _rsum_of(k):
    """The point sum (G', P, L) -> (G', L) in the order ``k["sum_group"]``
    names (``point_sum``)."""
    return functools.partial(point_sum, dim=1, group=k["sum_group"])


def _cholesky_solve(h, grad, n):
    """Unrolled Cholesky solve of H d = -grad over the upper triangle h[a][b]
    (a <= b), as the Pallas kernel writes it (``rsqrt(max(s, 1e-12))``)."""
    low = [[None] * n for _ in range(n)]
    ld = [None] * n
    for a in range(n):
        s_ = h[a][a]
        for k in range(a):
            s_ = s_ - low[a][k] * low[a][k]
        dinv = _rsqrt(torch.clamp(s_, min=1e-12))
        ld[a] = dinv
        for b_ in range(a + 1, n):
            s2 = h[a][b_]
            for k in range(a):
                s2 = s2 - low[b_][k] * low[a][k]
            low[b_][a] = s2 * dinv
    yv = [None] * n
    for a in range(n):
        s_ = -grad[a]
        for k in range(a):
            s_ = s_ - low[a][k] * yv[k]
        yv[a] = s_ * ld[a]
    dv = [None] * n
    for a in range(n - 1, -1, -1):
        s_ = yv[a]
        for k in range(a + 1, n):
            s_ = s_ - low[k][a] * dv[k]
        dv[a] = s_ * ld[a]
    return dv


def _line_search(u, u1, u2, e0, e1, e2):
    """Best of {u + d, u + d/2} if it does not raise the energy, else u."""
    best12 = e1 <= e2
    eb = torch.where(best12, e1, e2)
    take_new = eb <= e0
    return [torch.where(take_new, torch.where(best12, a1, a2), a0)
            for a0, a1, a2 in zip(u, u1, u2)]


class _Pairs:
    """Per-pair inputs, one row per (pair, pose-block) cell of a branch: the
    32 scalar slots (G', 32), the body-frame points relative to the COM
    (G', P, 1) each, and the flattened surface coefficients (G', 2, 288)."""

    def __init__(self, s, pbx, pby, pbz, coef):
        self.s, self.pbx, self.pby, self.pbz, self.coef = s, pbx, pby, pbz, coef

    @classmethod
    def build(cls, coefs, points, scalars, rows):
        s = scalars[:, 0, :].index_select(0, rows)
        pts = points.index_select(0, rows)
        pb = [(pts[:, :, a] - s[:, 2 + a:3 + a])[..., None] for a in range(3)]
        coef = coefs.index_select(0, rows).reshape(len(rows), 2, TOT_SEG * 12)
        return cls(s, *pb, coef)

    def select(self, rows) -> "_Pairs":
        return _Pairs(*(x.index_select(0, rows) for x in
                        (self.s, self.pbx, self.pby, self.pbz, self.coef)))

    def lane(self, k):
        """Scalar slot k against lane tensors (G', L)."""
        return self.s[:, k:k + 1]

    def pt(self, k):
        """Scalar slot k against point tensors (G', P, L)."""
        return self.s[:, k:k + 1, None]


def _surface_eval(coef_flat, seg, t, s):
    """Piecewise-polynomial surface height and slopes at cells ``seg``
    (direct index), local offsets t (x) and s (z): (y, dy/dx, dy/dz)."""
    gs = seg.shape
    idx = (seg.long() * 12).reshape(gs[0], -1)
    c = [[torch.gather(coef_flat, 1, idx + (a * 3 + b)).reshape(gs)
          for b in range(DEG_Z + 1)] for a in range(DEG_X + 1)]
    rows, drows = [], []
    for a in range(DEG_X + 1):
        row = c[a][DEG_Z]
        for b in range(DEG_Z - 1, -1, -1):
            row = row * s + c[a][b]
        rows.append(row)
        drow = c[a][DEG_Z] * DEG_Z
        for b in range(DEG_Z - 1, 0, -1):
            drow = drow * s + c[a][b] * b
        drows.append(drow)
    y = rows[DEG_X]
    dy_dx = rows[DEG_X] * DEG_X
    dy_dz = drows[DEG_X]
    for a in range(DEG_X - 1, -1, -1):
        y = y * t + rows[a]
        if a > 0:
            dy_dx = dy_dx * t + rows[a] * a
        dy_dz = dy_dz * t + drows[a]
    return y, dy_dx, dy_dz


def _rotation(qw, qx, qy, qz):
    return (
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
        2 * (qx * qz + qw * qy),
        2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
        2 * (qy * qz - qw * qx),
        2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
        1 - 2 * (qx * qx + qy * qy),
    )


def _sandwich(r, i00, i11, i22, i01, i02, i12):
    """R M R^T of a symmetric M (upper triangle) -> 6 entries."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    a00 = r00 * i00 + r01 * i01 + r02 * i02
    a01 = r00 * i01 + r01 * i11 + r02 * i12
    a02 = r00 * i02 + r01 * i12 + r02 * i22
    a10 = r10 * i00 + r11 * i01 + r12 * i02
    a11 = r10 * i01 + r11 * i11 + r12 * i12
    a12 = r10 * i02 + r11 * i12 + r12 * i22
    a20 = r20 * i00 + r21 * i01 + r22 * i02
    a21 = r20 * i01 + r21 * i11 + r22 * i12
    a22 = r20 * i02 + r21 * i12 + r22 * i22
    return (a00 * r00 + a01 * r01 + a02 * r02,
            a00 * r10 + a01 * r11 + a02 * r12,
            a00 * r20 + a01 * r21 + a02 * r22,
            a10 * r10 + a11 * r11 + a12 * r12,
            a10 * r20 + a11 * r21 + a12 * r22,
            a20 * r20 + a21 * r21 + a22 * r22)


def _symmul(m, tx, ty, tz):
    m00, m01, m02, m11, m12, m22 = m
    return (m00 * tx + m01 * ty + m02 * tz,
            m01 * tx + m11 * ty + m12 * tz,
            m02 * tx + m12 * ty + m22 * tz)


def _normal_step(st, pr: _Pairs, k):
    """One physics step (Pallas ``_normal_step``, Newton solver) of the rows
    in ``st`` (lane tensors (G', L))."""
    (px, py, pz, qw, qx, qy, qz, vx, vy, vz,
     ox, oy, oz, ql, qr, qdl, qdr, wyn, wyx, cnt_f, cnt_c, cnt_i) = st
    dt = k["dt"]
    mass, fmass_l, fmass_r = pr.lane(0), pr.lane(1), pr.lane(11)
    inv_m = 1.0 / mass
    inv_fml, inv_fmr = 1.0 / fmass_l, 1.0 / fmass_r

    r = _rotation(qw, qx, qy, qz)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    w = _sandwich(r, *(pr.lane(i) for i in (5, 6, 7, 8, 9, 10)))
    iw = _sandwich(r, *(pr.lane(i) for i in (18, 19, 20, 21, 22, 23)))
    # lane values as (G', 1, L) against points (G', P, 1)
    e = lambda x: x[:, None, :]                                 # noqa: E731
    rx = e(r00) * pr.pbx + e(r01) * pr.pby + e(r02) * pr.pbz    # (G', P, L)
    ry = e(r10) * pr.pbx + e(r11) * pr.pby + e(r12) * pr.pbz
    rz = e(r20) * pr.pbx + e(r21) * pr.pby + e(r22) * pr.pbz
    wx = e(px) + rx
    wy = e(py) + ry
    wz = e(pz) + rz
    # the travel broad-phase cache: the object's wy span as of this step
    wyn = wy.amin(dim=1)
    wyx = wy.amax(dim=1)

    we = [e(x) for x in w]

    def contact_ang(cx, cy, cz):
        wx_, wy_, wz_ = _symmul(we, cx, cy, cz)
        return cx * wx_ + cy * wy_ + cz * wz_

    depth_p = k["plane_z"] - wz
    act_p = (depth_p > 0).to(torch.float32)
    # plane contact frame r x ez = (ry, -rx, 0): the zero terms of the
    # Pallas kernel's general contact_frame add exact zeros
    wxp = we[0] * ry + we[1] * (-rx)
    wyp = we[1] * ry + we[3] * (-rx)
    ang_p = ry * wxp + (-rx) * wyp
    me_p = 1.0 / (e(inv_m) + ang_p)

    # pre-update point velocities (shared by finger and plane rows)
    vpx = e(vx) + e(oy) * rz - e(oz) * ry
    vpy = e(vy) + e(oz) * rx - e(ox) * rz
    vpz = e(vz) + e(ox) * ry - e(oy) * rx
    tgt_p = k["tgt_p_v"] * vpz + k["tgt_p_d"] * depth_p
    c_r = pr.pt(24)
    w_np = act_p * me_p / c_r
    mg_dt = mass * k["gravity"] * dt

    f_l = k["kp"] * (k["ctrl_l"] - ql) - k["damping"] * qdl
    f_r = k["kp"] * (k["ctrl_r"] - qr) - k["damping"] * qdr
    u_unc = [vx, vy, vz - k["g_dt"], ox, oy, oz,
             qdl + dt * f_l * inv_fml, qdr + dt * f_r * inv_fmr]

    # broad phase: finger contact impossible unless the object's wy span
    # can reach a finger surface (extrema in scalar slots 25/26); per block
    maybe = ((wyn <= k["surf_l0"] + ql + pr.lane(25))
             | (wyx >= k["surf_r0"] + qr + pr.lane(26)))
    any_f = maybe.any(dim=-1)                                   # (G',)

    geo = dict(rx=rx, ry=ry, rz=rz, wx=wx, wy=wy, wz=wz, w_np=w_np,
               tgt_p=tgt_p, me_p=me_p, vpx=vpx, vpy=vpy, vpz=vpz)
    lane = dict(ql=ql, qr=qr, qdl=qdl, qdr=qdr, mass=mass,
                fmass_l=fmass_l, fmass_r=fmass_r, inv_m=inv_m,
                inv_fml=inv_fml, inv_fmr=inv_fmr, mg_dt=mg_dt, iw=iw, w=w)
    u = [x.clone() for x in u_unc]
    iters = torch.zeros_like(px[:, :1])
    for take, solve in ((any_f, _full_solve), (~any_f, _cheap_solve)):
        rows = torch.nonzero(take).flatten()
        if rows.numel() == 0:
            continue
        sub = lambda x: x.index_select(0, rows)             # noqa: E731
        us, its = solve({a: sub(b) for a, b in geo.items()},
                        {a: (tuple(sub(x) for x in b)
                             if isinstance(b, tuple) else sub(b))
                         for a, b in lane.items()},
                        [sub(x) for x in u_unc], pr.select(rows), k)
        for a in range(8):
            u[a].index_copy_(0, rows, us[a])
        iters.index_copy_(0, rows, its)
    vx, vy, vz, ox, oy, oz, qdl, qdr = u
    mf = any_f.to(torch.float32)[:, None]
    cnt_f = cnt_f + mf
    cnt_c = cnt_c + (1.0 - mf)
    # the full-solve Newton iterations taken (cheap solves add 0)
    cnt_i = cnt_i + iters

    # integrate
    px = px + dt * vx
    py = py + dt * vy
    pz = pz + dt * vz
    dqw = 0.5 * (-ox * qx - oy * qy - oz * qz)
    dqx = 0.5 * (ox * qw + oy * qz - oz * qy)
    dqy = 0.5 * (-ox * qz + oy * qw + oz * qx)
    dqz = 0.5 * (ox * qy - oy * qx + oz * qw)
    qw = qw + dt * dqw
    qx = qx + dt * dqx
    qy = qy + dt * dqy
    qz = qz + dt * dqz
    qn = _rsqrt(qw * qw + qx * qx + qy * qy + qz * qz + 1e-12)
    qw, qx, qy, qz = qw * qn, qx * qn, qy * qn, qz * qn
    ql = ql + dt * qdl
    qr = qr + dt * qdr
    return (px, py, pz, qw, qx, qy, qz, vx, vy, vz,
            ox, oy, oz, ql, qr, qdl, qdr, wyn, wyx, cnt_f, cnt_c, cnt_i)


def _hub_sum(_rsum, vn, vt2, w, cap, tgt):
    res = torch.clamp(tgt - vn, min=0.0)
    e_n = 0.5 * w * res * res
    vt = torch.sqrt(vt2 + 1e-16)
    q_br = 0.5 * w * vt2
    lin = cap * vt - 0.5 * cap * cap / torch.clamp(w, min=1e-12)
    e_t = torch.where(w * vt <= cap, q_br, lin)
    return _rsum(e_n + e_t)


def _finger_geometry(geo, ln, pr: _Pairs, k):
    """Finger narrow phase of the rows' points (pallas3d.py:243-285): the
    two surface evaluations, the merged contact set (a point touches the
    deeper jaw), normals, contact frames, effective masses and the
    pre-update normal velocity, each (G', P, L)."""
    e = lambda x: x[:, None, :]                                 # noqa: E731
    rx, ry, rz = geo["rx"], geo["ry"], geo["rz"]
    wx, wy, wz = geo["wx"], geo["wy"], geo["wz"]
    vpx, vpy, vpz = geo["vpx"], geo["vpy"], geo["vpz"]
    we = [e(x) for x in ln["w"]]
    in_dom = ((wx >= k["x0f"]) & (wx <= k["x1f"]) & (wz >= k["z0f"])
              & (wz <= k["z1f"]))
    xc = torch.clamp(wx, k["x0f"], k["x1f"])
    zc = torch.clamp(wz, k["z0f"], k["z1f"])
    xsg = torch.clamp(((xc - k["x0f"]) * k["inv_hseg"]).to(torch.int32), 0,
                      N_SEG - 1)
    zsg = torch.clamp(((zc - k["z0f"]) * k["inv_hzseg"]).to(torch.int32), 0,
                      NZ_SEG - 1)
    seg = xsg * NZ_SEG + zsg
    t_loc = xc - (k["x0f"] + xsg.to(torch.float32) * k["hseg"])
    s_loc = zc - (k["z0f"] + zsg.to(torch.float32) * k["hzseg"])
    fl, slx, slz = _surface_eval(pr.coef[:, 0], seg, t_loc, s_loc)
    fr, srx, srz = _surface_eval(pr.coef[:, 1], seg, t_loc, s_loc)
    surf_l = k["surf_l0"] + e(ln["ql"]) + fl
    surf_r = k["surf_r0"] + e(ln["qr"]) + fr
    inv_nl = _rsqrt(1.0 + slx * slx + slz * slz)
    inv_nr = _rsqrt(1.0 + srx * srx + srz * srz)
    depth_l = (surf_l - wy) * inv_nl
    depth_r = (wy - surf_r) * inv_nr
    is_l = depth_l > depth_r
    depth_f = torch.where(is_l, depth_l, depth_r)
    nfx = torch.where(is_l, -slx * inv_nl, srx * inv_nr)
    nfy = torch.where(is_l, inv_nl, -inv_nr)
    nfz = torch.where(is_l, -slz * inv_nl, srz * inv_nr)
    act_f = ((depth_f > 0) & in_dom).to(torch.float32)
    cfx = ry * nfz - rz * nfy
    cfy = rz * nfx - rx * nfz
    cfz = rx * nfy - ry * nfx
    wfx, wfy, wfz = _symmul(we, cfx, cfy, cfz)
    ang_f = cfx * wfx + cfy * wfy + cfz * wfz
    inv_fm_pt = torch.where(is_l, e(ln["inv_fml"]), e(ln["inv_fmr"]))
    me_f = 1.0 / (e(ln["inv_m"]) + ang_f + nfy * nfy * inv_fm_pt)
    qd_c0 = torch.where(is_l, e(ln["qdl"]), e(ln["qdr"]))
    vn_f0 = vpx * nfx + (vpy - qd_c0) * nfy + vpz * nfz

    return dict(is_l=is_l, depth_f=depth_f, nfx=nfx, nfy=nfy, nfz=nfz,
                act_f=act_f, cfx=cfx, cfy=cfy, cfz=cfz, me_f=me_f,
                vn_f0=vn_f0)


def _full_solve(geo, ln, u_unc, pr: _Pairs, k):
    """Coupled semi-smooth Newton on the 8-DOF soft-constraint energy
    (pallas3d.py:497-737): u = (vx, vy, vz, ox, oy, oz, qdl, qdr), a fixed
    ``newton_iters`` iterations. -> (u, iterations taken a row, (G', 1))."""
    e = lambda x: x[:, None, :]                                 # noqa: E731
    _rsum = _rsum_of(k)
    rx, ry, rz = geo["rx"], geo["ry"], geo["rz"]
    w_np, tgt_pn = geo["w_np"], geo["tgt_p"]
    mass, fmass_l, fmass_r = ln["mass"], ln["fmass_l"], ln["fmass_r"]
    iw = ln["iw"]
    f = _finger_geometry(geo, ln, pr, k)
    is_l, depth_f, act_f, me_f, vn_f0 = (f[n] for n in (
        "is_l", "depth_f", "act_f", "me_f", "vn_f0"))
    nfx, nfy, nfz, cfx, cfy, cfz = (f[n] for n in (
        "nfx", "nfy", "nfz", "cfx", "cfy", "cfz"))

    b_cal, k_cal = pr.pt(15), pr.pt(14)
    tgt_fn = (1.0 - k["d_imp"] * b_cal * k["dt"]) * vn_f0 \
        + k["d_imp_dt"] * k_cal * depth_f \
        + pr.pt(27) * torch.clamp(-vn_f0 - k["v_rest"], min=0.0)
    w_nf = act_f * me_f / pr.pt(24)
    depth_eln = act_f * torch.clamp(depth_f, 0.0, k["depth_el_cap"])
    rough_capn = pr.pt(17) * me_f * depth_eln
    sl = is_l.to(torch.float32)
    sr = 1.0 - sl
    jf = (nfx, nfy, nfz, cfx, cfy, cfz, -nfy * sl, -nfy * sr)
    mu_finger, mu_plane, unload = pr.lane(13), pr.lane(12), pr.lane(16)

    def vrel_of(u_):
        u4 = [e(x) for x in u_]
        vpx_ = u4[0] + u4[4] * rz - u4[5] * ry
        vpy_ = u4[1] + u4[5] * rx - u4[3] * rz
        vpz_ = u4[2] + u4[3] * ry - u4[4] * rx
        qd_pt = u4[6] * sl + u4[7] * sr
        return vpx_, vpy_ - qd_pt, vpz_, vpy_

    def e_quad(u_):
        d = [u_[a] - u_unc[a] for a in range(8)]
        ix_, iy_, iz_ = _symmul(iw, d[3], d[4], d[5])
        return 0.5 * (
            mass * (d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
            + d[3] * ix_ + d[4] * iy_ + d[5] * iz_
            + fmass_l * (d[6] * d[6])
            + fmass_r * (d[7] * d[7]))

    def energy(u_, capf_, capp_):
        fx_, fy_, fz_, pvy_ = vrel_of(u_)
        vnf_ = fx_ * nfx + fy_ * nfy + fz_ * nfz
        a_, b_, c_ = fx_ - vnf_ * nfx, fy_ - vnf_ * nfy, fz_ - vnf_ * nfz
        vtf2 = a_ * a_ + b_ * b_ + c_ * c_
        vtp2 = fx_ * fx_ + pvy_ * pvy_
        return (e_quad(u_)
                + _hub_sum(_rsum, vnf_, vtf2, w_nf, capf_, tgt_fn)
                + _hub_sum(_rsum, fz_, vtp2, w_np, capp_, tgt_pn))

    def newton_body(u):
        fx_, fy_, fz_, pvy_ = vrel_of(u)
        vnf = fx_ * nfx + fy_ * nfy + fz_ * nfz
        vtfx = fx_ - vnf * nfx
        vtfy = fy_ - vnf * nfy
        vtfz = fz_ - vnf * nfz
        resf = torch.clamp(tgt_fn - vnf, min=0.0)
        lamf = w_nf * resf
        vtpx, vtpy = fx_, pvy_
        resp = torch.clamp(tgt_pn - fz_, min=0.0)
        lamp = w_np * resp
        grip = _rsum(lamf) / ln["mg_dt"]
        scale_p = 1.0 / (1.0 + unload * grip)
        capf = e(mu_finger) * lamf + rough_capn
        capp = e(mu_plane * scale_p) * lamp
        vtfn = torch.sqrt(vtfx * vtfx + vtfy * vtfy + vtfz * vtfz + 1e-16)
        vtpn = torch.sqrt(vtpx * vtpx + vtpy * vtpy + 1e-16)
        fac_f = torch.minimum(w_nf, capf / vtfn)
        fac_p = torch.minimum(w_np, capp / vtpn)

        ix_, iy_, iz_ = _symmul(iw, u[3] - u_unc[3], u[4] - u_unc[4],
                                u[5] - u_unc[5])
        g0 = mass * (u[0] - u_unc[0]) - _rsum(lamf * nfx) \
            + _rsum(fac_f * vtfx + fac_p * vtpx)
        g1 = mass * (u[1] - u_unc[1]) - _rsum(lamf * nfy) \
            + _rsum(fac_f * vtfy + fac_p * vtpy)
        g2 = mass * (u[2] - u_unc[2]) - _rsum(lamf * nfz + lamp) \
            + _rsum(fac_f * vtfz)
        g3 = ix_ - _rsum(lamf * cfx + lamp * ry) \
            + _rsum(fac_f * (ry * vtfz - rz * vtfy) + fac_p * (-rz * vtpy))
        g4 = iy_ - _rsum(lamf * cfy - lamp * rx) \
            + _rsum(fac_f * (rz * vtfx - rx * vtfz) + fac_p * (rz * vtpx))
        g5 = iz_ - _rsum(lamf * cfz) \
            + _rsum(fac_f * (rx * vtfy - ry * vtfx)
                    + fac_p * (rx * vtpy - ry * vtpx))
        g6 = fmass_l * (u[6] - u_unc[6]) \
            + _rsum(sl * (lamf * nfy - fac_f * vtfy))
        g7 = fmass_r * (u[7] - u_unc[7]) \
            + _rsum(sr * (lamf * nfy - fac_f * vtfy))
        grad = [g0, g1, g2, g3, g4, g5, g6, g7]

        # Hessian: M + on.J(x)J + fac.(G^T G - Jn(x)Jn), with the zero
        # structure of the Pallas kernel (h[6][7] is exactly 0)
        onf = w_nf * (resf > 0.0)
        onp = w_np * (resp > 0.0)
        cn_f = onf - fac_f
        cn_p = onp - fac_p
        yf = [cn_f * jf[a] for a in range(8)]
        h = [[None] * 8 for _ in range(8)]
        for a in range(8):
            for b_ in range(a, 8):
                h[a][b_] = (torch.zeros_like(g0) if (a, b_) == (6, 7)
                            else _rsum(yf[a] * jf[b_]))
        yp_n = cn_p * ry
        h[2][2] = h[2][2] + _rsum(cn_p)
        h[2][3] = h[2][3] + _rsum(yp_n)
        h[2][4] = h[2][4] + _rsum(-cn_p * rx)
        h[3][3] = h[3][3] + _rsum(yp_n * ry)
        h[3][4] = h[3][4] + _rsum(-yp_n * rx)
        h[4][4] = h[4][4] + _rsum(cn_p * rx * rx)
        facs = fac_f + fac_p
        s_facs = _rsum(facs)
        h[0][0] = h[0][0] + s_facs
        h[1][1] = h[1][1] + s_facs
        h[2][2] = h[2][2] + s_facs
        h[0][4] = h[0][4] + _rsum(facs * rz)
        h[0][5] = h[0][5] + _rsum(facs * (-ry))
        h[1][3] = h[1][3] + _rsum(facs * (-rz))
        h[1][5] = h[1][5] + _rsum(facs * rx)
        h[2][3] = h[2][3] + _rsum(facs * ry)
        h[2][4] = h[2][4] + _rsum(facs * (-rx))
        h[3][3] = h[3][3] + _rsum(facs * (ry * ry + rz * rz))
        h[4][4] = h[4][4] + _rsum(facs * (rx * rx + rz * rz))
        h[5][5] = h[5][5] + _rsum(facs * (rx * rx + ry * ry))
        h[3][4] = h[3][4] + _rsum(facs * (-rx * ry))
        h[3][5] = h[3][5] + _rsum(facs * (-rx * rz))
        h[4][5] = h[4][5] + _rsum(facs * (-ry * rz))
        h[1][6] = h[1][6] + _rsum(fac_f * (-sl))
        h[1][7] = h[1][7] + _rsum(fac_f * (-sr))
        h[3][6] = h[3][6] + _rsum(fac_f * sl * rz)
        h[5][6] = h[5][6] + _rsum(fac_f * sl * (-rx))
        h[3][7] = h[3][7] + _rsum(fac_f * sr * rz)
        h[5][7] = h[5][7] + _rsum(fac_f * sr * (-rx))
        h[6][6] = h[6][6] + _rsum(fac_f * sl)
        h[7][7] = h[7][7] + _rsum(fac_f * sr)
        # mass block
        h[0][0] = h[0][0] + mass
        h[1][1] = h[1][1] + mass
        h[2][2] = h[2][2] + mass
        h[3][3] = h[3][3] + iw[0]
        h[4][4] = h[4][4] + iw[3]
        h[5][5] = h[5][5] + iw[5]
        h[3][4] = h[3][4] + iw[1]
        h[3][5] = h[3][5] + iw[2]
        h[4][5] = h[4][5] + iw[4]
        h[6][6] = h[6][6] + fmass_l
        h[7][7] = h[7][7] + fmass_r

        dv = _cholesky_solve(h, grad, 8)
        u1 = [u[a] + dv[a] for a in range(8)]
        u2 = [u[a] + 0.5 * dv[a] for a in range(8)]
        e0, e1, e2 = (energy(v, capf, capp) for v in (u, u1, u2))
        return _line_search(u, u1, u2, e0, e1, e2)

    u = list(u_unc)
    n_it = k["newton_iters"]
    for _it in range(n_it):
        u = newton_body(u)
    return u, torch.full_like(u[0][:, :1], float(n_it))


def _cheap_solve(geo, ln, u_unc, pr: _Pairs, k):
    """No finger contact reachable in the block: Newton on the 6-DOF plane
    subproblem (pallas3d.py:739-859); the finger DOFs keep their
    unconstrained servo update."""
    e = lambda x: x[:, None, :]                                 # noqa: E731
    _rsum = _rsum_of(k)
    rx, ry, rz = geo["rx"], geo["ry"], geo["rz"]
    w_np, tgt_pn = geo["w_np"], geo["tgt_p"]
    mass, iw = ln["mass"], ln["iw"]
    mu_plane = e(pr.lane(12))

    def vel(u_):
        u4 = [e(x) for x in u_]
        return (u4[0] + u4[4] * rz - u4[5] * ry,
                u4[1] + u4[5] * rx - u4[3] * rz,
                u4[2] + u4[3] * ry - u4[4] * rx)

    def e_cheap(u_, capp_):
        vpx_, vpy_, vpz_ = vel(u_)
        res_ = torch.clamp(tgt_pn - vpz_, min=0.0)
        vt2_ = vpx_ * vpx_ + vpy_ * vpy_
        en = _rsum(0.5 * w_np * res_ * res_)
        vt_ = torch.sqrt(vt2_ + 1e-16)
        q_ = 0.5 * w_np * vt2_
        lin = capp_ * vt_ - 0.5 * capp_ * capp_ / torch.clamp(w_np, min=1e-12)
        en = en + _rsum(torch.where(w_np * vt_ <= capp_, q_, lin))
        d = [u_[a] - u_unc[a] for a in range(6)]
        ix2, iy2, iz2 = _symmul(iw, d[3], d[4], d[5])
        return en + 0.5 * (
            mass * (d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
            + d[3] * ix2 + d[4] * iy2 + d[5] * iz2)

    u = list(u_unc)
    zero = torch.zeros_like(u[0])
    for _it in range(CHEAP_ITERS):
        vpx, vpy, vpz = vel(u)
        resp = torch.clamp(tgt_pn - vpz, min=0.0)
        lamp = w_np * resp
        capp = mu_plane * lamp
        vtpn = torch.sqrt(vpx * vpx + vpy * vpy + 1e-16)
        fac_p = torch.minimum(w_np, capp / vtpn)
        ix_, iy_, iz_ = _symmul(iw, u[3] - u_unc[3], u[4] - u_unc[4],
                                u[5] - u_unc[5])
        fx_, fy_ = fac_p * vpx, fac_p * vpy
        g0 = mass * (u[0] - u_unc[0]) + _rsum(fx_)
        g1 = mass * (u[1] - u_unc[1]) + _rsum(fy_)
        g2 = mass * (u[2] - u_unc[2]) - _rsum(lamp)
        g3 = ix_ - _rsum(lamp * ry) + _rsum(-rz * fy_)
        g4 = iy_ + _rsum(lamp * rx) + _rsum(rz * fx_)
        g5 = iz_ + _rsum(rx * fy_ - ry * fx_)
        onp = w_np * (resp > 0.0)
        cn_p = onp - fac_p
        # only the plane rows {2, 3, 4} survive in the normal block
        h = [[zero] * 6 for _ in range(6)]
        yp_n = cn_p * ry
        h[2][2] = _rsum(cn_p)
        h[2][3] = _rsum(yp_n)
        h[2][4] = _rsum(-cn_p * rx)
        h[3][3] = _rsum(yp_n * ry)
        h[3][4] = _rsum(-yp_n * rx)
        h[4][4] = _rsum(cn_p * rx * rx)
        s_fac = _rsum(fac_p)
        h[0][0] = s_fac + mass
        h[1][1] = s_fac + mass
        h[2][2] = h[2][2] + (s_fac + mass)
        h[0][4] = _rsum(fac_p * rz)
        h[0][5] = _rsum(fac_p * (-ry))
        h[1][3] = _rsum(fac_p * (-rz))
        h[1][5] = _rsum(fac_p * rx)
        h[2][3] = h[2][3] + _rsum(fac_p * ry)
        h[2][4] = h[2][4] + _rsum(fac_p * (-rx))
        h[3][3] = h[3][3] + (_rsum(fac_p * (ry * ry + rz * rz)) + iw[0])
        h[4][4] = h[4][4] + (_rsum(fac_p * (rx * rx + rz * rz)) + iw[3])
        h[5][5] = _rsum(fac_p * (rx * rx + ry * ry)) + iw[5]
        h[3][4] = h[3][4] + (_rsum(fac_p * (-rx * ry)) + iw[1])
        h[3][5] = _rsum(fac_p * (-rx * rz)) + iw[2]
        h[4][5] = _rsum(fac_p * (-ry * rz)) + iw[4]
        dv = _cholesky_solve(h, [g0, g1, g2, g3, g4, g5], 6)
        u1 = [u[a] + dv[a] for a in range(6)] + u[6:]
        u2 = [u[a] + 0.5 * dv[a] for a in range(6)] + u[6:]
        u = _line_search(u, u1, u2, e_cheap(u, capp), e_cheap(u1, capp),
                         e_cheap(u2, capp))
    return u, torch.zeros_like(u[0][:, :1])


def profile_batch_ref(
    coefs: torch.Tensor,      # (B, 2, TOT_SEG, 4, 3)
    points: torch.Tensor,     # (B, P, 4)
    scalars: torch.Tensor,    # (B, 1, 32)
    poses: torch.Tensor,      # (N, 3), N % LANE == 0
    steps: int = SIM.steps_3d,
    regrasp_every: int = 0,
    snapshot_step: int = 0,
    sum_group: int = 0,
    newton_iters: int = NEWTON_KERNEL_ITERS3,
) -> Tuple[torch.Tensor, ...]:
    """Returns the 12 raw (B, N) float32 outputs of the kernel (OUT_NAMES):
    final qw, qz, origin dx, dy; validity (1.0 / 0.0); snapshot qw, qz, dx,
    dy; per-block full-solve, cheap-solve and full-solve Newton iteration
    counts. ``sum_group`` = G adds the point sums in the order of the CUDA
    kernel with G threads a rollout (0: ``torch.sum``'s own;
    ``point_sum``); ``newton_iters``: the full solve's Newton iterations a
    step."""
    k = dict(constants(), sum_group=sum_group,
             newton_iters=int(newton_iters))
    dt = k["dt"]
    b = points.shape[0]
    n = poses.shape[0]
    if n % LANE:
        raise ValueError(f"pose count {n} must be a multiple of {LANE}")
    nb = n // LANE
    dev = poses.device
    rows_all = torch.arange(b, device=dev).repeat_interleave(nb)  # (G,)
    pr_all = _Pairs.build(coefs, points, scalars, rows_all)
    com_x, com_y, com_z = pr_all.lane(2), pr_all.lane(3), pr_all.lane(4)
    fmass_l, fmass_r = pr_all.lane(1), pr_all.lane(11)
    inv_fml, inv_fmr = 1.0 / fmass_l, 1.0 / fmass_r

    pose_x = poses[:, 0].reshape(nb, LANE).repeat(b, 1)         # (G, L)
    pose_y = poses[:, 1].reshape(nb, LANE).repeat(b, 1)
    theta0 = poses[:, 2].reshape(nb, LANE).repeat(b, 1)
    half = theta0 * 0.5
    qw0, qz0 = torch.cos(half), torch.sin(half)
    zero = torch.zeros_like(pose_x)
    c0, s0 = torch.cos(theta0), torch.sin(theta0)
    px = pose_x + c0 * com_x - s0 * com_y
    py = pose_y + s0 * com_x + c0 * com_y
    pz = zero + com_z

    st = [px, py, pz, qw0, zero, zero, qz0, zero, zero, zero, zero, zero,
          zero, zero, zero, zero, zero, zero - 1e9, zero - 1e9, zero, zero,
          zero]
    snap = [px, py, qw0, qz0]

    for i in range(steps):
        (px, py, pz, qw, qx, qy, qz, vx, vy, vz, ox, oy, oz, ql, qr, qdl,
         qdr, wyn, wyx, cnt_f, cnt_c, cnt_i) = st
        if regrasp_every and i % regrasp_every == 0 and i > 0:
            # zero jaws and velocities without a solve confirming
            # equilibrium: invalidate the travel cache
            ql = qr = qdl = qdr = zero
            vx = vy = vz = ox = oy = oz = zero
            wyn = zero - 1e9
        mot = torch.maximum(torch.maximum(torch.abs(vx), torch.abs(vy)),
                            torch.abs(vz))
        mot = torch.maximum(mot, torch.maximum(torch.maximum(
            torch.abs(ox), torch.abs(oy)), torch.abs(oz)))
        settled = mot.amax(dim=-1) < k["eps_settled"]            # (G,)
        f_l = k["kp"] * (k["ctrl_l"] - ql) - k["damping"] * qdl
        f_r = k["kp"] * (k["ctrl_r"] - qr) - k["damping"] * qdr
        ql_n = ql + dt * (qdl + dt * f_l * inv_fml)
        qr_n = qr + dt * (qdr + dt * f_r * inv_fmr)
        maybe = ((wyn - k["marg"] <= k["surf_l0"] + torch.maximum(ql, ql_n)
                  + pr_all.lane(25))
                 | (wyx + k["marg"] >= k["surf_r0"] + torch.minimum(qr, qr_n)
                    + pr_all.lane(26)))
        travel = settled & ~maybe.any(dim=-1)

        # settled travel: only the finger servos advance
        qdl_t = qdl + dt * f_l * inv_fml
        qdr_t = qdr + dt * f_r * inv_fmr
        st = [px, py, pz, qw, qx, qy, qz, vx, vy, vz, ox, oy, oz,
              ql + dt * qdl_t, qr + dt * qdr_t, qdl_t, qdr_t, wyn, wyx,
              cnt_f, cnt_c, cnt_i]
        rows = torch.nonzero(~travel).flatten()
        if rows.numel():
            cur = (px, py, pz, qw, qx, qy, qz, vx, vy, vz, ox, oy, oz, ql, qr,
                   qdl, qdr, wyn, wyx, cnt_f, cnt_c, cnt_i)
            new = _normal_step(tuple(x.index_select(0, rows) for x in cur),
                               pr_all.select(rows), k)
            st = [s_.index_copy(0, rows, n_) for s_, n_ in zip(st, new)]
        if i + 1 == snapshot_step:
            snap = [st[0], st[1], st[3], st[6]]

    (px, py, pz, qw, qx, qy, qz, *_rest) = st
    cnt_f, cnt_c, cnt_i = st[19], st[20], st[21]
    if snapshot_step <= 0 or snapshot_step >= steps:
        snap = [px, py, qw, qz]
    spx, spy, sqw, sqz = snap

    # readout (the angle's atan2 happens outside, in rollout3d.profile_batch)
    r00, r01, r02, r10, r11, r12 = _rotation(qw, qx, qy, qz)[:6]
    org_x = px - (r00 * com_x + r01 * com_y + r02 * com_z)
    org_y = py - (r10 * com_x + r11 * com_y + r12 * com_z)
    valid = (torch.abs(qx) < k["tip_atol"]) & (torch.abs(qy) < k["tip_atol"])
    sc = 1 - 2 * sqz * sqz
    ss = 2 * sqw * sqz
    sorg_x = spx - (sc * com_x - ss * com_y)
    sorg_y = spy - (ss * com_x + sc * com_y)
    outs = (qw, qz, org_x - pose_x, org_y - pose_y, valid.to(torch.float32),
            sqw, sqz, sorg_x - pose_x, sorg_y - pose_y, cnt_f, cnt_c, cnt_i)
    return tuple(o.reshape(b, n) for o in outs)


def readout(qw, qz, dpx, dpy, valid, sqw, sqz, sdx, sdy, poses):
    """The Pallas wrapper's readout (pallas3d.py:1103-1122): snapshot dtheta
    wrapped to +-pi, snapshot dpos (B, N, 2), final theta in [0, 2 pi),
    validity (bool), final dpos (B, N, 2)."""
    two_pi = 2.0 * math.pi
    theta0 = torch.remainder(poses[:, 2], two_pi)[None, :]
    theta_s = torch.remainder(2.0 * torch.atan2(sqz, sqw), two_pi)
    dth = theta_s - theta0
    dth = dth - two_pi * torch.round(dth / two_pi)
    theta_f = torch.remainder(2.0 * torch.atan2(qz, qw), two_pi)
    return (dth, torch.stack([sdx, sdy], dim=-1), theta_f, valid > 0.5,
            torch.stack([dpx, dpy], dim=-1))
