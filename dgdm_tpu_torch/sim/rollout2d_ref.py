"""Plain PyTorch version of the 2D rollout kernel (K1) — the same math as
``dgdm_tpu/sim/pallas2d.py:_rollout_kernel``, both contact solvers (the
coupled Newton solve, and ``solver="jacobi"``: projected Jacobi with the
explicit elastic wedge impulse, ``pallas2d.py:221-334``), on dense tensors,
with a Python step loop.

Layout: lanes are poses, grouped in blocks of ``LANE`` = 128 exactly as the
Pallas grid groups them. Per-lane state is (B, NB, L); per-contour-point
work is (B, NB, P, L); plane-support work is (B, NB, S, L). The two
block-uniform branches of the Pallas kernel (settled travel vs a normal
step; full vs cheap solve, Newton only: every normal Jacobi step is a full
solve) are decided per (pair, 128-pose block) with the
same reductions, and applied with ``torch.where``: a block's lanes take one
branch together, so a lane's result depends on its block-mates exactly as in
the TPU kernel and in ``csrc/rollout2d.cu``.

On the CPU this is the port's rollout path. On the card it serves the tests
and ``chip_smoke.py`` as the reference the CUDA kernel is held to. Every
expression keeps the Pallas kernel's operand order; ``rsqrt`` is spelled
``1 / sqrt`` so that the CPU and the card round it alike. Sums over contour
and support points accumulate in float64 and round once to float32 — here
and in the kernel (``sim/point_sum.py``) — so that they do not depend on
the order of the reduction in all but rare cases, and ``sum_group=G``
reproduces the order of the kernel with G threads a rollout exactly: the
squeeze is chaotic enough that reordered float32 sums move ~1% of the full
9,000-pose grid's lanes by more than 1e-3 rad after 200 steps (measured on
the H100). State and elementwise physics stay float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dgdm_tpu_torch.core.config import GRIPPER_2D, SIM
from dgdm_tpu_torch.sim import engine2d
from dgdm_tpu_torch.sim.engine2d import (
    B_CONTACT,
    B_PLANE,
    DEPTH_EL_CAP,
    IMPEDANCE,
    K_CONTACT,
    K_PLANE,
    NEWTON_ITERS,
    ROUGH_SAT,
    SOLVER_ITERS,
)
from dgdm_tpu_torch.sim.point_sum import point_sum

LANE = 128
# settled-travel fast-path gate: post-solve velocity magnitude below which
# the object counts as statically supported (pallas2d.EPS_SETTLED)
EPS_SETTLED = 1e-4
# number of per-pair scalar slots (layout: rollout2d.scene_arrays)
N_SCALARS = 16


def _rsqrt(x):
    return 1.0 / torch.sqrt(x)


def _block_any(mask: torch.Tensor) -> torch.Tensor:
    """(B, NB, L) bool -> (B, NB, 1): does any lane of the block hold it."""
    return mask.any(dim=-1, keepdim=True)


def resolve_solver(solver: Optional[str]) -> str:
    """``solver`` or, when None, ``engine2d.SOLVER`` at call time (as
    ``pallas2d.profile_batch_pallas`` resolves it); an unknown one raises."""
    if solver is None:
        solver = engine2d.SOLVER
    if solver not in engine2d.SOLVERS:
        raise ValueError(f"unknown contact solver {solver!r}; one of "
                         f"{engine2d.SOLVERS}")
    return solver


def _hub(v, w, cap):
    q = 0.5 * w * v * v
    lin = cap * torch.abs(v) - 0.5 * cap * cap / torch.clamp(w, min=1e-12)
    return torch.where(w * torch.abs(v) <= cap, q, lin)


def profile_batch_ref(
    coefs: torch.Tensor,      # (B, 2, 6, 4)
    contour: torch.Tensor,    # (B, P, 2)
    support: torch.Tensor,    # (B, S, 4): x, y, weight, pad
    scalars: torch.Tensor,    # (B, 1, 16)
    poses: torch.Tensor,      # (N, 3), N % LANE == 0
    steps: int = SIM.steps_2d,
    regrasp_every: int = 0,
    snapshot_step: int = 0,
    sum_group: int = 0,
    solver: Optional[str] = None,
) -> Tuple[torch.Tensor, ...]:
    """Returns 9 (B, N) float32 tensors: dtheta, dpx, dpy at the snapshot;
    final theta (in [0, 2pi)), final origin x, y; the per-block full and
    cheap solve step counts (lane-broadcast); and each rollout's contour
    points in contact (act) summed over its block's full solves (Newton) or
    its solves (Jacobi). ``sum_group`` = G adds the
    point sums in the order of the CUDA kernel with G threads a rollout (0:
    ``torch.sum``'s own; ``point_sum``). ``solver``: "newton" or "jacobi",
    None for ``engine2d.SOLVER``."""
    solver = resolve_solver(solver)
    g = GRIPPER_2D
    dt = SIM.dt
    x0f, x1f = g.ctrl_x_min, g.ctrl_x_max
    h = (x1f - x0f) / (g.num_ctrl - 1)
    b, p = contour.shape[0], contour.shape[1]
    n = poses.shape[0]
    if n % LANE:
        raise ValueError(f"pose count {n} must be a multiple of {LANE}")
    nb = n // LANE

    def lane_s(k):      # pair scalar broadcast against (B, NB, L)
        return scalars[:, 0, k].reshape(b, 1, 1)

    def pt_s(k):        # pair scalar broadcast against (B, NB, P|S, L)
        return scalars[:, 0, k].reshape(b, 1, 1, 1)

    mass, inertia = lane_s(0), lane_s(1)
    fmass_l, fmass_r = lane_s(2), lane_s(5)
    com_bx, com_by = lane_s(3), lane_s(4)
    inv_m, inv_i = 1.0 / mass, 1.0 / inertia
    inv_fml, inv_fmr = 1.0 / fmass_l, 1.0 / fmass_r
    broad_a, broad_b = lane_s(14), lane_s(15)
    # point-shaped copies of the pair scalars the (P, L) math reads
    m4, i4 = pt_s(0), pt_s(1)
    inv_m4, inv_i4 = 1.0 / m4, 1.0 / i4
    inv_fml4, inv_fmr4 = 1.0 / pt_s(2), 1.0 / pt_s(5)
    mu_plane, mu_finger, mu_torsion = pt_s(6), pt_s(7), pt_s(8)
    k_con, b_con, unload, rough, c_r2 = (pt_s(9), pt_s(10), pt_s(11),
                                         pt_s(12), pt_s(13))
    mu_torsion_l, unload_l, c_r2_l = lane_s(8), lane_s(11), lane_s(13)

    # body-frame contour/support relative to the COM: (B, 1, P|S, 1)
    cbx = (contour[:, :, 0] - scalars[:, 0, 3:4]).reshape(b, 1, p, 1)
    cby = (contour[:, :, 1] - scalars[:, 0, 4:5]).reshape(b, 1, p, 1)
    s_ = support.shape[1]
    sbx = (support[:, :, 0] - scalars[:, 0, 3:4]).reshape(b, 1, s_, 1)
    sby = (support[:, :, 1] - scalars[:, 0, 4:5]).reshape(b, 1, s_, 1)
    sw = support[:, :, 2].reshape(b, 1, s_, 1)
    coef_flat = coefs.reshape(b, 2, 6, 4)

    pose_x = poses[:, 0].reshape(1, nb, LANE)
    pose_y = poses[:, 1].reshape(1, nb, LANE)
    theta0 = poses[:, 2].reshape(1, nb, LANE)

    c0, s0 = torch.cos(theta0), torch.sin(theta0)
    com_x = pose_x + c0 * com_bx - s0 * com_by          # (B, NB, L)
    com_y = pose_y + s0 * com_bx + c0 * com_by
    zero = torch.zeros_like(com_x)

    cx, cy, th = com_x, com_y, theta0 + zero
    vx, vy, om, zb, vz = zero, zero, zero, zero, zero
    ql, qr, qdl, qdr = zero, zero, zero, zero
    cnt_f, cnt_c, cnt_a = zero, zero, zero
    scx, scy, sth = com_x + zero, com_y + zero, theta0 + zero

    ctrl_l = min(SIM.ctrl_2d, g.ctrl_clamped)
    ctrl_r = -ctrl_l
    # a float32 scalar, so that d_imp * dt rounds as in the TPU kernel
    d_imp = torch.tensor(IMPEDANCE, dtype=torch.float32, device=poses.device)

    def rsum(x):
        # over contour or support points: accumulated in float64, rounded
        # once, in the order that sum_group names
        return point_sum(x, dim=2, group=sum_group)

    def seg_coefs(fi, seg):
        """c0..c3 of finger ``fi`` at segment indices seg (B, NB, P, L)."""
        idx = seg.reshape(b, -1).long()
        return [torch.gather(coef_flat[:, fi, :, k], 1, idx).reshape(seg.shape)
                for k in range(4)]

    def contact_geometry(cx, cy, c, s, ql, qr, vx, vy, om, qdl, qdr):
        c, s = c[:, :, None], s[:, :, None]
        rx = cbx * c - cby * s                          # (B, NB, P, L)
        ry = cbx * s + cby * c
        px = cx[:, :, None] + rx
        py = cy[:, :, None] + ry
        x_in = (px >= x0f) & (px <= x1f)
        xc = torch.clamp(px, x0f, x1f)
        seg = torch.clamp(((xc - x0f) * (1.0 / h)).to(torch.int32), 0,
                          g.num_ctrl - 2)
        t_loc = xc - (x0f + seg.to(torch.float32) * h)
        f_val, d_val = [], []
        for fi in range(2):
            c0_, c1, c2, c3 = seg_coefs(fi, seg)
            f_val.append(((c3 * t_loc + c2) * t_loc + c1) * t_loc + c0_)
            d_val.append((3.0 * c3 * t_loc + 2.0 * c2) * t_loc + c1)
        surf_l = (-g.jaw_offset + g.width) + ql[:, :, None] + f_val[0]
        surf_r = g.jaw_offset + qr[:, :, None] + f_val[1]
        inv_l = _rsqrt(1.0 + d_val[0] * d_val[0])
        inv_r = _rsqrt(1.0 + d_val[1] * d_val[1])
        depth_l = (surf_l - py) * inv_l
        depth_r = (py - surf_r) * inv_r
        is_l = depth_l > depth_r
        depth = torch.where(is_l, depth_l, depth_r)
        nx = torch.where(is_l, -d_val[0] * inv_l, d_val[1] * inv_r)
        ny = torch.where(is_l, inv_l, -inv_r)
        act = ((depth > 0.0) & x_in).to(torch.float32)
        rxn = rx * ny - ry * nx
        tx_, ty_ = -ny, nx
        rxt = rx * ty_ - ry * tx_
        inv_fm_pt = torch.where(is_l, inv_fml4, inv_fmr4)
        me_n = 1.0 / (inv_m4 + rxn * rxn * inv_i4 + ny * ny * inv_fm_pt)
        me_t = 1.0 / (inv_m4 + rxt * rxt * inv_i4 + ty_ * ty_ * inv_fm_pt)
        qd_c0 = torch.where(is_l, qdl[:, :, None], qdr[:, :, None])
        vn0 = ((vx[:, :, None] - om[:, :, None] * ry) * nx
               + (vy[:, :, None] + om[:, :, None] * rx - qd_c0) * ny)
        return (rx, ry, is_l, depth, nx, ny, act, rxn, tx_, ty_, rxt,
                me_n, me_t, vn0)

    def normal_step(cx, cy, th, vx, vy, om, zb, vz, ql, qr, qdl, qdr,
                    cnt_f, cnt_c, cnt_a):
        c, s = torch.cos(th), torch.sin(th)
        depth_z = SIM.plane_z - zb
        n_total = mass * torch.clamp(K_PLANE * depth_z - B_PLANE * vz, min=0.0)
        c4, s4 = c[:, :, None], s[:, :, None]
        rsx = sbx * c4 - sby * s4                       # (B, NB, S, L)
        rsy = sbx * s4 + sby * c4
        a_s = inv_m4 + (rsx * rsx + rsy * rsy) * inv_i4 * 0.5
        w_s = 1.0 / (c_r2 * a_s)
        w_w = inertia / c_r2_l
        mg_dt = mass * SIM.gravity * dt
        nt4 = n_total[:, :, None]

        f_l = g.kp * (ctrl_l - ql) - g.joint_damping * qdl
        f_r = g.kp * (ctrl_r - qr) - g.joint_damping * qdr
        vz = vz + dt * (-SIM.gravity + n_total * inv_m)
        u_unc = [vx, vy, om, qdl + dt * f_l * inv_fml,
                 qdr + dt * f_r * inv_fmr]

        def full_solve():
            (rx, ry, is_l, depth, nx, ny, act, rxn, tx_, ty_, rxt,
             me_n, me_t, vn0) = contact_geometry(cx, cy, c, s, ql, qr,
                                                 vx, vy, om, qdl, qdr)
            sl = is_l.to(torch.float32)
            sr = 1.0 - sl
            tgt_n = (1.0 - d_imp * b_con * dt) * vn0 \
                + d_imp * dt * k_con * depth
            w_nn = act * me_n / c_r2
            w_tt = act * me_t / c_r2
            depth_el = act * torch.clamp(depth, 0.0, DEPTH_EL_CAP)
            cap_rough = rough * me_t * depth_el
            jn = (nx, ny, rxn, -ny * sl, -ny * sr)
            jt = (tx_, ty_, rxt, -ty_ * sl, -ty_ * sr)

            def vels_of(u_):
                u4 = [x[:, :, None] for x in u_]
                qd_cc = u4[3] * sl + u4[4] * sr
                vpx = u4[0] - u4[2] * ry
                vpy = u4[1] + u4[2] * rx - qd_cc
                vn_ = vpx * nx + vpy * ny
                vt_ = vpx * tx_ + vpy * ty_
                vsx_ = u4[0] - u4[2] * rsy
                vsy_ = u4[1] + u4[2] * rsx
                return vn_, vt_, vsx_, vsy_

            def caps_of(u_):
                vn_, _, _, _ = vels_of(u_)
                lam_ = w_nn * torch.clamp(tgt_n - vn_, min=0.0)
                grip = rsum(lam_) / mg_dt
                n_i_ = sw * nt4 / (1.0 + unload_l[:, :, None]
                                   * grip[:, :, None])
                cap_t_ = mu_finger * lam_ + cap_rough
                cap_s_ = mu_plane * n_i_ * dt
                cap_w_ = mu_torsion_l * rsum(n_i_) * dt
                return lam_, cap_t_, cap_s_, cap_w_

            def energy(u_, cap_t_, cap_s_, cap_w_):
                vn_, vt_, vsx_, vsy_ = vels_of(u_)
                res = torch.clamp(tgt_n - vn_, min=0.0)
                e_n = rsum(0.5 * w_nn * res * res + _hub(vt_, w_tt, cap_t_))
                vs_ = torch.sqrt(vsx_ * vsx_ + vsy_ * vsy_ + 1e-16)
                e_s = rsum(_hub(vs_, w_s, cap_s_))
                e_w = _hub(u_[2], w_w, cap_w_)
                d = [u_[a] - u_unc[a] for a in range(5)]
                e_u = 0.5 * (
                    mass * (d[0] * d[0] + d[1] * d[1])
                    + inertia * (d[2] * d[2])
                    + fmass_l * (d[3] * d[3])
                    + fmass_r * (d[4] * d[4])
                )
                return e_u + e_n + e_s + e_w

            mdiag = (mass, mass, inertia, fmass_l, fmass_r)
            u = list(u_unc)
            for _it in range(NEWTON_ITERS):
                lam_nn, cap_t, cap_s, cap_w = caps_of(u)
                vn_, vt_, vsx_, vsy_ = vels_of(u)
                res = torch.clamp(tgt_n - vn_, min=0.0)
                f_t = torch.clamp(w_tt * vt_, -cap_t, cap_t)
                vs_ = torch.sqrt(vsx_ * vsx_ + vsy_ * vsy_ + 1e-16)
                fac_s = torch.minimum(w_s, cap_s / vs_)
                f_w = torch.clamp(w_w * u[2], -cap_w, cap_w)
                fx_, fy_ = fac_s * vsx_, fac_s * vsy_
                grad = [
                    mass * (u[0] - u_unc[0]) - rsum(lam_nn * nx)
                    + rsum(f_t * tx_) + rsum(fx_),
                    mass * (u[1] - u_unc[1]) - rsum(lam_nn * ny)
                    + rsum(f_t * ty_) + rsum(fy_),
                    inertia * (u[2] - u_unc[2]) - rsum(lam_nn * rxn)
                    + rsum(f_t * rxt)
                    + rsum(rsx * fy_ - rsy * fx_) + f_w,
                    fmass_l * (u[3] - u_unc[3])
                    + rsum(sl * (lam_nn * ny - f_t * ty_)),
                    fmass_r * (u[4] - u_unc[4])
                    + rsum(sr * (lam_nn * ny - f_t * ty_)),
                ]
                on_n = w_nn * (res > 0.0)
                on_t = w_tt * (torch.abs(w_tt * vt_) <= cap_t)
                yn = [on_n * jn[a] for a in range(5)]
                yt = [on_t * jt[a] for a in range(5)]
                hm = [[None] * 5 for _ in range(5)]
                for a in range(5):
                    for b_ in range(a, 5):
                        if (a, b_) == (3, 4):
                            hm[a][b_] = 0.0
                        else:
                            hm[a][b_] = rsum(yn[a] * jn[b_] + yt[a] * jt[b_])
                sfac = rsum(fac_s)
                hm[0][0] = hm[0][0] + (sfac + mdiag[0])
                hm[1][1] = hm[1][1] + (sfac + mdiag[1])
                hm[0][2] = hm[0][2] + rsum(fac_s * (-rsy))
                hm[1][2] = hm[1][2] + rsum(fac_s * rsx)
                hm[2][2] = hm[2][2] + (
                    rsum(fac_s * (rsx * rsx + rsy * rsy))
                    + w_w * (torch.abs(w_w * u[2]) <= cap_w) + mdiag[2])
                hm[3][3] = hm[3][3] + mdiag[3]
                hm[4][4] = hm[4][4] + mdiag[4]

                # unrolled 5x5 Cholesky solve of H d = -grad
                L = [[None] * 5 for _ in range(5)]
                Ld = [None] * 5
                for a in range(5):
                    s_a = hm[a][a]
                    for k in range(a):
                        s_a = s_a - L[a][k] * L[a][k]
                    dinv = _rsqrt(torch.clamp(s_a, min=1e-12))
                    Ld[a] = dinv
                    for b_ in range(a + 1, 5):
                        s2 = hm[a][b_]
                        for k in range(a):
                            s2 = s2 - L[b_][k] * L[a][k]
                        L[b_][a] = s2 * dinv
                yv = [None] * 5
                for a in range(5):
                    s_a = -grad[a]
                    for k in range(a):
                        s_a = s_a - L[a][k] * yv[k]
                    yv[a] = s_a * Ld[a]
                dv = [None] * 5
                for a in range(4, -1, -1):
                    s_a = yv[a]
                    for k in range(a + 1, 5):
                        s_a = s_a - L[k][a] * dv[k]
                    dv[a] = s_a * Ld[a]

                u1 = [u[a] + dv[a] for a in range(5)]
                u2 = [u[a] + 0.5 * dv[a] for a in range(5)]
                e0 = energy(u, cap_t, cap_s, cap_w)
                e1 = energy(u1, cap_t, cap_s, cap_w)
                e2 = energy(u2, cap_t, cap_s, cap_w)
                best12 = e1 <= e2
                eb = torch.where(best12, e1, e2)
                take_new = eb <= e0
                u = [torch.where(take_new,
                                 torch.where(best12, u1[a], u2[a]), u[a])
                     for a in range(5)]
            return u, rsum(act)

        def cheap_solve():
            # no finger contact anywhere in the block: plane friction +
            # torsion only, 2 Newton iterations on the 3-DOF subproblem
            u = list(u_unc)
            n_i_ = sw * nt4
            cap_s_ = mu_plane * n_i_ * dt
            cap_w_ = mu_torsion_l * rsum(n_i_) * dt

            def e_cheap(u_):
                vsx_ = u_[0][:, :, None] - u_[2][:, :, None] * rsy
                vsy_ = u_[1][:, :, None] + u_[2][:, :, None] * rsx
                vs_ = torch.sqrt(vsx_ * vsx_ + vsy_ * vsy_ + 1e-16)
                q_ = 0.5 * w_s * vs_ * vs_
                lin = cap_s_ * vs_ \
                    - 0.5 * cap_s_ * cap_s_ / torch.clamp(w_s, min=1e-12)
                e = rsum(torch.where(w_s * vs_ <= cap_s_, q_, lin))
                qw_ = 0.5 * w_w * u_[2] * u_[2]
                linw = cap_w_ * torch.abs(u_[2]) \
                    - 0.5 * cap_w_ * cap_w_ / torch.clamp(w_w, min=1e-12)
                e = e + torch.where(w_w * torch.abs(u_[2]) <= cap_w_, qw_,
                                    linw)
                d = [u_[a] - u_unc[a] for a in range(3)]
                return e + 0.5 * (
                    mass * (d[0] * d[0] + d[1] * d[1])
                    + inertia * (d[2] * d[2]))

            for _it in range(2):
                vsx_ = u[0][:, :, None] - u[2][:, :, None] * rsy
                vsy_ = u[1][:, :, None] + u[2][:, :, None] * rsx
                vs_ = torch.sqrt(vsx_ * vsx_ + vsy_ * vsy_ + 1e-16)
                fac_s = torch.minimum(w_s, cap_s_ / vs_)
                f_w = torch.clamp(w_w * u[2], -cap_w_, cap_w_)
                fx_ = fac_s * vsx_
                fy_ = fac_s * vsy_
                g0 = mass * (u[0] - u_unc[0]) + rsum(fx_)
                g1 = mass * (u[1] - u_unc[1]) + rsum(fy_)
                g2 = inertia * (u[2] - u_unc[2]) + f_w \
                    + rsum(rsx * fy_ - rsy * fx_)
                sfac = rsum(fac_s)
                h00 = mass + sfac
                h11 = mass + sfac
                h02 = rsum(fac_s * (-rsy))
                h12 = rsum(fac_s * rsx)
                h22 = inertia + w_w * (torch.abs(w_w * u[2]) <= cap_w_) \
                    + rsum(fac_s * (rsx * rsx + rsy * rsy))
                l00i = _rsqrt(h00)
                l11i = _rsqrt(h11)
                l20 = h02 * l00i
                l21 = h12 * l11i
                l22i = _rsqrt(torch.clamp(h22 - l20 * l20 - l21 * l21,
                                          min=1e-12))
                y0 = -g0 * l00i
                y1 = -g1 * l11i
                y2 = (-g2 - l20 * y0 - l21 * y1) * l22i
                d2 = y2 * l22i
                d1 = (y1 - l21 * d2) * l11i
                d0 = (y0 - l20 * d2) * l00i
                u1 = [u[0] + d0, u[1] + d1, u[2] + d2, u[3], u[4]]
                u2 = [u[0] + 0.5 * d0, u[1] + 0.5 * d1, u[2] + 0.5 * d2,
                      u[3], u[4]]
                e0 = e_cheap(u)
                e1 = e_cheap(u1)
                e2 = e_cheap(u2)
                b12 = e1 <= e2
                eb = torch.where(b12, e1, e2)
                tk = eb <= e0
                u = [torch.where(tk, torch.where(b12, u1[a], u2[a]), u[a])
                     for a in range(5)]
            return u

        # broad phase: finger contact impossible unless the object's
        # bounding circle can reach a finger surface; gated per block
        maybe = (cy <= broad_a + ql) | (cy >= broad_b + qr)
        any_f = _block_any(maybe)                       # (B, NB, 1)
        if bool(any_f.all()):
            u, n_act = full_solve()
        elif not bool(any_f.any()):
            u, n_act = cheap_solve(), zero
        else:
            (uf, n_act), uc = full_solve(), cheap_solve()
            u = [torch.where(any_f, a_, c_) for a_, c_ in zip(uf, uc)]
        vx, vy, om, qdl, qdr = u
        mf = any_f.to(torch.float32)
        cnt_f = cnt_f + mf
        cnt_c = cnt_c + (1.0 - mf)
        return (cx + dt * vx, cy + dt * vy, th + dt * om, vx, vy, om,
                zb + dt * vz, vz, ql + dt * qdl, qr + dt * qdr, qdl, qdr,
                cnt_f, cnt_c, cnt_a + mf * n_act)

    def jacobi_step(cx, cy, th, vx, vy, om, zb, vz, ql, qr, qdl, qdr,
                    cnt_f, cnt_c, cnt_a):
        # projected Jacobi (pallas2d.py:221-334): every normal step is a
        # full solve of the merged contact set
        c, s = torch.cos(th), torch.sin(th)
        depth_z = SIM.plane_z - zb
        n_total = mass * torch.clamp(K_PLANE * depth_z - B_PLANE * vz, min=0.0)
        c4, s4 = c[:, :, None], s[:, :, None]
        rsx = sbx * c4 - sby * s4                       # (B, NB, S, L)
        rsy = sbx * s4 + sby * c4
        (rx, ry, is_l, depth, nx, ny, act, rxn, tx_, ty_, rxt,
         me_n, me_t, vn0) = contact_geometry(cx, cy, c, s, ql, qr,
                                             vx, vy, om, qdl, qdr)
        sl = is_l.to(torch.float32)
        sr = 1.0 - sl
        n_act = rsum(act)
        cnt = torch.clamp(n_act, min=1.0)[:, :, None]
        w_c = act / cnt
        # implicit stopping target from the base solref gains; the calib
        # gains drive the explicit elastic wedge term
        tgt = (1.0 - d_imp * B_CONTACT * dt) * vn0 \
            + d_imp * dt * K_CONTACT * depth
        depth_el = act * torch.clamp(depth, 0.0, DEPTH_EL_CAP)
        v_capn = d_imp * dt * k_con * depth_el
        dv_el = torch.minimum(
            torch.clamp(d_imp * dt * (k_con * depth_el - b_con * vn0),
                        min=0.0),
            torch.clamp(v_capn - vn0, min=0.0))
        imp_el = act * me_n * dv_el
        # global energy clamp on the summed elastic wrench: a min over the
        # rollout's points (exact in any order)
        dvx_u = rsum(imp_el * nx) * inv_m
        dvy_u = rsum(imp_el * ny) * inv_m
        dom_u = rsum(imp_el * rxn) * inv_i
        dqdl_u = -rsum(sl * imp_el * ny) * inv_fml
        dqdr_u = -rsum(sr * imp_el * ny) * inv_fmr
        dqd_pt = torch.where(is_l, dqdl_u[:, :, None], dqdr_u[:, :, None])
        dvn_ind = ((dvx_u[:, :, None] - dom_u[:, :, None] * ry) * nx
                   + (dvy_u[:, :, None] + dom_u[:, :, None] * rx - dqd_pt)
                   * ny)
        headroom = torch.clamp(v_capn - vn0, min=0.0)
        ratio = torch.where((act > 0) & (dvn_ind > 1e-9),
                            headroom / (dvn_ind + 1e-9),
                            torch.full_like(dvn_ind, math.inf))
        s_el = torch.clamp(ratio.amin(dim=2, keepdim=True), 0.0, 1.0)
        imp_el = s_el * imp_el
        # mean-field plane unloading from the grip load
        grip = rsum(imp_el) / (dt * mass * SIM.gravity)
        n_i = sw * n_total[:, :, None] / (1.0 + unload * grip[:, :, None])

        f_l = g.kp * (ctrl_l - ql) - g.joint_damping * qdl
        f_r = g.kp * (ctrl_r - qr) - g.joint_damping * qdr
        vx = vx + rsum(imp_el * nx) * inv_m
        vy = vy + rsum(imp_el * ny) * inv_m
        om = om + rsum(imp_el * rxn) * inv_i
        vz = vz + dt * (-SIM.gravity + n_total * inv_m)
        qdl = qdl + dt * f_l * inv_fml - rsum(sl * imp_el * ny) * inv_fml
        qdr = qdr + dt * f_r * inv_fmr - rsum(sr * imp_el * ny) * inv_fmr

        wcn, wct = w_c * me_n, w_c * me_t
        cap_r = rough * me_t * torch.clamp(depth_el, max=ROUGH_SAT)
        cap_s = mu_plane * n_i * dt
        cap_w = mu_torsion * n_i * dt
        lam_n = torch.zeros_like(depth)
        lam_t = torch.zeros_like(depth)
        lam_sx = torch.zeros_like(n_i)
        lam_sy = torch.zeros_like(n_i)
        lam_w = torch.zeros_like(n_i)
        for _it in range(SOLVER_ITERS):
            qd_cc = torch.where(is_l, qdl[:, :, None], qdr[:, :, None])
            vpx = vx[:, :, None] - om[:, :, None] * ry
            vpy = vy[:, :, None] + om[:, :, None] * rx - qd_cc
            vn = vpx * nx + vpy * ny
            vt = vpx * tx_ + vpy * ty_
            new_n = torch.clamp(lam_n + wcn * (tgt - vn), min=0.0)
            d_n = new_n - lam_n
            cap = mu_finger * (new_n + imp_el) + cap_r
            new_t = torch.minimum(torch.maximum(lam_t - wct * vt, -cap), cap)
            d_t = new_t - lam_t
            imp_x = d_n * nx + d_t * tx_
            imp_y = d_n * ny + d_t * ty_
            vx = vx + rsum(imp_x) * inv_m
            vy = vy + rsum(imp_y) * inv_m
            om = om + rsum(d_n * rxn + d_t * rxt) * inv_i
            qdl = qdl - rsum(sl * imp_y) * inv_fml
            qdr = qdr - rsum(sr * imp_y) * inv_fmr
            lam_n, lam_t = new_n, new_t

            # plane friction
            vsx = vx[:, :, None] - om[:, :, None] * rsy
            vsy = vy[:, :, None] + om[:, :, None] * rsx
            nsx = lam_sx - sw * m4 * vsx
            nsy = lam_sy - sw * m4 * vsy
            nrm = torch.sqrt(nsx * nsx + nsy * nsy + 1e-20)
            sc = torch.clamp(cap_s / nrm, max=1.0)
            nsx, nsy = nsx * sc, nsy * sc
            d_sx, d_sy = nsx - lam_sx, nsy - lam_sy
            vx = vx + rsum(d_sx) * inv_m
            vy = vy + rsum(d_sy) * inv_m
            om = om + rsum(rsx * d_sy - rsy * d_sx) * inv_i
            lam_sx, lam_sy = nsx, nsy
            new_w = torch.minimum(
                torch.maximum(lam_w - sw * i4 * om[:, :, None], -cap_w),
                cap_w)
            om = om + rsum(new_w - lam_w) * inv_i
            lam_w = new_w
        return (cx + dt * vx, cy + dt * vy, th + dt * om, vx, vy, om,
                zb + dt * vz, vz, ql + dt * qdl, qr + dt * qdr, qdl, qdr,
                cnt_f + 1.0, cnt_c, cnt_a + n_act)

    def travel_step(cx, cy, th, vx, vy, om, zb, vz, ql, qr, qdl, qdr,
                    cnt_f, cnt_c, cnt_a):
        # settled-travel fast path: only the finger servos advance
        f_l = g.kp * (ctrl_l - ql) - g.joint_damping * qdl
        f_r = g.kp * (ctrl_r - qr) - g.joint_damping * qdr
        qdl = qdl + dt * f_l * inv_fml
        qdr = qdr + dt * f_r * inv_fmr
        return (cx, cy, th, vx, vy, om, zb, vz,
                ql + dt * qdl, qr + dt * qdr, qdl, qdr, cnt_f, cnt_c, cnt_a)

    solve_step = normal_step if solver == "newton" else jacobi_step
    for i in range(steps):
        is_rg = bool(regrasp_every) and i % regrasp_every == 0 and i > 0
        if is_rg:
            # a regrasp zeroes jaws and velocities without a solve
            # confirming equilibrium: the step below is a normal one
            ql, qr, qdl, qdr = zero, zero, zero, zero
            vx, vy, om, vz = zero, zero, zero, zero

        mot = torch.maximum(torch.maximum(torch.abs(vx), torch.abs(vy)),
                            torch.maximum(torch.abs(om), torch.abs(vz)))
        settled = mot.amax(dim=-1, keepdim=True) < EPS_SETTLED
        f_l = g.kp * (ctrl_l - ql) - g.joint_damping * qdl
        f_r = g.kp * (ctrl_r - qr) - g.joint_damping * qdr
        ql_n = ql + dt * (qdl + dt * f_l * inv_fml)
        qr_n = qr + dt * (qdr + dt * f_r * inv_fmr)
        marg = 1e-4
        maybe = ((cy - marg <= broad_a + torch.maximum(ql, ql_n))
                 | (cy + marg >= broad_b + torch.minimum(qr, qr_n)))
        travel = settled & ~_block_any(maybe)
        if is_rg:
            travel = torch.zeros_like(travel)

        st = (cx, cy, th, vx, vy, om, zb, vz, ql, qr, qdl, qdr, cnt_f, cnt_c,
              cnt_a)
        if bool(travel.all()):
            st = travel_step(*st)
        elif not bool(travel.any()):
            st = solve_step(*st)
        else:
            st = tuple(torch.where(travel, a_, n_) for a_, n_ in
                       zip(travel_step(*st), solve_step(*st)))
        (cx, cy, th, vx, vy, om, zb, vz, ql, qr, qdl, qdr,
         cnt_f, cnt_c, cnt_a) = st
        if i + 1 == snapshot_step:
            scx, scy, sth = cx, cy, th

    if snapshot_step <= 0 or snapshot_step >= steps:
        scx, scy, sth = cx, cy, th

    two_pi = 2.0 * math.pi
    d_theta = sth - theta0
    d_theta = d_theta - two_pi * torch.round(d_theta / two_pi)
    c1, s1 = torch.cos(sth), torch.sin(sth)
    sorg_x = scx - (c1 * com_bx - s1 * com_by)
    sorg_y = scy - (s1 * com_bx + c1 * com_by)
    c, s = torch.cos(th), torch.sin(th)
    org_x = cx - (c * com_bx - s * com_by)
    org_y = cy - (s * com_bx + c * com_by)
    outs = (d_theta, sorg_x - pose_x, sorg_y - pose_y,
            torch.remainder(th, two_pi), org_x, org_y,
            cnt_f.expand(b, nb, LANE), cnt_c.expand(b, nb, LANE), cnt_a)
    return tuple(o.expand(b, nb, LANE).reshape(b, n) for o in outs)
