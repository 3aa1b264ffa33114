"""The plain 3D rollout of the benchmark's reference as the card can run it
at the verification depth (32,000 steps): ``k2.profile_batch_ref``'s
rollout (the plain version that the rollout kernel K2 is held to, the
configuration's Newton solve), with the same outputs bit for bit and no
per-row host decision.

It differs from ``k2.py`` in how it runs, not in what it computes:

- where ``k2.profile_batch_ref`` asks the host which (pair, 128-pose
  block) rows are in settled travel and which take the full or the cheap
  solve (``torch.nonzero``, then ``index_select`` and ``index_copy`` of
  those rows), each step here computes on every row and each row keeps its
  own branch with ``torch.where``: a row's result depends only on its own
  block, so every value kept is the value ``k2.py`` computes, and the
  discarded branch may hold anything;
- a step computes only the branches its rows take: first a small
  computation of the step's gates (``_kind``: is every row in travel; does
  every row take the full solve) whose two flags the host reads, then the
  travel update alone, the normal step with the full solve alone, or every
  branch on every row (``STEPS``);
- on the card each of these (with and without a re-grasp) is captured once
  as a CUDA graph and replayed: a step is two graph launches and one
  two-flag read, against ``k2.py``'s ~2,000 eager launches and two row
  reads. The 32,000 steps of a verification are then paced by the card's
  work (thousands of small kernels a step), not by the host.

``k2._full_solve``, ``_cheap_solve`` and their helpers run unchanged; the
expressions of ``k2._normal_step`` and of ``profile_batch_ref``'s loop are
kept in their order. Point sums go through ``point_sum`` with the caller's
``sum_group``: 0 (``torch.sum``'s order in float64, as the 3D datagen cell
compares) by default, 32 the kernel's own order, ``FLOAT32_SUM`` the
control's float32 sums. The float64 totals of float32 terms are exact
unless their exponents span more than ~29 bits, so 0 and 32 give the same
float32 in all but rare cases. At the 3D design cell's verification shape
(16 designs x one 128-pose block x 256 points, every step a full solve) on
an NVIDIA H100 80GB HBM3 at 700 W, a step took ~4.2 ms with 0 (32,000 steps
in ~134 s) and ~5.7 ms with 32 (~182 s: the kernel's order would take the
cell's runs past four minutes); ``k2.profile_batch_ref`` eager ~19 ms. Set
TF32 off before calling (nothing here multiplies matrices, but the
caller's other work may).
"""

from __future__ import annotations

from typing import Tuple

import torch

from perfbench.reference.config import SIM
from perfbench.reference.k2 import (
    LANE,
    NEWTON_KERNEL_ITERS3,
    _cheap_solve,
    _full_solve,
    _Pairs,
    _rotation,
    _sandwich,
    _symmul,
    constants,
)

def _placement(st, pr: _Pairs, k):
    """The rows' rotation, the points' world positions and the broad phase
    of a normal step (``k2._normal_step``'s first expressions, in its
    order): (r, rx, ry, rz, wx, wy, wz, wyn, wyx, any_f)."""
    px, py, pz, qw, qx, qy, qz = st[:7]
    ql, qr = st[13], st[14]
    r = _rotation(qw, qx, qy, qz)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    e = lambda x: x[:, None, :]                                 # noqa: E731
    rx = e(r00) * pr.pbx + e(r01) * pr.pby + e(r02) * pr.pbz
    ry = e(r10) * pr.pbx + e(r11) * pr.pby + e(r12) * pr.pbz
    rz = e(r20) * pr.pbx + e(r21) * pr.pby + e(r22) * pr.pbz
    wx = e(px) + rx
    wy = e(py) + ry
    wz = e(pz) + rz
    wyn = wy.amin(dim=1)
    wyx = wy.amax(dim=1)
    maybe = ((wyn <= k["surf_l0"] + ql + pr.lane(25))
             | (wyx >= k["surf_r0"] + qr + pr.lane(26)))
    return r, rx, ry, rz, wx, wy, wz, wyn, wyx, maybe.any(dim=-1)


def _normal_step_all(st, pr: _Pairs, k, solves=("full", "cheap")):
    """``k2._normal_step`` on every row: each solve of ``solves`` runs on
    every row and each row keeps its block's own (the expressions are that
    function's, in its order). Only where every row takes the full solve
    may ``solves`` leave the cheap one out."""
    (px, py, pz, qw, qx, qy, qz, vx, vy, vz,
     ox, oy, oz, ql, qr, qdl, qdr, wyn, wyx, cnt_f, cnt_c, cnt_i) = st
    dt = k["dt"]
    mass, fmass_l, fmass_r = pr.lane(0), pr.lane(1), pr.lane(11)
    inv_m = 1.0 / mass
    inv_fml, inv_fmr = 1.0 / fmass_l, 1.0 / fmass_r

    r, rx, ry, rz, wx, wy, wz, wyn, wyx, any_f = _placement(st, pr, k)
    w = _sandwich(r, *(pr.lane(i) for i in (5, 6, 7, 8, 9, 10)))
    iw = _sandwich(r, *(pr.lane(i) for i in (18, 19, 20, 21, 22, 23)))
    e = lambda x: x[:, None, :]                                 # noqa: E731
    we = [e(x) for x in w]
    depth_p = k["plane_z"] - wz
    act_p = (depth_p > 0).to(torch.float32)
    wxp = we[0] * ry + we[1] * (-rx)
    wyp = we[1] * ry + we[3] * (-rx)
    ang_p = ry * wxp + (-rx) * wyp
    me_p = 1.0 / (e(inv_m) + ang_p)

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

    geo = dict(rx=rx, ry=ry, rz=rz, wx=wx, wy=wy, wz=wz, w_np=w_np,
               tgt_p=tgt_p, me_p=me_p, vpx=vpx, vpy=vpy, vpz=vpz)
    lane = dict(ql=ql, qr=qr, qdl=qdl, qdr=qdr, mass=mass,
                fmass_l=fmass_l, fmass_r=fmass_r, inv_m=inv_m,
                inv_fml=inv_fml, inv_fmr=inv_fmr, mg_dt=mg_dt, iw=iw, w=w)
    u, iters = _full_solve(geo, lane, u_unc, pr, k)
    if "cheap" in solves:
        u_cheap, it_cheap = _cheap_solve(geo, lane, u_unc, pr, k)
        take = any_f[:, None]
        u = [torch.where(take, a, b) for a, b in zip(u, u_cheap)]
        iters = torch.where(take, iters, it_cheap)
    vx, vy, vz, ox, oy, oz, qdl, qdr = u
    mf = any_f.to(torch.float32)[:, None]
    cnt_f = cnt_f + mf
    cnt_c = cnt_c + (1.0 - mf)
    cnt_i = cnt_i + iters

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
    qn = 1.0 / torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz + 1e-12)
    qw, qx, qy, qz = qw * qn, qx * qn, qy * qn, qz * qn
    ql = ql + dt * qdl
    qr = qr + dt * qdr
    return (px, py, pz, qw, qx, qy, qz, vx, vy, vz,
            ox, oy, oz, ql, qr, qdl, qdr, wyn, wyx, cnt_f, cnt_c, cnt_i)


def _gate(st, pr: _Pairs, k, regrasp: bool):
    """The start of a step of ``k2.profile_batch_ref``'s loop: the state
    after a re-grasp's reset, the rows in settled travel (G, 1), and their
    state after the travel update."""
    dt = k["dt"]
    inv_fml, inv_fmr = 1.0 / pr.lane(1), 1.0 / pr.lane(11)
    (px, py, pz, qw, qx, qy, qz, vx, vy, vz, ox, oy, oz, ql, qr, qdl,
     qdr, wyn, wyx, cnt_f, cnt_c, cnt_i) = st
    if regrasp:
        zero = torch.zeros_like(px)
        ql = qr = qdl = qdr = zero
        vx = vy = vz = ox = oy = oz = zero
        wyn = zero - 1e9
    mot = torch.maximum(torch.maximum(torch.abs(vx), torch.abs(vy)),
                        torch.abs(vz))
    mot = torch.maximum(mot, torch.maximum(torch.maximum(
        torch.abs(ox), torch.abs(oy)), torch.abs(oz)))
    settled = mot.amax(dim=-1) < k["eps_settled"]
    f_l = k["kp"] * (k["ctrl_l"] - ql) - k["damping"] * qdl
    f_r = k["kp"] * (k["ctrl_r"] - qr) - k["damping"] * qdr
    ql_n = ql + dt * (qdl + dt * f_l * inv_fml)
    qr_n = qr + dt * (qdr + dt * f_r * inv_fmr)
    maybe = ((wyn - k["marg"] <= k["surf_l0"] + torch.maximum(ql, ql_n)
              + pr.lane(25))
             | (wyx + k["marg"] >= k["surf_r0"] + torch.minimum(qr, qr_n)
                + pr.lane(26)))
    travel = (settled & ~maybe.any(dim=-1))[:, None]
    qdl_t = qdl + dt * f_l * inv_fml
    qdr_t = qdr + dt * f_r * inv_fmr
    cur = (px, py, pz, qw, qx, qy, qz, vx, vy, vz, ox, oy, oz, ql, qr,
           qdl, qdr, wyn, wyx, cnt_f, cnt_c, cnt_i)
    still = [px, py, pz, qw, qx, qy, qz, vx, vy, vz, ox, oy, oz,
             ql + dt * qdl_t, qr + dt * qdr_t, qdl_t, qdr_t, wyn, wyx,
             cnt_f, cnt_c, cnt_i]
    return cur, travel, still


# what a step computes (``_step``): every branch on every row; the travel
# update alone (every row in settled travel); the normal step with the full
# solve alone (no row in travel, every row's block with finger contact
# possible)
STEPS = ("masked", "travel", "full")


def _step(st, pr: _Pairs, k, regrasp: bool, kind: str = "masked"):
    """One step of ``k2.profile_batch_ref``'s loop on every row."""
    cur, travel, still = _gate(st, pr, k, regrasp)
    if kind == "travel":
        return still
    if kind == "full":
        return list(_normal_step_all(cur, pr, k, solves=("full",)))
    new = _normal_step_all(cur, pr, k)
    return [torch.where(travel, a, b) for a, b in zip(still, new)]


def _kind(st, pr: _Pairs, k, regrasp: bool) -> torch.Tensor:
    """(2,) bool on the device: is every row in settled travel; is no row
    in travel and every row's block one that takes the full solve."""
    cur, travel, _ = _gate(st, pr, k, regrasp)
    any_f = _placement(cur, pr, k)[-1]
    return torch.stack([travel.all(), (~travel[:, 0] & any_f).all()])


def rollout(
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
    """``k2.profile_batch_ref``'s 12 raw (B, N) float32 outputs (its
    ``OUT_NAMES``), with the same arguments. On a CUDA device each step and
    each step's choice replay as CUDA graphs."""
    k = dict(constants(), sum_group=sum_group,
             newton_iters=int(newton_iters))
    b = points.shape[0]
    n = poses.shape[0]
    if n % LANE:
        raise ValueError(f"pose count {n} must be a multiple of {LANE}")
    nb = n // LANE
    dev = poses.device
    rows_all = torch.arange(b, device=dev).repeat_interleave(nb)
    pr = _Pairs.build(coefs, points, scalars, rows_all)
    com_x, com_y, com_z = pr.lane(2), pr.lane(3), pr.lane(4)

    pose_x = poses[:, 0].reshape(nb, LANE).repeat(b, 1)
    pose_y = poses[:, 1].reshape(nb, LANE).repeat(b, 1)
    theta0 = poses[:, 2].reshape(nb, LANE).repeat(b, 1)
    half = theta0 * 0.5
    qw0, qz0 = torch.cos(half), torch.sin(half)
    zero = torch.zeros_like(pose_x)
    c0, s0 = torch.cos(theta0), torch.sin(theta0)
    px = pose_x + c0 * com_x - s0 * com_y
    py = pose_y + s0 * com_x + c0 * com_y
    pz = zero + com_z
    state = [x.contiguous().clone() for x in (
        px, py, pz, qw0, zero, zero, qz0, zero, zero, zero, zero, zero,
        zero, zero, zero, zero, zero, zero - 1e9, zero - 1e9, zero, zero,
        zero)]
    choice = torch.zeros(2, dtype=torch.bool, device=dev)

    def advance(rg: bool, kind: str):
        for s_, n_ in zip(state, _step(state, pr, k, rg, kind)):
            s_.copy_(n_)

    def decide(rg: bool):
        choice.copy_(_kind(state, pr, k, rg))

    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for rg in (False, True):      # warm-up; the results are dropped
                _kind(state, pr, k, rg)
                for kind in STEPS:
                    _step(state, pr, k, rg, kind)
        torch.cuda.current_stream(dev).wait_stream(side)
        # the graphs run one at a time, in one stream: one memory pool
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for rg in (False, True):
            for kind in STEPS + ("decide",):
                graphs[rg, kind] = g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=pool):
                    if kind == "decide":
                        decide(rg)
                    else:
                        advance(rg, kind)
        decide = lambda rg: graphs[rg, "decide"].replay()    # noqa: E731
        advance = lambda rg, kind: graphs[rg, kind].replay()  # noqa: E731

    snap = None
    for i in range(steps):
        rg = bool(regrasp_every) and i % regrasp_every == 0 and i > 0
        decide(rg)
        all_travel, all_full = choice.tolist()
        advance(rg, "travel" if all_travel else
                "full" if all_full else "masked")
        if i + 1 == snapshot_step:
            snap = [state[0].clone(), state[1].clone(), state[3].clone(),
                    state[6].clone()]
    (px, py, pz, qw, qx, qy, qz, *_rest) = state
    cnt_f, cnt_c, cnt_i = state[19], state[20], state[21]
    if snapshot_step <= 0 or snapshot_step >= steps or snap is None:
        snap = [px, py, qw, qz]
    spx, spy, sqw, sqz = snap

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
