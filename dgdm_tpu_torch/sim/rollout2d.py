"""2D squeeze rollouts on the card — port of ``dgdm_tpu/sim/pallas2d.py``.

``profile_batch`` takes the dense per-pair arrays of ``scene_arrays`` and a
shared pose batch and runs every (pair, pose) rollout for all steps:

- on CUDA tensors it launches the hand-written kernel
  ``dgdm_tpu_torch/csrc/rollout2d.cu`` (built with ``nvcc`` for ``sm_90a`` on
  first use into ``dgdm_tpu_torch/_build/`` and bound with ctypes, by
  ``core/native.py``);
- on CPU tensors it runs the plain PyTorch version
  (``sim/rollout2d_ref.py``).

The kernel gives a rollout 16 threads of a warp (a 128-pose group is one
thread block cluster) and holds each thread's per-point contact geometry in
shared memory (the Newton solve keeps the points in contact only, and its
contour passes visit those); ``LAST_PLAN`` holds the layout of the last
launch. It has two
instantiations, one per contact solver (``engine2d.SOLVER``, resolved at
call time unless ``solver`` is given): the coupled Newton solve and the
projected Jacobi solve (``pallas2d.py:221-334``), whose per-point
impulses live in registers for a lane's first points and in the
shared-memory slab beyond them.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises. ``KERNEL_LAUNCHES`` counts kernel launches per instantiation:
``"rollout2d"`` (Newton) and ``"rollout2d_jacobi"``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from dgdm_tpu_torch.core import native
from dgdm_tpu_torch.core.config import GRIPPER_2D, SIM
from dgdm_tpu_torch.core.transfer import upload
from dgdm_tpu_torch.sim import engine2d
from dgdm_tpu_torch.sim.rollout2d_ref import (
    EPS_SETTLED,
    LANE,
    N_SCALARS,
    profile_batch_ref,
    resolve_solver,
)

# kernel launches per wrapper, for showing that a run went through them
KERNEL_LAUNCHES = {"rollout2d": 0, "rollout2d_jacobi": 0}
# the launch counter of each contact solver's instantiation
COUNTER = {"newton": "rollout2d", "jacobi": "rollout2d_jacobi"}
# the launch plan of the last launch (core/native.PLAN_FIELDS)
LAST_PLAN: dict = {}
# threads per rollout of the kernel's layout (csrc/rollout2d.cu)
THREADS_PER_ROLLOUT = 16


class _Params(ctypes.Structure):
    """Mirror of ``Rollout2DParams`` in csrc/rollout2d.cu."""

    _fields_ = [(k, ctypes.c_int) for k in
                ("steps", "regrasp_every", "snapshot_step", "newton_iters",
                 "solver", "solver_iters")] + [
        (k, ctypes.c_float) for k in
        ("dt", "ctrl_l", "ctrl_r", "x0f", "x1f", "h", "inv_h", "surf_l0",
         "surf_r0", "kp", "damping", "plane_z", "gravity", "k_plane",
         "b_plane", "depth_el_cap", "impedance", "eps_settled", "marg",
         "k_base", "b_base", "rough_sat")]


# the kernel's instantiation of each contact solver (csrc/rollout2d.cu)
SOLVER_CODES = {"newton": 0, "jacobi": 1}


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.rollout2d_launch.argtypes = [p] * 6 + [ctypes.c_int] * 4 + [
        _Params, ctypes.POINTER(native.Plan), p]
    lib.rollout2d_launch.restype = ctypes.c_int


LIBRARY = native.NativeLibrary("rollout2d.cu", _bind, **native.NVCC)


def _params(steps, regrasp_every, snapshot_step, solver) -> _Params:
    g = GRIPPER_2D
    h = (g.ctrl_x_max - g.ctrl_x_min) / (g.num_ctrl - 1)
    ctrl_l = min(SIM.ctrl_2d, g.ctrl_clamped)
    return _Params(
        steps=steps, regrasp_every=regrasp_every, snapshot_step=snapshot_step,
        newton_iters=engine2d.NEWTON_ITERS, solver=SOLVER_CODES[solver],
        solver_iters=engine2d.SOLVER_ITERS, dt=SIM.dt, ctrl_l=ctrl_l,
        ctrl_r=-ctrl_l,
        x0f=g.ctrl_x_min, x1f=g.ctrl_x_max, h=h, inv_h=1.0 / h,
        surf_l0=-g.jaw_offset + g.width, surf_r0=g.jaw_offset, kp=g.kp,
        damping=g.joint_damping, plane_z=SIM.plane_z, gravity=SIM.gravity,
        k_plane=engine2d.K_PLANE, b_plane=engine2d.B_PLANE,
        depth_el_cap=engine2d.DEPTH_EL_CAP, impedance=engine2d.IMPEDANCE,
        eps_settled=EPS_SETTLED, marg=1e-4, k_base=engine2d.K_CONTACT,
        b_base=engine2d.B_CONTACT, rough_sat=engine2d.ROUGH_SAT,
    )


def _check_inputs(coefs, contour, support, scalars, poses):
    b = coefs.shape[0]
    if coefs.shape != (b, 2, 6, 4):
        raise ValueError(f"coefs must be (B, 2, 6, 4), got {tuple(coefs.shape)}")
    if contour.ndim != 3 or contour.shape[0] != b or contour.shape[2] != 2:
        raise ValueError(f"contour must be (B, P, 2), got {tuple(contour.shape)}")
    if support.ndim != 3 or support.shape[0] != b or support.shape[2] != 4:
        raise ValueError(f"support must be (B, S, 4), got {tuple(support.shape)}")
    if scalars.shape != (b, 1, N_SCALARS):
        raise ValueError(f"scalars must be (B, 1, 16), got {tuple(scalars.shape)}")
    if poses.ndim != 2 or poses.shape[1] != 3 or poses.shape[0] % LANE:
        raise ValueError(f"poses must be (N, 3) with N % {LANE} == 0, "
                         f"got {tuple(poses.shape)}")
    native.check_inputs((coefs, contour, support, scalars, poses))


def rollout_cuda(coefs, contour, support, scalars, poses, steps,
                 regrasp_every, snapshot_step, solver=None):
    """Launch csrc/rollout2d.cu on the current stream -> (9, B, N) float32.
    The launcher refuses a point count whose shared-memory slab does not
    fit a block: on the H100 P > 384 (Newton) or, with 64 supports, P > 272
    (Jacobi, 12 floats a contour point and 3 a support point)."""
    solver = resolve_solver(solver)
    b, p, s, n = coefs.shape[0], contour.shape[1], support.shape[1], \
        poses.shape[0]
    return native.launch(
        LIBRARY.get().rollout2d_launch,
        (coefs, contour, support, scalars, poses), (9, b, n), (b, p, s, n),
        _params(steps, regrasp_every, snapshot_step, solver), LAST_PLAN,
        KERNEL_LAUNCHES, COUNTER[solver])


def rollout(coefs, contour, support, scalars, poses,
            steps: int = SIM.steps_2d, regrasp_every: int = 0,
            snapshot_step: int = 0,
            solver: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """The 9 raw (B, N) outputs: dtheta, dpx, dpy (snapshot), final theta,
    final x, final y, full-solve and cheap-solve step counts per block, and
    the rollout's contour points in contact summed over its full solves
    (Newton) or its solves (Jacobi).
    ``solver``: "newton" or "jacobi"; None reads ``engine2d.SOLVER`` now."""
    _check_inputs(coefs, contour, support, scalars, poses)
    solver = resolve_solver(solver)
    if poses.device.type == "cuda":
        return tuple(rollout_cuda(coefs, contour, support, scalars, poses,
                                  steps, regrasp_every, snapshot_step,
                                  solver))
    if poses.device.type == "cpu":
        return profile_batch_ref(coefs, contour, support, scalars, poses,
                                 steps=steps, regrasp_every=regrasp_every,
                                 snapshot_step=snapshot_step, solver=solver)
    raise ValueError(f"no rollout path for device {poses.device}")


def profile_batch(coefs, contour, support, scalars, poses,
                  steps: int = SIM.steps_2d, regrasp_every: int = 0,
                  snapshot_step: int = 0, solver: Optional[str] = None):
    """Fused rollouts: (B pairs) x (N poses) -> (dtheta (B, N),
    dpos (B, N, 2), final_theta (B, N), final_pos (B, N, 2)); ``rollout``
    also returns the (full, cheap) solve counts per block and the
    contact count per rollout.

    ``snapshot_step`` > 0 records dtheta/dpos at that step (the first-squeeze
    profile of the eval schedule) while the rollout continues to ``steps``;
    0 snapshots at the end (datagen). The contact solver is ``solver`` or,
    when None, ``engine2d.SOLVER`` at call time (as the JAX package's
    ``profile_batch_pallas`` resolves it)."""
    dth, dpx, dpy, fth, fpx, fpy = rollout(
        coefs, contour, support, scalars, poses, steps=steps,
        regrasp_every=regrasp_every, snapshot_step=snapshot_step,
        solver=solver)[:6]
    return (dth, torch.stack([dpx, dpy], dim=-1), fth,
            torch.stack([fpx, fpy], dim=-1))


def scene_arrays(scenes, calib: Optional[engine2d.Calib] = None,
                 device="cuda") -> Tuple[torch.Tensor, ...]:
    """Stacked Scene2D (leading dim B) -> the dense float32 inputs of
    ``profile_batch`` on ``device``: coefs (B, 2, 6, 4), contour (B, P, 2),
    support (B, S, 4), scalars (B, 1, 16). ``calib`` rides in the scalar
    slots (layout: dgdm_tpu/sim/pallas2d.py:scene_arrays)."""
    if calib is None:
        calib = engine2d.default_calib()
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
    return tuple(upload(a, device)
                 for a in (coefs, scenes.contour.numpy(), support, scal))
