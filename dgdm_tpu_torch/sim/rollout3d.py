"""3D squeeze rollouts on the card — port of ``dgdm_tpu/sim/pallas3d.py``.

``profile_batch`` takes the dense per-pair arrays of ``scene_arrays_3d`` and
a shared pose batch and runs every (pair, pose) rollout for all steps:

- on CUDA tensors it launches the hand-written kernel
  ``dgdm_tpu_torch/csrc/rollout3d.cu`` (built with ``nvcc`` for ``sm_90a`` on
  first use into ``dgdm_tpu_torch/_build/`` and bound with ctypes, by
  ``core/native.py``);
- on CPU tensors it runs the plain PyTorch version
  (``sim/rollout3d_ref.py``).

The kernel gives a rollout 32 threads of a warp (a 128-pose group is one
thread block cluster) and holds each thread's per-point contact geometry in
shared memory; ``LAST_PLAN`` holds the layout of the last launch. It has
three instantiations: the coupled Newton solve with a fixed iteration count,
the same solve with the adaptive ``newton_tol`` loop, and projected Jacobi
(``solver="jacobi"``, ``pallas3d.py:302-433``). The arguments mirror the
static ones of ``_profile_batch_pallas3d``: ``solver`` (None reads
``engine3d.SOLVER3`` at call time; "pyramid" runs the Newton branch, as the
Pallas kernel does), ``newton_iters`` (None reads ``NEWTON_KERNEL_ITERS3``)
and ``newton_tol``.

There is no fallback between the two: a CUDA tensor launches the kernel or
raises. ``KERNEL_LAUNCHES`` counts kernel launches per instantiation:
``"rollout3d"``, ``"rollout3d_newton_tol"`` and ``"rollout3d_jacobi"``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from dgdm_tpu_torch.core import native
from dgdm_tpu_torch.core.cache import LRU
from dgdm_tpu_torch.core.config import GRIPPER_3D, SIM
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.core.transfer import upload
from dgdm_tpu_torch.sim import engine3d
from dgdm_tpu_torch.sim.engine2d import Calib
from dgdm_tpu_torch.sim.rollout3d_ref import (
    LANE,
    N_SCALARS,
    constants,
    profile_batch_ref,
    readout,
)
from dgdm_tpu_torch.sim.surface_fit import (
    DEG_X,
    DEG_Z,
    N_SEG,
    NZ_SEG,
    TOT_SEG,
    fit_surface_batch,
)

# full-solve Newton iterations a step of the kernel (pallas3d.py:47; the pure
# engine's count is engine3d.NEWTON_ITERS3)
NEWTON_KERNEL_ITERS3 = 1
# kernel launches per instantiation, for showing that a run went through them
KERNEL_LAUNCHES = {"rollout3d": 0, "rollout3d_newton_tol": 0,
                   "rollout3d_jacobi": 0}
# the kernel's instantiations (csrc/rollout3d.cu) and their counters
SOLVER_CODES = {"rollout3d": 0, "rollout3d_jacobi": 1,
                "rollout3d_newton_tol": 2}
# the launch plan of the last launch (core/native.PLAN_FIELDS)
LAST_PLAN: dict = {}
# threads per rollout of the kernel's layout (csrc/rollout3d.cu)
THREADS_PER_ROLLOUT = 32

# float fields of Rollout3DParams in csrc/rollout3d.cu, in order; each value
# comes from rollout3d_ref.constants()
_FLOAT_PARAMS = (
    "dt", "d_imp", "ctrl_l", "ctrl_r", "kp", "damping", "x0f", "x1f", "z0f",
    "z1f", "hseg", "hzseg", "inv_hseg", "inv_hzseg", "surf_l0", "surf_r0",
    "plane_z", "tgt_p_v", "tgt_p_d", "g_dt", "gravity", "d_imp_dt", "v_rest",
    "depth_el_cap", "eps_settled", "marg", "tip_atol", "tgt_fj_v",
    "tgt_fj_d", "rough_sat")


class _Params(ctypes.Structure):
    """Mirror of ``Rollout3DParams`` in csrc/rollout3d.cu."""

    _fields_ = [(k, ctypes.c_int) for k in
                ("steps", "regrasp_every", "snapshot_step", "newton_iters",
                 "solver", "solver_iters")] + [
        (k, ctypes.c_float) for k in ("newton_tol",) + _FLOAT_PARAMS]


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.rollout3d_launch.argtypes = [p] * 5 + [ctypes.c_int] * 3 + [
        _Params, ctypes.POINTER(native.Plan), p]
    lib.rollout3d_launch.restype = ctypes.c_int


LIBRARY = native.NativeLibrary("rollout3d.cu", _bind, **native.NVCC)


def instantiation(solver: Optional[str] = None,
                  newton_tol: float = 0.0) -> str:
    """The kernel instantiation (and launch counter) of a call."""
    if engine3d.resolve_solver3(solver) == "jacobi":
        return "rollout3d_jacobi"
    return "rollout3d_newton_tol" if newton_tol > 0.0 else "rollout3d"


def _params(steps, regrasp_every, snapshot_step, inst, newton_iters,
            newton_tol) -> _Params:
    k = constants()
    return _Params(steps=steps, regrasp_every=regrasp_every,
                   snapshot_step=snapshot_step, newton_iters=newton_iters,
                   solver=SOLVER_CODES[inst],
                   solver_iters=engine3d.SOLVER_ITERS, newton_tol=newton_tol,
                   **{name: k[name] for name in _FLOAT_PARAMS})


def _check_inputs(coefs, points, scalars, poses):
    b = coefs.shape[0]
    if tuple(coefs.shape) != (b, 2, TOT_SEG, DEG_X + 1, DEG_Z + 1):
        raise ValueError("coefs must be (B, 2, 24, 4, 3), got "
                         f"{tuple(coefs.shape)}")
    if points.ndim != 3 or points.shape[0] != b or points.shape[2] != 4:
        raise ValueError(f"points must be (B, P, 4), got {tuple(points.shape)}")
    if tuple(scalars.shape) != (b, 1, N_SCALARS):
        raise ValueError(f"scalars must be (B, 1, 32), got "
                         f"{tuple(scalars.shape)}")
    if poses.ndim != 2 or poses.shape[1] != 3 or poses.shape[0] % LANE:
        raise ValueError(f"poses must be (N, 3) with N % {LANE} == 0, "
                         f"got {tuple(poses.shape)}")
    native.check_inputs((coefs, points, scalars, poses))


def rollout_cuda(coefs, points, scalars, poses, steps, regrasp_every,
                 snapshot_step, solver=None, newton_iters=None,
                 newton_tol: float = 0.0):
    """Launch csrc/rollout3d.cu on the current stream -> (12, B, N) float32.
    The launcher refuses a point count whose shared-memory slab does not fit
    a block (P > 256 on the H100: 13 floats a point for the Newton
    instantiations, 12 for Jacobi, whose sweeps also hold at most 8 points
    a lane in registers)."""
    inst = instantiation(solver, newton_tol)
    if newton_iters is None:
        newton_iters = NEWTON_KERNEL_ITERS3
    b, p, n = points.shape[0], points.shape[1], poses.shape[0]
    return native.launch(
        LIBRARY.get().rollout3d_launch, (coefs, points, scalars, poses),
        (12, b, n), (b, p, n),
        _params(steps, regrasp_every, snapshot_step, inst, int(newton_iters),
                float(newton_tol)), LAST_PLAN, KERNEL_LAUNCHES, inst)


def rollout(coefs, points, scalars, poses, steps: int = SIM.steps_3d,
            regrasp_every: int = 0, snapshot_step: int = 0,
            solver: Optional[str] = None, newton_iters: Optional[int] = None,
            newton_tol: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """The 12 raw (B, N) outputs named by ``rollout3d_ref.OUT_NAMES``."""
    _check_inputs(coefs, points, scalars, poses)
    solver = engine3d.resolve_solver3(solver)
    if newton_iters is None:
        newton_iters = NEWTON_KERNEL_ITERS3
    kw = dict(solver=solver, newton_iters=newton_iters,
              newton_tol=newton_tol)
    if poses.device.type == "cuda":
        return tuple(rollout_cuda(coefs, points, scalars, poses, steps,
                                  regrasp_every, snapshot_step, **kw))
    if poses.device.type == "cpu":
        return profile_batch_ref(coefs, points, scalars, poses, steps=steps,
                                 regrasp_every=regrasp_every,
                                 snapshot_step=snapshot_step, **kw)
    raise ValueError(f"no rollout path for device {poses.device}")


def profile_batch(coefs, points, scalars, poses, steps: int = SIM.steps_3d,
                  regrasp_every: int = 0, snapshot_step: int = 0,
                  return_step_mix: bool = False,
                  solver: Optional[str] = None,
                  newton_iters: Optional[int] = None,
                  newton_tol: float = 0.0):
    """Fused rollouts: (B pairs) x (N poses) -> (dtheta (B, N), snapshot
    dpos (B, N, 2), final theta (B, N), valid (B, N) bool, final dpos
    (B, N, 2)); with ``return_step_mix`` also the per-block (full, cheap,
    Newton-iteration) counts, as ``profile_batch_pallas3d`` returns them.

    ``snapshot_step`` > 0 records dtheta/dpos at that step (the
    first-squeeze profile of the eval schedule) while the rollout continues
    to ``steps``; 0 snapshots at the end (datagen)."""
    out = rollout(coefs, points, scalars, poses, steps=steps,
                  regrasp_every=regrasp_every, snapshot_step=snapshot_step,
                  solver=solver, newton_iters=newton_iters,
                  newton_tol=newton_tol)
    res = readout(*out[:9], poses)
    return res + (tuple(out[9:]),) if return_step_mix else res


_FIT_CACHE = LRU(2048)


def scene_arrays_3d(scenes, calib: Optional[Calib] = None,
                    device="cuda") -> Tuple[torch.Tensor, ...]:
    """Stacked Scene3D (leading dim B) -> the dense float32 inputs of
    ``profile_batch`` on ``device``: coefs (B, 2, 24, 4, 3), points
    (B, P, 4), scalars (B, 1, 32) (slot layout:
    dgdm_tpu/sim/pallas3d.py:scene_arrays_3d). The per-jaw surface fits are
    served from a bounded LRU keyed on the control points, the side and the
    contact-surface mode."""
    yls = scenes.yl.numpy()                          # (B, 7, 3)
    yrs = scenes.yr.numpy()
    b = yls.shape[0]
    both = np.concatenate([yls, yrs], 0)             # (2B, 7, 3)
    # first half = left jaws (inner face +y), second half = right (-y)
    sides = ["upper"] * b + ["lower"] * b
    mode = engine3d.CONTACT_SURFACE_3D.encode()
    keys = [both[i].tobytes() + sides[i].encode() + mode
            for i in range(2 * b)]

    def fit(miss):
        with TRACER.span("scene3d.fit"):
            return fit_surface_batch(both[miss],
                                     sides=[sides[i] for i in miss])

    rows = _FIT_CACHE.get_many(keys, fit)
    fitted = np.stack(rows)                          # (2B, TOT_SEG, 4, 3)
    coefs = np.stack([fitted[:b], fitted[b:]], axis=1).astype(np.float32)
    pts = scenes.points.numpy()
    points = np.concatenate(
        [pts, np.zeros((b, pts.shape[1], 1), np.float32)], axis=-1)

    if calib is None:
        calib = engine3d.default_calib3()
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
    return tuple(upload(a, device)
                 for a in (coefs, points, scal))

