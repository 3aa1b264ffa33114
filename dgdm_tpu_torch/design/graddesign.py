"""First-order gripper design: optimise the 14 finger control values
directly against the simulated task objective — port of
``dgdm_tpu/design/graddesign.py`` (its module docstring derives the
estimators and the measured pathology of backprop on chaotic rollouts).

    y*  =  argmax_y   E_jitter  mean_poses  objective( rollout(scene(y), pose) )

Two gradient estimators (``method=``):

- ``"smoothed"`` (default): antithetic Gaussian smoothing in design space;
  per iteration all 2 * num_pairs candidates x num_rot jittered poses run
  as one batched forward pass of the pure engine (no graph);
- ``"backprop"``: reverse-mode through the full contact rollout, each step
  checkpointed (``torch.utils.checkpoint``, recomputed in the backward
  pass), as ``jax.checkpoint(engine2d.step)`` does.

The optimiser is optax's ``chain(clip_by_global_norm(1.0), adam(lr))``:
optax's clip (``g`` if ``|g| < 1`` else ``g / |g|``) then
``torch.optim.Adam``, and a projection into the generator's control range.
The best iterate is chosen on fixed held-out jitter draws, start included.
The random draws come from ``np.random.RandomState(seed)`` and
``RandomState(seed + 10_000)`` in the JAX package's order, so both packages
draw the same candidates and jitter. ``finger_mass`` (host hull work) is
frozen at each iterate's value: ``make_scene`` runs on the host for every
iterate, with its LRU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dgdm_tpu_torch.core.config import GRIPPER_2D, NORM, SIM
from dgdm_tpu_torch.design.objectives import SIMPLE_OBJECTIVES
from dgdm_tpu_torch.geom.spline import cubic_coef_operator
from dgdm_tpu_torch.sim import datagen, engine2d
from dgdm_tpu_torch.sim.types import Scene2D, to_device


def _coef_operator(device="cpu") -> torch.Tensor:
    """The not-a-knot operator (6, 4, 7): y -> cubic segment coefs."""
    g = GRIPPER_2D
    return torch.as_tensor(
        cubic_coef_operator(g.num_ctrl, g.ctrl_x_min, g.ctrl_x_max),
        dtype=torch.float32, device=device)


def scene_with_y(scene: Scene2D, yl: torch.Tensor, yr: torch.Tensor,
                 coef_op: Optional[torch.Tensor] = None) -> Scene2D:
    """The y-dependent scene fields rebuilt with autograd (linear in y;
    elementwise products and sums, so TF32 never touches them). yl/yr may
    carry leading dims (..., 7) -> coefs (..., 6, 4). ``finger_mass`` stays
    the host-computed hull value of the caller's scene."""
    if coef_op is None:
        coef_op = _coef_operator(yl.device)
    return dataclasses.replace(
        scene,
        coef_l=(coef_op * yl[..., None, None, :]).sum(-1),
        coef_r=(coef_op * yr[..., None, None, :]).sum(-1),
    )


def pose_grid(num_rot: int, device="cpu") -> torch.Tensor:
    """(num_rot, 3) poses at the origin, orientations over [0, 2 pi)."""
    th = np.linspace(0.0, 2.0 * np.pi, num_rot, endpoint=False)
    return torch.as_tensor(
        np.stack([np.zeros_like(th), np.zeros_like(th), th], -1),
        dtype=torch.float32, device=device)


class ClippedAdam:
    """optax.chain(clip_by_global_norm(1.0), adam(lr)) on one tensor:
    ``step(grad)`` moves ``param`` (a descent step on ``grad``) and returns
    the update it applied."""

    def __init__(self, y: torch.Tensor, lr: float, max_norm: float = 1.0):
        self.param = y.detach().clone()
        self.max_norm = max_norm
        self.opt = torch.optim.Adam([self.param], lr=lr)

    def step(self, grad: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt((grad * grad).sum())
        if not bool(norm < self.max_norm):
            grad = (grad / norm) * self.max_norm
        before = self.param.detach().clone()
        self.param.grad = grad.detach().clone()
        self.opt.step()
        return self.param.detach() - before


def mean_objective(y: torch.Tensor, scene_base: Scene2D, xy: torch.Tensor,
                   objective: str, steps: int = SIM.steps_2d,
                   calib: Optional[engine2d.Calib] = None,
                   checkpointed: bool = False) -> torch.Tensor:
    """The whitened task objective of designs y (..., 2, 7), averaged over
    ``num_rot`` orientations at jittered origins xy (..., num_rot, 2) ->
    (...). ``scene_base`` broadcasts against y's leading dims; its coefs are
    rebuilt from y. ``checkpointed`` recomputes each step in the backward
    pass instead of keeping its graph."""
    dev = y.device
    obj_fn = SIMPLE_OBJECTIVES[objective]
    inv_std = 1.0 / torch.tensor(NORM.std_2d, dtype=torch.float32,
                                 device=dev)
    thetas = pose_grid(xy.shape[-2], dev)[:, 2]
    ctrl = torch.tensor([SIM.ctrl_2d, -SIM.ctrl_2d], dtype=torch.float32,
                        device=dev)

    def step_fn(scene, state):
        return engine2d.step(scene, state, ctrl, SIM.dt, None, calib)

    sc = scene_with_y(scene_base, y[..., 0, None, :], y[..., 1, None, :],
                      _coef_operator(dev))
    pose = torch.cat([xy, thetas.expand(xy.shape[:-1])[..., None]], -1)
    state = engine2d.init_state(sc, pose)
    for _ in range(steps):
        state = (checkpoint(step_fn, sc, state, use_reentrant=False)
                 if checkpointed else step_fn(sc, state))
    dth = engine2d._wrap(state.theta - thetas)
    dpos = engine2d._origin_of(sc, state) - pose[..., :2]
    d = torch.stack([dth, dpos[..., 0], dpos[..., 1]], -1) * inv_std
    return obj_fn(d).mean(-1)


def design_gradient_2d(
    yl0: np.ndarray,
    yr0: np.ndarray,
    contour: np.ndarray,
    objective: str = "rotate_clockwise",
    num_rot: int = 36,
    steps: int = SIM.steps_2d,
    iters: int = 40,
    lr: float = 1e-3,
    pos_jitter: float = 0.004,
    calib: Optional[engine2d.Calib] = None,
    seed: int = 0,
    method: str = "smoothed",
    sigma: float = 2e-3,
    num_pairs: int = 4,
    holdout_draws: int = 8,
    device="cuda",
) -> Dict:
    """Optimise the 2x7 finger control points against the simulated task
    objective on one object, on ``device``.

    Returns {"y": best design (2, n), "y_final": last iterate, "y0": start,
    "history": per-iter training objective, "holdout": per-candidate
    held-out objective (index 0 = start), "best_iter": -1 if the start
    won, "objectives": per-iter mean objective of each smoothing candidate
    (smoothed only), "grad_norms": per-iter global norm of the gradient
    estimate before clipping}."""
    if method not in ("smoothed", "backprop"):
        raise ValueError(f"unknown method {method!r}")
    g = GRIPPER_2D
    dev = torch.device(device)
    obj = dict(objective=objective, steps=steps, calib=calib)

    def host_scene(c: np.ndarray) -> Scene2D:
        return engine2d.make_scene(c[0].astype(np.float64),
                                   c[1].astype(np.float64), contour)

    y = torch.as_tensor(np.stack([yl0, yr0]), dtype=torch.float32,
                        device=dev)
    y0 = y.cpu().numpy().copy()
    opt = ClippedAdam(y, lr)
    rs = np.random.RandomState(seed)
    # held-out jitter draws: fixed for the whole run, disjoint RNG stream
    xy_hold = torch.as_tensor(
        np.random.RandomState(seed + 10_000).uniform(
            -pos_jitter, pos_jitter, (holdout_draws, num_rot, 2)),
        dtype=torch.float32, device=dev)

    history, objectives, grad_norms = [], [], []
    iterates = [y0]
    for _ in range(iters):
        # the host-side hull mass at the CURRENT control points
        scene_base = to_device(host_scene(y.cpu().numpy()), dev)
        if method == "smoothed":
            xi = rs.normal(size=(num_pairs,) + tuple(y.shape)).astype(
                np.float32)
            xy = torch.as_tensor(
                rs.uniform(-pos_jitter, pos_jitter,
                           (2 * num_pairs, num_rot, 2)),
                dtype=torch.float32, device=dev)
            xi_t = torch.as_tensor(xi, device=dev)
            cands = torch.clamp(
                torch.cat([y[None] + sigma * xi_t, y[None] - sigma * xi_t]),
                g.ctrl_y_min, g.ctrl_y_max)
            with torch.no_grad():
                fv = mean_objective(cands, scene_base, xy,
                                    **obj).cpu().numpy()
            fp, fm = fv[:num_pairs], fv[num_pairs:]
            # negated: the optimiser descends
            grad = -torch.as_tensor(np.einsum(
                "e,e...->...", (fp - fm) / (2 * sigma * num_pairs), xi),
                device=dev)
            history.append(float(fv.mean()))
            objectives.append(fv)
        else:
            xy = torch.as_tensor(
                rs.uniform(-pos_jitter, pos_jitter, (num_rot, 2)),
                dtype=torch.float32, device=dev)
            yv = y.detach().clone().requires_grad_(True)
            val = mean_objective(yv, scene_base, xy, checkpointed=True,
                                 **obj)
            val.backward()
            grad = -yv.grad
            history.append(float(val.detach()))
        grad_norms.append(float(torch.sqrt((grad * grad).sum())))
        opt.step(grad)
        # projected ascent: control points stay in the generator's range
        with torch.no_grad():
            opt.param.clamp_(g.ctrl_y_min, g.ctrl_y_max)
        y = opt.param.detach().clone()
        iterates.append(y.cpu().numpy().copy())

    # paired held-out selection over (start + every iterate), each under its
    # own host hull mass, on the shared fixed draws: one batched pass
    stacked = to_device(datagen.stack_scenes(
        [host_scene(c) for c in iterates]), dev)
    with torch.no_grad():
        hold = mean_objective(
            torch.as_tensor(np.stack(iterates), device=dev)[:, None],
            engine2d.expand_scene(stacked, 2), xy_hold[None],
            **obj).mean(-1).cpu().numpy()
    best = int(np.argmax(hold))
    return {
        "y": iterates[best],
        "y_final": y.cpu().numpy(),
        "y0": y0,
        "history": history,
        "holdout": hold.tolist(),
        "best_iter": best - 1,
        "objectives": objectives,
        "grad_norms": grad_norms,
    }
