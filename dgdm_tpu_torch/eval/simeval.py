"""Simulation-in-the-loop evaluation of generated grippers — port of
``dgdm_tpu/eval/simeval.py`` (``eval_rollout_batch``, ``sim_eval_batch_2d``,
``objectives_table``).

Every (object, gripper) pair is verified with 360 orientations of long
rollouts with periodic re-grasp (jaws and velocities reset every 200 steps,
``dynamics/sim_test_mj.py:165-171``), recording the profile after the first
squeeze (t = 200) and the final converged pose after 8,000 steps — one
launch of the rollout kernel per object, all grippers batched, with the
contact solver of ``engine2d.SOLVER``. ``eval_rollout_batch`` runs the same
schedule through the pure engine.

In a multi-process run (``parallel/distributed.py``) the grippers split
over the dp ranks when their count divides the world: each rank builds the
scenes of its block and launches the kernel on them, and the outputs are
all-gathered before the metrics, so every rank returns every gripper's
metrics (the Ray eval fan-out analog, ``dynamics/sim_test_mj.py:265-282``).
A pair's rollouts do not depend on the other pairs, so the result equals
the one-process result bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dgdm_tpu_torch.core.config import SIM
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.eval.metrics import metric2objective, profile_metrics_2d
from dgdm_tpu_torch.geom.fingers import denormalize_y
from dgdm_tpu_torch.parallel.mesh import all_gather_rows
from dgdm_tpu_torch.sim import datagen, engine2d, rollout2d
from dgdm_tpu_torch.sim.types import Scene2D


def eval_rollout_batch(
    scenes: Scene2D,
    thetas: torch.Tensor,
    first_squeeze: int = SIM.eval_regrasp_2d,
    total_steps: int = SIM.eval_steps_2d,
    regrasp_every: int = SIM.eval_regrasp_2d,
    calib: Optional[engine2d.Calib] = None,
):
    """The verification schedule on the pure engine. scenes: stacked pair
    batch (B); thetas (G,) initial orientations at position (0, 0), on the
    scenes' device.

    Returns per (B, G): delta_theta/delta_pos after the first squeeze and
    final_theta/final_pos after the full re-grasp schedule."""
    if not 0 < first_squeeze <= total_steps:
        raise ValueError(f"first_squeeze {first_squeeze} must lie in "
                         f"(0, total_steps = {total_steps}]")
    sc = engine2d.expand_scene(scenes, 1)
    zero = torch.zeros_like(thetas)
    pose = torch.stack([zero, zero, thetas], -1)
    state = engine2d.init_state(sc, pose)
    ctrl = torch.tensor([SIM.ctrl_2d, -SIM.ctrl_2d], dtype=torch.float32,
                        device=thetas.device)
    d_theta = d_pos = None
    for i in range(total_steps):
        rg = regrasp_every > 0 and i % regrasp_every == 0 and i > 0
        state = engine2d.step(sc, state, ctrl, regrasp=rg, calib=calib)
        if i + 1 == first_squeeze:
            # the profile measurement at t = first_squeeze
            d_theta = engine2d._wrap(state.theta - thetas)
            d_pos = engine2d._origin_of(sc, state) - pose[..., :2]
    final_theta = torch.remainder(state.theta, 2.0 * math.pi)
    final_pos = engine2d._origin_of(sc, state)
    return d_theta, d_pos, final_theta, final_pos


def _eval_inputs(pts_y, num_rot, ori_range, device):
    """(this rank's denormalized designs, the orientations, the padded
    pose grid on ``device``, the mesh) of ``sim_eval_batch_2d``."""
    y = np.asarray(denormalize_y(pts_y))
    thetas = (
        np.linspace(ori_range[0], ori_range[1], num_rot) * np.pi + np.pi
    ).astype(np.float32)
    th_p = datagen.pad_poses(thetas[:, None])[:, 0]
    poses = torch.as_tensor(
        np.stack([np.zeros_like(th_p), np.zeros_like(th_p), th_p], -1)
    ).to(device)
    mesh, y_local = datagen.dp_split(y)
    return y_local, thetas, poses, mesh


def sim_eval_batch_2d(
    pts_y: np.ndarray,
    contours: Sequence[np.ndarray],
    num_rot: int = 360,
    ori_range=(-1.0, 1.0),
    total_steps: int = SIM.eval_steps_2d,
    regrasp_every: int = SIM.eval_regrasp_2d,
    calib=None,
    device="cuda",
) -> List[Dict[str, np.ndarray]]:
    """Evaluate normalized diffusion samples against objects.

    pts_y: (B, 2*n_ctrl) or (B, 2*n_ctrl, 1) normalized y in [-1, 1].
    Returns a metric dict per (object, gripper), object-major like
    ``sim_test_batch`` (``dynamics/sim_test_mj.py:249-295``)."""
    pts_y = np.asarray(pts_y)
    if pts_y.ndim == 3:
        pts_y = pts_y[..., 0]
    b = pts_y.shape[0]
    n = pts_y.shape[1] // 2
    results, inputs = [], None
    for contour in contours:
        with TRACER.span("simeval.scenes"):
            if inputs is None:      # once, in the first object's span
                inputs = _eval_inputs(pts_y, num_rot, ori_range, device)
            y_local, thetas, poses, mesh = inputs
            stacked = datagen.stack_scenes(
                [engine2d.make_scene(yi[:n], yi[n:], contour)
                 for yi in y_local])
        with TRACER.span("simeval.arrays"):
            arrs = rollout2d.scene_arrays(stacked, calib=calib,
                                          device=device)
        with TRACER.span("simeval.rollout"):
            outs = rollout2d.profile_batch(
                *arrs, poses, steps=total_steps,
                regrasp_every=regrasp_every, snapshot_step=regrasp_every)
        with TRACER.span("simeval.fetch"):
            dth, dpos, fth, fpos = (
                all_gather_rows(mesh, t[:, :num_rot].cpu().numpy())
                for t in outs)
        with TRACER.span("simeval.metrics"):
            for i in range(b):
                results.append(
                    profile_metrics_2d(
                        dth[i],
                        np.concatenate([dpos[i], np.zeros((num_rot, 1))],
                                       -1),
                        fth[i],
                        thetas,
                        np.concatenate([fpos[i], np.zeros((num_rot, 1))],
                                       -1),
                    )
                )
    return results


def objectives_table(
    metrics: List[Dict[str, np.ndarray]], objective: str
) -> List[Dict]:
    return [metric2objective(m, objective) for m in metrics]
