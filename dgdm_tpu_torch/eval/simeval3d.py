"""3D simulation-in-the-loop evaluation — port of
``dgdm_tpu/eval/simeval3d.py`` (``eval_rollout_batch_3d``,
``sim_eval_batch_3d``).

Counterpart of ``dynamics/sim_test_mj_3d.py:94-277``: 360 orientations x
32,000 steps with the jaws and velocities reset every 800 steps, the profile
recorded after the first squeeze (t = 800) and the final pose at the end —
one launch of the rollout kernel per object, all grippers batched, with the
contact solver of ``engine3d.SOLVER3``. ``eval_rollout_batch_3d`` runs the
same schedule through the pure engine. In a multi-process run both split
the grippers over the dp ranks and gather the outputs, as
``eval/simeval.py`` does.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from dgdm_tpu_torch.core.config import NORM, SIM
from dgdm_tpu_torch.eval.metrics import three_class, wrap_pi
from dgdm_tpu_torch.geom.fingers import denormalize_y
from dgdm_tpu_torch.parallel.mesh import all_gather_rows
from dgdm_tpu_torch.sim import datagen, engine3d, rollout3d


def eval_rollout_batch_3d(
    scenes,
    thetas: torch.Tensor,
    first_squeeze: int = SIM.eval_regrasp_3d,
    total_steps: int = SIM.eval_steps_3d,
    regrasp_every: int = SIM.eval_regrasp_3d,
):
    """The verification schedule on the pure engine. scenes: stacked pair
    batch (B) of Scene3D (its height grid is filled here if unset); thetas
    (G,) initial orientations at position (0, 0), on the scenes' device.

    Returns per (B, G): delta_theta/delta_pos after the first squeeze and
    final_theta/final_pos after the full re-grasp schedule (in a
    multi-process run each dp rank rolls out its block of the pairs and
    every rank returns all of them)."""
    if not 0 < first_squeeze <= total_steps:
        raise ValueError(f"first_squeeze {first_squeeze} must lie in "
                         f"(0, total_steps = {total_steps}]")
    mesh, scenes = datagen.dp_split(scenes)
    sc = engine3d.expand_scene3(engine3d.with_hgrid(scenes), 1)
    zero = torch.zeros_like(thetas)
    pose = torch.stack([zero, zero, thetas], -1)
    state = engine3d.init_state(sc, pose)
    ctrl = torch.tensor([SIM.ctrl_3d, -SIM.ctrl_3d], dtype=torch.float32,
                        device=thetas.device)
    d_theta = d_pos = None
    for i in range(total_steps):
        rg = regrasp_every > 0 and i % regrasp_every == 0 and i > 0
        state = engine3d.step(sc, state, ctrl, regrasp=rg)
        if i + 1 == first_squeeze:
            d_theta, d_pos = engine3d._readout(sc, state, pose)[:2]
    final_theta = engine3d._z_angle(state.quat)
    final_pos = engine3d._readout(sc, state, pose)[1]
    return tuple(all_gather_rows(mesh, t)
                 for t in (d_theta, d_pos, final_theta, final_pos))


def sim_eval_batch_3d(
    pts_y: np.ndarray,
    objects: Sequence,
    num_rot: int = 360,
    ori_range=(-1.0, 1.0),
    total_steps: int = SIM.eval_steps_3d,
    regrasp_every: int = SIM.eval_regrasp_3d,
    calib=None,
    device="cuda",
) -> List[Dict[str, np.ndarray]]:
    """pts_y (B, 42[, 1]) normalized samples; objects: list of (verts, faces).

    Returns metric dicts (object-major), same keys/units as the 2D eval."""
    pts_y = np.asarray(pts_y)
    if pts_y.ndim == 3:
        pts_y = pts_y[..., 0]
    b = pts_y.shape[0]
    n = pts_y.shape[1] // 2
    y = np.asarray(denormalize_y(pts_y, fingers_3d=True))
    thetas = (
        np.linspace(ori_range[0], ori_range[1], num_rot) * np.pi + np.pi
    ).astype(np.float32)
    th_p = datagen.pad_poses(thetas[:, None], rollout3d.LANE)[:, 0]
    poses = torch.as_tensor(
        np.stack([np.zeros_like(th_p), np.zeros_like(th_p), th_p], -1)
    ).to(device)
    th3 = NORM.threshold_3d

    mesh, y_local = datagen.dp_split(y)
    results = []
    for verts, faces in objects:
        # object host work shared across the gripper batch
        obj_props = engine3d.object_properties_3d(verts, faces)
        stacked = datagen.stack_scenes([
            engine3d.make_scene(yi[:n], yi[n:], verts, faces,
                                obj_props=obj_props)
            for yi in y_local])
        arrs = rollout3d.scene_arrays_3d(stacked, calib=calib, device=device)
        d_theta, d_pos, f_theta, _valid, f_pos = (
            all_gather_rows(mesh, t[:, :num_rot].cpu().numpy())
            for t in rollout3d.profile_batch(
                *arrs, poses, steps=total_steps,
                regrasp_every=regrasp_every, snapshot_step=regrasp_every))
        for i in range(b):
            fdt = np.asarray(
                [wrap_pi(f - t0) for f, t0 in zip(f_theta[i], thetas)]
            )
            results.append(
                {
                    "delta_theta": d_theta[i] * 180 / np.pi,
                    "delta_pos": np.concatenate(
                        [d_pos[i], np.zeros((num_rot, 1))], -1
                    ) * 100,
                    "profile": three_class(d_theta[i], th3[0]),
                    "profile_x": three_class(d_pos[i][:, 0], th3[1]),
                    "profile_y": three_class(d_pos[i][:, 1], th3[2]),
                    "final_theta": f_theta[i] * 180 / np.pi,
                    "final_delta_theta": fdt * 180 / np.pi,
                    # eval poses start at the origin: the final delta is the
                    # absolute origin
                    "final_pos": np.concatenate(
                        [f_pos[i], np.zeros((num_rot, 1))], -1
                    ) * 100,
                }
            )
    return results
