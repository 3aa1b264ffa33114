"""3D interaction-profile data generation — port of
``dgdm_tpu/sim/datagen3d.py`` (reference ``sim/sim_3d.py`` +
``sim/run_sim_3d.sh``: 300 objects x 2000 grippers, 800-step rollouts,
tip-over give-up).

Objects are watertight meshes (``model.obj`` per object directory). The
give-up semantics (``sim/sim_3d.py:159-161``) are per-rollout validity
masks; a pair's record is only written when ALL its rollouts stay upright,
the reference's all-or-nothing output. One ``object_properties_3d`` per
object is shared by a gripper block, so K2 runs at its 256 contact points.
``profile_pairs_3d(use_pallas=False)`` runs the pure engine instead
(``engine3d.profile_batch``), ``pose_chunk`` poses a call, as the JAX
package does off the TPU. Both routes split the pairs over the dp ranks of
a multi-process run as ``sim/datagen.py`` does.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dgdm_tpu_torch.core.config import GRIPPER_3D, SIM
from dgdm_tpu_torch.geom.fingers import ctrlpts_3d, sample_gripper_3d
from dgdm_tpu_torch.geom.spline import (
    bspline_basis,
    clamped_knot_vector,
    gripper3d_surface,
)
from dgdm_tpu_torch.sim import engine3d, rollout3d
from dgdm_tpu_torch.sim.datagen import (
    dp_split,
    fetch,
    launch,
    make_record,
    pose_fields,
    shard_path,
    stack_scenes,
)
from dgdm_tpu_torch.sim.engine2d import Calib, pose_grid
from dgdm_tpu_torch.sim.types import to_device

OUT_KEYS_3D = ("delta_theta", "delta_pos", "valid")


@functools.lru_cache(maxsize=4)
def _surface_grid_const(sample_size: int):
    """Gripper-independent pieces of :func:`surface_points_3d` — the basis
    operator and the geomdl grid x/z lattices — as host numpy."""
    g = GRIPPER_3D
    basis = gripper3d_surface().grid_basis(sample_size).numpy()
    uu = np.linspace(0, 1, sample_size)
    bu = bspline_basis(g.degree_u, clamped_knot_vector(g.degree_u, g.nu), g.nu,
                       uu)
    bv = bspline_basis(g.degree_v, clamped_knot_vector(g.degree_v, g.nv), g.nv,
                       uu)
    xs = bu @ np.linspace(g.ctrl_x_min, g.ctrl_x_max, g.nu)
    zs = bv @ np.linspace(g.ctrl_z_min, g.ctrl_z_max, g.nv)
    xg = np.repeat(xs, sample_size)
    zg = np.tile(zs, sample_size)
    return basis, xg, zg


def surface_points_3d(yl: np.ndarray, yr: np.ndarray,
                      sample_size: int = 25) -> np.ndarray:
    """Reference `allpts`: both finger surfaces evaluated on the geomdl grid
    (assets/finger_3d.py:59-67): (2 * sample_size^2, 3)."""
    basis, xg, zg = _surface_grid_const(sample_size)
    out = []
    for y in (yl, yr):
        yg = basis @ np.asarray(y).reshape(-1)
        out.append(np.stack([xg, yg, zg], -1))
    return np.concatenate(out, 0)


def profile_pairs_3d(
    stacked,
    poses: np.ndarray,
    steps: int = SIM.steps_3d,
    calib: Optional[Calib] = None,
    block: bool = True,
    device="cuda",
    use_pallas: bool = True,
    pose_chunk: int = 450,
):
    """Full pose grid for a stacked 3D scene batch -> (dth, dpos, valid),
    each (B, N) (dpos (B, N, 2)). Default path: the rollout kernel (its
    plain version for CPU tensors), the pose batch padded to a multiple of
    128. ``use_pallas=False``: the pure engine on the scenes' baked height
    grids, ``pose_chunk`` poses a call. With ``block=False`` it returns once
    the work is queued; materialize with ``fetch_pairs_3d``. In a
    multi-process run each dp rank runs its block of the pairs."""
    mesh, stacked = dp_split(stacked)
    if use_pallas:
        arrs = rollout3d.scene_arrays_3d(stacked, calib=calib,
                                         device=device)

        def run(p):
            dth, dpos, _, valid, _ = rollout3d.profile_batch(*arrs, p,
                                                             steps=steps)
            return dth, dpos, valid
    else:
        n = poses.shape[0]
        sc = to_device(engine3d.with_hgrid(stacked), device)

        def run(p):
            outs = [engine3d.profile_batch(sc, p[lo:min(lo + pose_chunk, n)],
                                           steps=steps, calib=calib)
                    for lo in range(0, n, pose_chunk)]
            return [torch.cat([o[k] for o in outs], dim=1)
                    for k in (0, 1, 3)]

    res = launch(run, OUT_KEYS_3D, poses, device, mesh)
    return res if not block else fetch_pairs_3d(res)


def fetch_pairs_3d(res: Dict):
    """Materialize a ``profile_pairs_3d(..., block=False)`` result."""
    return tuple(fetch(res, OUT_KEYS_3D))


def bake_3d(grips, verts: np.ndarray, faces: np.ndarray):
    """Stacked scenes of one object x a gripper block: one
    ``object_properties_3d`` for the block (256 contact points)."""
    obj_props = engine3d.object_properties_3d(verts, faces)
    return stack_scenes([engine3d.make_scene(yl, yr, verts, faces,
                                             obj_props=obj_props)
                         for yl, yr in grips])


def generate_3d(
    object_idx: int,
    object_name: str,
    verts: np.ndarray,
    faces: np.ndarray,
    gripper_indices: Sequence[int],
    save_dir: Optional[str] = None,
    grid_size: int = SIM.grid_size,
    num_pos: int = SIM.num_pos,
    steps: int = SIM.steps_3d,
    device="cuda",
) -> List[Optional[Dict[str, np.ndarray]]]:
    """Profiles for one object x a block of grippers. Entries are None for
    pairs that tipped the object over (reference give-up)."""
    grips = [sample_gripper_3d(i) for i in gripper_indices]
    stacked = bake_3d(grips, verts, faces)
    poses = pose_grid(grid_size=grid_size, num_pos=num_pos)
    dth, dpos, valid = profile_pairs_3d(stacked, poses, steps=steps,
                                        device=device)
    obj_pos, theta0 = pose_fields(poses)
    records: List[Optional[Dict[str, np.ndarray]]] = []
    for b, (gi, (yl, yr)) in enumerate(zip(gripper_indices, grips)):
        if not valid[b].all():
            records.append(None)  # give up: object not upright
            continue
        rec = make_record(ctrlpts_3d(yl, yr).astype(np.float32),
                          surface_points_3d(yl, yr).astype(np.float32),
                          {"object_name": object_name}, obj_pos, theta0,
                          dth[b], dpos[b])
        records.append(rec)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            np.savez_compressed(shard_path(save_dir, object_idx, gi), rec)
    return records
