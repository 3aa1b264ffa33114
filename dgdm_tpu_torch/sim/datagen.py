"""Batched interaction-profile data generation — port of
``dgdm_tpu/sim/datagen.py``.

The 9,000-pose datagen grid (360 x 5 x 5, 200 steps) runs for a stacked batch
of pairs through the rollout kernel, the pose axis padded with the last pose
to a multiple of 128 exactly as the JAX caller pads it (padded lanes vote in
the last block's gates). Results stream back as npz shards in the format the
reference's ``DynamicsDataset`` consumes (``dynamics/dataloader.py:40-79``:
a dict under ``arr_0`` with keys ``ctrlpts, allpts, object_vertices,
obj_pos, obj_theta, delta_theta, delta_pos``); a shard written by either
package loads in the other.

``profile_pairs_2d(..., block=False)`` returns right after the launch: the
scene went up through pinned memory, and the results' copies into pinned
host buffers are queued behind the kernel with an event, so that
``fetch_pairs_2d`` waits for this batch alone (``core/transfer.py``);
``sim/pipeline.py`` bakes the next batch meanwhile. ``use_pallas=False``
runs the pure engine (``engine2d.profile_batch``) instead, ``chunk`` poses at
a time, as the JAX package's calibrated path does.

In a multi-process run (``parallel/distributed.py``) the pairs split over
the dp ranks when their count divides the world: rank r runs its
contiguous block on its own device, and the fetch all-gathers the blocks,
so every rank returns the whole result, as JAX's global array is. When the
count does not divide, every rank runs all pairs (JAX's single-device
fallback).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dgdm_tpu_torch.core.config import GRIPPER_2D, SIM
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.core.transfer import Stamp, download_async, upload, wait
from dgdm_tpu_torch.geom.fingers import ctrlpts_2d, sample_gripper_2d
from dgdm_tpu_torch.geom.spline import cubic_basis_matrix
from dgdm_tpu_torch.parallel import mesh as meshlib
from dgdm_tpu_torch.sim import engine2d, rollout2d
from dgdm_tpu_torch.sim.types import Scene2D, to_device

OUT_KEYS_2D = ("delta_theta", "delta_pos", "final_theta")


def stack_scenes(scenes: Sequence[Scene2D]) -> Scene2D:
    """Stack Scene2D or Scene3D pairs along a new leading dimension (a field
    that is None in every pair, as ``Scene3D.hgrid`` before the pure engine
    fills it, stays None)."""
    cls = type(scenes[0])
    out = {}
    for f in dataclasses.fields(cls):
        vals = [getattr(s, f.name) for s in scenes]
        out[f.name] = (None if all(v is None for v in vals)
                       else torch.stack(vals))
    return cls(**out)


def pad_poses(poses: np.ndarray, lane: int = rollout2d.LANE) -> np.ndarray:
    """Pad the pose axis with the last pose to a multiple of ``lane``."""
    pad = (-poses.shape[0]) % lane
    if not pad:
        return poses
    filler = np.broadcast_to(poses[-1], (pad,) + poses.shape[1:])
    return np.concatenate([poses, filler], axis=0)


def dp_split(batch):
    """(dp mesh, this rank's block of ``batch``): a tree of arrays or a
    stacked scene batch, split over the dp ranks when its leading
    dimension divides the world; (None, batch) otherwise and in one
    process."""
    mesh = meshlib.data_parallel_mesh()
    b = meshlib.leaves(batch)[0].shape[0]
    if mesh is None or b % mesh.size("dp"):
        return None, batch
    return mesh, meshlib.shard_batch(mesh, batch)


def launch(run, outputs: Sequence[str], poses: np.ndarray, device,
           mesh=None):
    """Upload the padded poses, run ``run(poses_tensor)`` (the kernel
    launch, returning tensors named ``outputs``), and queue the results'
    copies to the host -> a pending result for ``fetch``, which gathers
    the pair blocks over ``mesh``'s dp ranks."""
    poses_p = upload(pad_poses(poses), device, torch.float32)
    start = Stamp(device)
    outs = run(poses_p)
    end = Stamp(device)
    host, ready = download_async(dict(zip(outputs, outs)))
    return {**host, "n": poses.shape[0], "ready": ready,
            "launch": (start, end), "mesh": mesh}


def fetch(res: Dict, keys: Sequence[str]) -> List[np.ndarray]:
    """Wait for a pending result's copies; its arrays cut to the unpadded
    pose count, every dp rank's pairs gathered in order."""
    wait(res["ready"])
    n = res["n"]
    return [meshlib.all_gather_rows(res["mesh"], res[k][:, :n].numpy())
            for k in keys]


def kernel_seconds(res: Dict) -> float:
    """Device time of the launch behind a fetched result."""
    start, end = res["launch"]
    return start.seconds_to(end)


def kernel_done(res: Dict) -> bool:
    """Whether the launch behind a pending result has finished (no wait)."""
    return res["launch"][1].done()


def gap_seconds(res: Dict, later: Dict) -> float:
    """Device time from the end of ``res``'s launch to the start of
    ``later``'s: how long the device waited for the host between them."""
    return res["launch"][1].seconds_to(later["launch"][0])


def profile_pairs_2d(
    scenes: Scene2D,
    poses: np.ndarray,
    chunk: int = 1500,
    calib: Optional[engine2d.Calib] = None,
    use_pallas: bool = True,
    block: bool = True,
    device="cuda",
) -> Dict:
    """Run the full pose grid for a stacked scene batch on ``device``.

    Default path: the rollout kernel (its plain version for CPU tensors),
    the pose batch padded to a multiple of 128; the host arrays and their
    pinned uploads are the ``datagen.arrays`` span. ``use_pallas=False``:
    the pure engine, ``chunk`` poses a call (bounds the live
    intermediates).

    Returns dict with delta_theta (B, N), delta_pos (B, N, 2), final_theta.
    With ``block=False`` it returns once the work is queued (CUDA launches
    are asynchronous): materialize with ``fetch_pairs_2d``. In a
    multi-process run each dp rank runs its block of the pairs (module
    docstring)."""
    mesh, scenes = dp_split(scenes)
    if use_pallas:
        with TRACER.span("datagen.arrays"):
            arrs = rollout2d.scene_arrays(scenes, calib=calib, device=device)

        def run(p):
            return rollout2d.profile_batch(*arrs, p)[:3]
    else:
        n = poses.shape[0]
        sc = to_device(scenes, device)

        def run(p):
            outs = [engine2d.profile_batch(sc, p[lo:min(lo + chunk, n)],
                                           calib=calib)
                    for lo in range(0, n, chunk)]
            return [torch.cat([o[k] for o in outs], dim=1) for k in range(3)]
    res = launch(run, OUT_KEYS_2D, poses, device, mesh)
    return res if not block else fetch_pairs_2d(res)


def fetch_pairs_2d(res: Dict) -> Dict[str, np.ndarray]:
    """Materialize a ``profile_pairs_2d(..., block=False)`` result."""
    return dict(zip(OUT_KEYS_2D, fetch(res, OUT_KEYS_2D)))


def _curve_points(yl: np.ndarray, yr: np.ndarray) -> np.ndarray:
    """(400, 2) dense curve samples = reference `allpts`
    (assets/finger_sampler.py:38-50)."""
    g = GRIPPER_2D
    xq = np.linspace(g.ctrl_x_min, g.ctrl_x_max, g.num_curve_points)
    basis = cubic_basis_matrix(g.num_ctrl, g.ctrl_x_min, g.ctrl_x_max, xq)
    pts_l = np.stack([xq, basis @ yl], -1)
    pts_r = np.stack([xq, basis @ yr], -1)
    return np.concatenate([pts_l, pts_r], axis=0)


def pose_fields(poses: np.ndarray):
    """(obj_pos (N, 3), obj_theta (N,)) float32 of a pose grid, as every
    record of it stores them."""
    obj_pos = np.concatenate(
        [poses[:, :2], np.zeros((poses.shape[0], 1))], axis=1
    ).astype(np.float32)
    return obj_pos, poses[:, 2].astype(np.float32)


def make_record(ctrlpts, allpts, obj: Dict, obj_pos, theta0, dth,
                dpos) -> Dict:
    """One pair's shard in the reference layout; ``obj`` holds the object's
    key (2D ``object_vertices``, 3D ``object_name``)."""
    return {
        "ctrlpts": ctrlpts,
        "allpts": allpts,
        **obj,
        "obj_pos": obj_pos,
        "obj_theta": theta0,
        "delta_theta": dth.astype(np.float32),
        "delta_pos": np.concatenate(
            [dpos, np.zeros((dpos.shape[0], 1))], axis=1).astype(np.float32),
    }


def shard_path(save_dir: str, object_idx: int, gripper_idx: int) -> str:
    return os.path.join(save_dir, "%d_%d.npz" % (object_idx, gripper_idx))


def generate_2d(
    object_idx: int,
    contour: np.ndarray,
    gripper_indices: Sequence[int],
    save_dir: Optional[str] = None,
    grid_size: int = SIM.grid_size,
    num_pos: int = SIM.num_pos,
    calib: Optional[engine2d.Calib] = None,
    device="cuda",
) -> List[Dict[str, np.ndarray]]:
    """Profiles for one object x a block of (seed-indexed) grippers.

    Mirrors one shell iteration of ``sim/run_sim_2d.sh`` (512 grippers x 1
    object) as a single device batch. If ``save_dir`` is given, writes
    ``{object_idx}_{gripper_idx}.npz`` shards in the reference layout.
    """
    grips = [sample_gripper_2d(i) for i in gripper_indices]
    scenes = stack_scenes(
        [engine2d.make_scene(yl, yr, contour) for yl, yr in grips]
    )
    poses = engine2d.pose_grid(grid_size=grid_size, num_pos=num_pos)
    out = profile_pairs_2d(scenes, poses, calib=calib, device=device)
    obj_pos, theta0 = pose_fields(poses)
    obj = {"object_vertices": np.asarray(contour, dtype=np.float32)}
    records = []
    for b, (gi, (yl, yr)) in enumerate(zip(gripper_indices, grips)):
        rec = make_record(ctrlpts_2d(yl, yr).astype(np.float32),
                          _curve_points(yl, yr).astype(np.float32), obj,
                          obj_pos, theta0, out["delta_theta"][b],
                          out["delta_pos"][b])
        records.append(rec)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            np.savez_compressed(shard_path(save_dir, object_idx, gi), rec)
    return records


def throughput_workload(
    num_pairs: int = 32,
    grid_size: int = SIM.grid_size,
    num_pos: int = SIM.num_pos,
    chunk: int = 1500,
    contour: Optional[np.ndarray] = None,
    use_pallas: bool = True,
    device="cuda",
):
    """A ready-to-run closure for timing rollout throughput -> (run,
    rollouts per call); ``chunk``/``use_pallas`` as ``profile_pairs_2d``."""
    if contour is None:
        # deterministic synthetic object (no Icons-50 needed)
        ang = np.linspace(0, 2 * np.pi, 100, endpoint=False)
        rad = 0.035 * (1 + 0.25 * np.sin(3 * ang) + 0.1 * np.sin(7 * ang))
        contour = np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    grips = [sample_gripper_2d(i) for i in range(num_pairs)]
    scenes = stack_scenes(
        [engine2d.make_scene(yl, yr, contour) for yl, yr in grips]
    )
    poses = engine2d.pose_grid(grid_size=grid_size, num_pos=num_pos)

    def run():
        return profile_pairs_2d(scenes, poses, chunk=chunk,
                                use_pallas=use_pallas, device=device)

    return run, num_pairs * poses.shape[0]
