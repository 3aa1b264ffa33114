"""Batched interaction-profile rollouts — port of ``dgdm_tpu/sim/datagen.py``
(``stack_scenes``, ``profile_pairs_2d``, ``fetch_pairs_2d``).

The 9,000-pose datagen grid (360 x 5 x 5, 200 steps) runs for a stacked
batch of pairs through the rollout kernel, the pose axis padded with the last
pose to a multiple of 128 exactly as the JAX caller pads it (padded lanes
vote in the last block's gates). ``generate_2d``, its npz writer and the
pipeline wait for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dgdm_tpu_torch.sim import engine2d, rollout2d
from dgdm_tpu_torch.sim.types import Scene2D


def stack_scenes(scenes: Sequence[Scene2D]) -> Scene2D:
    """Stack Scene2D or Scene3D pairs along a new leading dimension."""
    cls = type(scenes[0])
    return cls(**{f.name: torch.stack([getattr(s, f.name) for s in scenes])
                  for f in dataclasses.fields(cls)})


def pad_poses(poses: np.ndarray, lane: int = rollout2d.LANE) -> np.ndarray:
    """Pad the pose axis with the last pose to a multiple of ``lane``."""
    pad = (-poses.shape[0]) % lane
    if not pad:
        return poses
    filler = np.broadcast_to(poses[-1], (pad,) + poses.shape[1:])
    return np.concatenate([poses, filler], axis=0)


def profile_pairs_2d(
    scenes: Scene2D,
    poses: np.ndarray,
    calib: Optional[engine2d.Calib] = None,
    block: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Run the full pose grid for a stacked scene batch on ``device``.

    Returns dict with delta_theta (B, N), delta_pos (B, N, 2), final_theta.
    With ``block=False`` the values stay device tensors (pose axis still
    padded; CUDA launches are asynchronous) plus ``n`` — materialize with
    ``fetch_pairs_2d``."""
    n = poses.shape[0]
    arrs = rollout2d.scene_arrays(scenes, calib=calib, device=device)
    poses_p = torch.as_tensor(
        np.ascontiguousarray(pad_poses(poses)), dtype=torch.float32
    ).to(device)
    dth, dpos, fth, _ = rollout2d.profile_batch(*arrs, poses_p)
    res = {"delta_theta": dth, "delta_pos": dpos, "final_theta": fth, "n": n}
    return res if not block else fetch_pairs_2d(res)


def fetch_pairs_2d(res: Dict) -> Dict[str, np.ndarray]:
    """Materialize a ``profile_pairs_2d(..., block=False)`` result."""
    n = res["n"]
    return {k: res[k][:, :n].cpu().numpy()
            for k in ("delta_theta", "delta_pos", "final_theta")}
