"""Data pipelines — port of ``dgdm_tpu/train/data.py``.

- ``DynamicsData`` / ``DynamicsData3D``: load interaction-profile npz shards
  (the reference layout, ``dynamics/dataloader.py:40-79``) into dense
  normalized rows.
- ``procedural_grippers``: the diffusion training set — regenerated from
  RandomState seeds exactly like ``generator/train.py:42-58`` (the seed IS
  the dataset; nothing is stored).

Everything here is numpy. Shard order and batch contents depend only on the
``np.random.RandomState`` passed in, so a seed gives the same batches as the
JAX package, bit for bit. ``to_device`` moves a batch onto the trainer's
device.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from dgdm_tpu_torch.core.config import GRIPPER_2D, GRIPPER_3D, NORM
from dgdm_tpu_torch.core.transfer import upload
from dgdm_tpu_torch.geom.fingers import normalize_y, sample_grippers_batch


def normalize_record_2d(
    rec: Dict[str, np.ndarray], object_max_num_vertices: int = 100
) -> Dict[str, np.ndarray]:
    """One npz record -> per-pose normalized training rows.

    Output: ctrl (N, 14) y-only in [-1,1]; ori (N, 1); pos (N, 2);
    obj (N, 2*V) flattened contour; score (N, 3) whitened."""
    g, nm = GRIPPER_2D, NORM
    n = rec["obj_theta"].shape[0]
    y = rec["ctrlpts"][:, 1]
    ctrl = (y - g.ctrl_y_min) / (g.ctrl_y_max - g.ctrl_y_min) * 2.0 - 1.0
    ctrl = np.broadcast_to(ctrl, (n, ctrl.shape[0]))
    ori = (rec["obj_theta"] / np.pi - 1.0)[:, None]
    pos = rec["obj_pos"][:, :2] / nm.pos_scale
    verts = rec["object_vertices"] / nm.object_extent_2d  # [-1, 1]
    pad = object_max_num_vertices - verts.shape[0]
    if pad > 0:
        verts = np.concatenate([verts, np.zeros((pad, 2))], axis=0)
    obj = np.broadcast_to(verts.reshape(-1), (n, verts.size))
    std = np.asarray(nm.std_2d)
    score = np.stack(
        [
            rec["delta_theta"] / std[0],
            rec["delta_pos"][:, 0] / std[1],
            rec["delta_pos"][:, 1] / std[2],
        ],
        axis=1,
    )
    return {
        "ctrl": ctrl.astype(np.float32),
        "ori": ori.astype(np.float32),
        "pos": pos.astype(np.float32),
        "obj": obj.astype(np.float32),
        "score": score.astype(np.float32),
    }


def mirror_rows_2d(rows: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Mirror-symmetry augmentation for normalized 2D dynamics rows.

    The scene mirrored across the y-axis (x -> -x) is an equally valid
    physical sample whose interaction profile is exactly mirrored (the jaws
    sit at +-y, unchanged). Doubling the dataset this way enforces cw/ccw
    balance in the learned classifier.

    Transform on normalized rows: each finger's y ctrl block reverses along
    x; the contour flips x and reverses vertex order (restoring CCW
    orientation); ori = theta/pi - 1 -> -ori (theta -> 2pi - theta);
    pos_x -> -pos_x; scores (dtheta, dx, dy) -> (-dtheta, -dx, dy).
    """
    ctrl = rows["ctrl"]
    k = ctrl.shape[1] // 2
    ctrl_m = np.concatenate(
        [ctrl[:, :k][:, ::-1], ctrl[:, k:][:, ::-1]], axis=1
    )
    obj = rows["obj"]
    n, f = obj.shape
    verts = obj.reshape(n, f // 2, 2).copy()
    verts[..., 0] *= -1.0
    # Reverse only the REAL-vertex prefix: normalize_record_2d zero-pads the
    # contour tail to object_max_num_vertices, and a full-axis flip would move
    # that padding to the front, changing the layout convention the classifier
    # sees. Padding rows are exactly (0, 0); real contour vertices are
    # (measure-zero) never exactly the origin.
    nonzero = np.any(verts != 0.0, axis=-1)                       # (n, V)
    v = verts.shape[1]
    nv = np.where(nonzero.any(1), v - np.argmax(nonzero[:, ::-1], 1), 0)
    ar = np.arange(v)[None, :]
    idx = np.where(ar < nv[:, None], nv[:, None] - 1 - ar, ar)
    verts = np.take_along_axis(verts, idx[..., None], axis=1)
    score = rows["score"] * np.asarray([-1.0, -1.0, 1.0], np.float32)
    pos = rows["pos"] * np.asarray([-1.0, 1.0], np.float32)
    return {
        "ctrl": np.ascontiguousarray(ctrl_m, np.float32),
        "ori": (-rows["ori"]).astype(np.float32),
        "pos": pos.astype(np.float32),
        "obj": np.ascontiguousarray(verts.reshape(n, f), np.float32),
        "score": score.astype(np.float32),
    }


def _npz_files(dataset_dir: str) -> List[str]:
    files = []
    for root, _, names in os.walk(dataset_dir):
        files += [os.path.join(root, f) for f in names if f.endswith(".npz")]
    return sorted(files)


def load_record(path: str) -> Dict[str, np.ndarray]:
    """One shard: the record dict pickled under ``arr_0``."""
    return np.load(path, allow_pickle=True)["arr_0"].item()


def _batches(load, n_files: int, pairs_per_batch: int,
             rng: np.random.RandomState, shuffle: bool
             ) -> Iterator[Dict[str, np.ndarray]]:
    order = np.arange(n_files)
    if shuffle:
        rng.shuffle(order)
    for lo in range(0, len(order), pairs_per_batch):
        recs = [load(i) for i in order[lo : lo + pairs_per_batch]]
        yield {k: np.concatenate([r[k] for r in recs], axis=0)
               for k in recs[0]}


class DynamicsData:
    """Shard-reading dataset for dynamics training (2D).

    Iterates per-pair shards (each expands to grid_size*num_pos^2 rows) and
    yields concatenated, shuffled row batches."""

    def __init__(self, dataset_dir: str, object_max_num_vertices: int = 100,
                 mirror_augment: bool = False):
        self.files = _npz_files(dataset_dir)
        self.v = object_max_num_vertices
        self.mirror_augment = mirror_augment

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        rows = normalize_record_2d(load_record(self.files[idx]), self.v)
        if self.mirror_augment:
            m = mirror_rows_2d(rows)
            rows = {k: np.concatenate([rows[k], m[k]], 0) for k in rows}
        return rows

    def batches(self, pairs_per_batch: int, rng: np.random.RandomState,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        return _batches(self.load, len(self.files), pairs_per_batch, rng,
                        shuffle)


def normalize_record_3d(
    rec: Dict[str, np.ndarray],
    object_points: np.ndarray,
) -> Dict[str, np.ndarray]:
    """3D npz record -> normalized training rows (dataloader.py:48-66).

    ctrl is the y-row only (the model consumes just that,
    profile_forward_3d.py:78); object_points (P, 3) pre-sampled from the
    object mesh, normalized here."""
    g, nm = GRIPPER_3D, NORM
    n = rec["obj_theta"].shape[0]
    y = rec["ctrlpts"][:, 1]
    ctrl = (y - g.ctrl_y_min) / (g.ctrl_y_max - g.ctrl_y_min) * 2.0 - 1.0
    ctrl = np.broadcast_to(ctrl, (n, ctrl.shape[0]))
    ori = (rec["obj_theta"] / np.pi - 1.0)[:, None]
    pos = rec["obj_pos"][:, :2] / nm.pos_scale
    pts = np.array(object_points, dtype=np.float64)
    e = nm.object_extent_3d_xy
    pts[:, 0] = (pts[:, 0] + e) / (2 * e) * 2.0 - 1.0
    pts[:, 1] = (pts[:, 1] + e) / (2 * e) * 2.0 - 1.0
    pts[:, 2] = (
        (pts[:, 2] - nm.object_z_min_3d)
        / (nm.object_z_max_3d - nm.object_z_min_3d) * 2.0 - 1.0
    )
    obj = np.broadcast_to(pts, (n,) + pts.shape)
    std = np.asarray(nm.std_3d)
    score = np.stack(
        [
            rec["delta_theta"] / std[0],
            rec["delta_pos"][:, 0] / std[1],
            rec["delta_pos"][:, 1] / std[2],
        ],
        axis=1,
    )
    return {
        "ctrl": ctrl.astype(np.float32),
        "ori": ori.astype(np.float32),
        "pos": pos.astype(np.float32),
        "obj": obj.astype(np.float32),
        "score": score.astype(np.float32),
    }


class DynamicsData3D:
    """Shard-reading dataset for 3D dynamics training. Object point clouds are
    sampled once per object name and cached (dataloader.py:55-66)."""

    def __init__(self, dataset_dir: str, object_mesh_dir: str,
                 num_points: int = 512):
        self.files = _npz_files(dataset_dir)
        self.mesh_dir = object_mesh_dir
        self.num_points = num_points
        self._cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.files)

    def _points(self, name: str) -> np.ndarray:
        if name not in self._cache:
            from dgdm_tpu_torch.geom import mesh3d

            verts, faces = mesh3d.load_obj(
                os.path.join(self.mesh_dir, name, "model.obj")
            )
            self._cache[name] = mesh3d.sample_surface(
                verts, faces, self.num_points
            )
        return self._cache[name]

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        rec = load_record(self.files[idx])
        return normalize_record_3d(rec, self._points(str(rec["object_name"])))

    def batches(self, pairs_per_batch: int, rng: np.random.RandomState,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        return _batches(self.load, len(self.files), pairs_per_batch, rng,
                        shuffle)


def procedural_grippers(
    total: int, fingers_3d: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """(train, val) normalized y arrays of shape (n, ctrlpts_dim, 1) with the
    reference's 90/10 deterministic split (generator/train.py:40-41)."""
    ys = sample_grippers_batch(0, total, fingers_3d)   # (N, 2, n_ctrl)
    flat = ys.reshape(total, -1)                        # [yl | yr]
    norm = np.asarray(normalize_y(flat, fingers_3d), dtype=np.float32)
    norm = norm[..., None]
    split = int(total * 0.9)
    return norm[:split], norm[split:]


def to_device(batch, device):
    """A numpy batch (array or dict of arrays) -> float32 tensors on
    ``device`` (uploaded through pinned memory on CUDA)."""
    if isinstance(batch, dict):
        return {k: upload(v, device, torch.float32) for k, v in batch.items()}
    return upload(batch, device, torch.float32)
