"""Software-pipelined production datagen — port of
``dgdm_tpu/sim/pipeline.py``: host work and device work overlap.

Each "wave" is one object x a gripper block. For wave i the host bakes the
scenes, launches the kernel (``profile_pairs_*(..., block=False)``: the
upload comes from pinned memory and the results' copies are queued behind
the kernel with an event), then drains wave i-1: it waits for that wave's
copies alone, assembles its records and hands the npz writes to a bounded
thread pool (zlib releases the interpreter lock). So the bake of wave i+1
and the writes of wave i-1 run while wave i's kernel does.

Reference shape: ``sim/run_sim_2d.sh`` (1,001 objects x 1,000 grippers in
512-pair Ray waves) and ``sim/run_sim_3d.sh`` (300 x 2,000). The summary
each function returns adds to the JAX one the host seconds spent baking,
waiting for results and writing (summed over the writer threads), the
device seconds of the kernels and between them, and the count of drains
that ended while the next kernel still ran, so that the overlap shows.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dgdm_tpu_torch.core.config import SIM
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.geom.fingers import (
    ctrlpts_2d,
    ctrlpts_3d,
    sample_gripper_2d,
    sample_gripper_3d,
)
from dgdm_tpu_torch.sim import datagen, datagen3d, engine2d


class _Writer:
    """npz writes on a thread pool, with the in-flight queue bounded (each
    pending record pins ~1 MB of host arrays; at production scale an
    unbounded queue grows to tens of GB on a slow-writer host) and the
    seconds spent writing summed over the threads."""

    THREADS = 4
    QUEUE_CAP = 512

    def __init__(self):
        self.pool = ThreadPoolExecutor(max_workers=self.THREADS)
        self.pending: List = []
        self.seconds = 0.0
        self._lock = threading.Lock()

    def _write(self, path: str, rec: Dict) -> None:
        with TRACER.span("pipeline.write") as span:
            np.savez_compressed(path, rec)
        with self._lock:
            self.seconds += span.seconds

    def submit(self, path: str, rec: Dict) -> None:
        while len(self.pending) >= self.QUEUE_CAP:
            self.pending.pop(0).result()
        self.pending.append(self.pool.submit(self._write, path, rec))

    def close(self) -> None:
        try:
            for f in self.pending:
                f.result()
        finally:
            self.pool.shutdown()


def _run_waves(items, bake, launch, drain, writer: _Writer, poses,
               pairs_per_wave: int) -> Dict[str, float]:
    """The loop both pipelines share: bake and launch wave i, then drain
    wave i-1. ``drain(item, records_res)`` returns the valid pair count.

    The bake, drain and write seconds are the ``pipeline.bake``,
    ``pipeline.drain`` and ``pipeline.write`` spans' (``core/profiling``).
    Besides the seconds, it counts the drains that ended while the next
    wave's kernel still ran (on the card each one should: a result copy
    queued behind the next kernel would make the drain wait for it), and
    sums the device's idle time between consecutive kernels."""
    t0 = time.perf_counter()
    stats = {"bake_s": 0.0, "wait_s": 0.0, "kernel_s": 0.0, "gap_s": 0.0,
             "waves": 0, "pairs_valid": 0, "drains_under_kernel": 0}

    def finish(item, res, nxt):
        with TRACER.span("pipeline.drain") as span:
            stats["pairs_valid"] += drain(item, res)
        stats["wait_s"] += span.seconds
        if nxt is not None:
            stats["drains_under_kernel"] += not datagen.kernel_done(nxt)
            stats["gap_s"] += datagen.gap_seconds(res, nxt)
        stats["kernel_s"] += datagen.kernel_seconds(res)

    inflight = None
    try:
        for item in items:
            with TRACER.span("pipeline.bake") as span:
                scenes = bake(item)   # overlaps the previous wave's kernel
            stats["bake_s"] += span.seconds
            with TRACER.span("pipeline.launch"):
                res = launch(scenes)
            if inflight is not None:
                finish(*inflight, res)
            inflight = (item, res)
            stats["waves"] += 1
        if inflight is not None:
            finish(*inflight, None)
    finally:
        writer.close()
    dt = time.perf_counter() - t0
    pairs = stats["waves"] * pairs_per_wave
    rolls = pairs * poses.shape[0]
    return {"pairs": pairs, "rollouts": rolls, "seconds": dt,
            "rollouts_per_sec": rolls / dt, "write_s": writer.seconds,
            **stats}


def pipeline_2d(
    objects: Sequence[Tuple[int, np.ndarray]],
    gripper_indices: Sequence[int],
    save_dir: Optional[str] = None,
    grid_size: int = SIM.grid_size,
    num_pos: int = SIM.num_pos,
    calib=None,
    on_records: Optional[Callable[[int, List[Dict]], None]] = None,
    device="cuda",
) -> Dict[str, float]:
    """2D datagen over ``objects`` ((object_idx, contour) items) x
    ``gripper_indices``; the same npz shards as ``datagen.generate_2d``.

    ``on_records(object_idx, records)`` (optional) receives each wave's
    records as they materialize. A drain's record assembly and write
    submits are the ``datagen.records`` span."""
    poses = engine2d.pose_grid(grid_size=grid_size, num_pos=num_pos)
    obj_pos, theta0 = datagen.pose_fields(poses)
    # grippers are object-independent (seed-indexed): sample + ctrlpts once
    grips = [sample_gripper_2d(i) for i in gripper_indices]
    ctrl = [ctrlpts_2d(yl, yr).astype(np.float32) for yl, yr in grips]
    allp = [datagen._curve_points(yl, yr).astype(np.float32)
            for yl, yr in grips]
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
    writer = _Writer()

    def bake(item):
        return datagen.stack_scenes(
            [engine2d.make_scene(yl, yr, item[1]) for yl, yr in grips])

    def launch(scenes):
        return datagen.profile_pairs_2d(scenes, poses, calib=calib,
                                        block=False, device=device)

    def drain(item, res) -> int:
        oi, contour = item
        out = datagen.fetch_pairs_2d(res)
        obj = {"object_vertices": np.asarray(contour, np.float32)}
        records = []
        with TRACER.span("datagen.records"):
            for b, gi in enumerate(gripper_indices):
                rec = datagen.make_record(ctrl[b], allp[b], obj, obj_pos,
                                          theta0, out["delta_theta"][b],
                                          out["delta_pos"][b])
                records.append(rec)
                if save_dir is not None:
                    writer.submit(datagen.shard_path(save_dir, oi, gi), rec)
        if on_records is not None:
            on_records(oi, records)
        return len(records)

    return _run_waves(objects, bake, launch, drain, writer, poses,
                      len(gripper_indices))


def pipeline_3d(
    objects: Sequence[Tuple[int, str, np.ndarray, np.ndarray]],
    gripper_indices: Sequence[int],
    save_dir: Optional[str] = None,
    grid_size: int = SIM.grid_size,
    num_pos: int = SIM.num_pos,
    steps: int = SIM.steps_3d,
    on_records: Optional[Callable[[int, List], None]] = None,
    device="cuda",
) -> Dict[str, float]:
    """3D counterpart of :func:`pipeline_2d` over
    ``(object_idx, name, verts, faces)`` items. Give-up pairs (any tipped
    rollout) yield ``None`` records and no npz, matching
    ``datagen3d.generate_3d`` / the reference's all-or-nothing output
    (``sim/sim_3d.py:159-161``)."""
    poses = engine2d.pose_grid(grid_size=grid_size, num_pos=num_pos)
    obj_pos, theta0 = datagen.pose_fields(poses)
    grips = [sample_gripper_3d(i) for i in gripper_indices]
    ctrl = [ctrlpts_3d(yl, yr).astype(np.float32) for yl, yr in grips]
    allp = [datagen3d.surface_points_3d(yl, yr).astype(np.float32)
            for yl, yr in grips]
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
    writer = _Writer()

    def bake(item):
        return datagen3d.bake_3d(grips, item[2], item[3])

    def launch(stacked):
        return datagen3d.profile_pairs_3d(stacked, poses, steps=steps,
                                          block=False, device=device)

    def drain(item, res) -> int:
        oi, name = item[:2]
        dth, dpos, valid = datagen3d.fetch_pairs_3d(res)
        records = []
        for b, gi in enumerate(gripper_indices):
            if not valid[b].all():
                records.append(None)
                continue
            rec = datagen.make_record(ctrl[b], allp[b], {"object_name": name},
                                      obj_pos, theta0, dth[b], dpos[b])
            records.append(rec)
            if save_dir is not None:
                writer.submit(datagen.shard_path(save_dir, oi, gi), rec)
        if on_records is not None:
            on_records(oi, records)
        return sum(r is not None for r in records)

    return _run_waves(objects, bake, launch, drain, writer, poses,
                      len(gripper_indices))
