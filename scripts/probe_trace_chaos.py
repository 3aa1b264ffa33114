"""How far the pure engines' traces (``engine2d.rollout_trace``,
``engine3d.rollout_trace3d``) move under rounding, on the CPU: the bars of
the render path's trace comparisons come from here.

For each case the JAX package's trace and the port's run twice, as given
and with every initial orientation moved up by one float32 ulp
(``np.nextafter``), and the port's runs beside JAX's. Batched traces of
several pairs run beside the same pairs traced one at a time. Prints, per
case and per trace column (x, y, theta, ql, qr in 2D; pos, quat, q in 3D),
the largest change over every row and lane, and the share of lanes whose
theta stays within 1e-3 rad at the last row.

Cases:

- ``2d_poses``: gripper 0 x icon 3 (tests/util_icons.py), 16 jittered
  orientations, 400 steps, every 10, regrasp at 200 (the JAX-parity case of
  tests/test_torch_engine2d_trace.py);
- ``2d_render``: grippers 0-5 x synthetic icons 0 and 1 alternately, one
  pose (0, 0, pi) a pair, 400 steps, every 20, regrasp every 200 (the
  render path's 2D schedule cut to 400 steps, as chip_smoke phase 13 holds
  it);
- ``3d_render``: grippers 0-2 x mug_small, one pose (0, 0, 0.7) a pair, 800
  steps, every 20 (the render path's 3D schedule).

    JAX_PLATFORMS=cpu python scripts/probe_trace_chaos.py [--cases ...]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgdm_tpu.geom import mesh3d as jmesh  # noqa: E402
from dgdm_tpu.cli.datagen import synthetic_icon  # noqa: E402
from dgdm_tpu.geom.contour import extract_contours  # noqa: E402
from dgdm_tpu.geom.fingers import (  # noqa: E402
    sample_gripper_2d,
    sample_gripper_3d,
)
from dgdm_tpu.sim import engine2d as J2  # noqa: E402
from dgdm_tpu.sim import engine3d as J3  # noqa: E402
from dgdm_tpu_torch.sim import datagen, engine2d, engine3d  # noqa: E402
from tests.util_icons import make_icon  # noqa: E402

MUG = os.path.join(ROOT, "tests", "fixtures", "scanned_objects", "mug_small",
                   "model.obj")


def bump(poses: np.ndarray) -> np.ndarray:
    out = poses.copy()
    out[..., 2] = np.nextafter(out[..., 2], np.float32(10.0))
    return out


def report(name: str, a: np.ndarray, b: np.ndarray, th_col: int, cols):
    """a, b: (lanes, rows, cols) traces."""
    err = np.abs(a.astype(np.float64) - b)
    per_col = err.reshape(-1, err.shape[-1]).max(0)
    frac = float(np.mean(err[:, -1, th_col] < 1e-3))
    print(f"  {name}: max |change| " + ", ".join(
        f"{c} {v:.3g}" for c, v in zip(cols, per_col))
        + f"; theta within 1e-3 at the last row on {frac:.4f} of "
        f"{err.shape[0]} lanes", flush=True)
    return per_col


def jax_traces_2d(scenes, poses, steps, every, regrasp):
    fn = jax.jit(jax.vmap(lambda sc, p: J2.rollout_trace(
        sc, p, steps=steps, every=every, regrasp_every=regrasp)))
    return np.asarray(fn(scenes, jnp.asarray(poses)))


def case_2d_poses():
    contour = extract_contours(make_icon(3))
    yl, yr = sample_gripper_2d(0)
    rng = np.random.RandomState(0)
    n = 16
    poses = np.stack([rng.uniform(-0.01, 0.01, n), rng.uniform(-0.01, 0.01, n),
                      np.linspace(0, 2 * np.pi, n, endpoint=False)],
                     -1).astype(np.float32)
    kw = dict(steps=400, every=10, regrasp_every=200)
    jsc = J2.make_scene(yl, yr, contour)
    tsc = engine2d.make_scene(yl, yr, contour)
    fn = jax.jit(jax.vmap(lambda p: J2.rollout_trace(jsc, p, **kw)))
    j0, j1 = (np.asarray(fn(jnp.asarray(p))) for p in (poses, bump(poses)))
    t0 = engine2d.rollout_trace(tsc, torch.from_numpy(poses), **kw).numpy()
    t1 = engine2d.rollout_trace(tsc, torch.from_numpy(bump(poses)),
                                **kw).numpy()
    print(f"2d_poses: gripper 0 x icon 3 x {n} poses x 400 steps, every 10, "
          f"regrasp 200; max |theta - theta0| "
          f"{np.abs(j0[..., 2] - poses[:, None, 2]).max():.4f}", flush=True)
    cols = ("x", "y", "theta", "ql", "qr")
    report("JAX, 1 ulp", j0, j1, 2, cols)
    report("port, 1 ulp", t0, t1, 2, cols)
    report("port vs JAX", t0, j0, 2, cols)


def case_2d_render():
    contours = [extract_contours(synthetic_icon(i)) for i in (0, 1)]
    pairs = [(*sample_gripper_2d(i), contours[i % 2]) for i in range(6)]
    kw = dict(steps=400, every=20, regrasp_every=200)
    pose = np.array([[0.0, 0.0, math.pi]], np.float32)
    stacked = engine2d.expand_scene(datagen.stack_scenes(
        [engine2d.make_scene(*p) for p in pairs]), 1)
    b0 = engine2d.rollout_trace(stacked, torch.from_numpy(pose),
                                **kw)[:, 0].numpy()
    b1 = engine2d.rollout_trace(stacked, torch.from_numpy(bump(pose)),
                                **kw)[:, 0].numpy()
    alone = np.stack([engine2d.rollout_trace(
        engine2d.make_scene(*p), torch.from_numpy(pose[0]), **kw).numpy()
        for p in pairs])
    jst = jax.tree.map(lambda *xs: jnp.stack(xs),
                       *[J2.make_scene(*p) for p in pairs])
    jp = np.repeat(pose, len(pairs), 0)
    j0 = jax_traces_2d(jst, jp, kw["steps"], kw["every"], kw["regrasp_every"])
    j1 = jax_traces_2d(jst, bump(jp), kw["steps"], kw["every"],
                       kw["regrasp_every"])
    print(f"2d_render: grippers 0-5 x icons 0/1, pose (0, 0, pi), 400 steps, "
          f"every 20, regrasp 200; max |theta - pi| "
          f"{np.abs(b0[..., 2] - math.pi).max():.4f}; batched == alone "
          f"bitwise: {np.array_equal(b0, alone)}", flush=True)
    cols = ("x", "y", "theta", "ql", "qr")
    report("JAX, 1 ulp", j0, j1, 2, cols)
    report("port, 1 ulp", b0, b1, 2, cols)
    report("port batched vs alone", b0, alone, 2, cols)
    report("port vs JAX", b0, j0, 2, cols)


def case_3d_render():
    verts, faces = jmesh.load_obj(MUG)
    grips = [sample_gripper_3d(i) for i in range(3)]
    kw = dict(steps=800, every=20)
    pose = np.array([[0.0, 0.0, 0.7]], np.float32)
    scenes = [engine3d.with_hgrid(engine3d.make_scene(yl, yr, verts, faces))
              for yl, yr in grips]
    stacked = engine3d.expand_scene3(datagen.stack_scenes(scenes), 1)
    b0 = engine3d.rollout_trace3d(stacked, torch.from_numpy(pose),
                                  **kw)[:, 0].numpy()
    b1 = engine3d.rollout_trace3d(stacked, torch.from_numpy(bump(pose)),
                                  **kw)[:, 0].numpy()
    alone = np.stack([engine3d.rollout_trace3d(
        s, torch.from_numpy(pose[0]), **kw).numpy() for s in scenes])
    fn = jax.jit(lambda sc, p: J3.rollout_trace3d(sc, p, **kw))
    j0, j1 = (np.stack([np.asarray(fn(J3.make_scene(yl, yr, verts, faces),
                                      jnp.asarray(p[0])))
                        for yl, yr in grips]) for p in (pose, bump(pose)))
    qn = np.abs(np.linalg.norm(b0[..., 3:7], axis=-1) - 1).max()
    print(f"3d_render: grippers 0-2 x mug_small, pose (0, 0, 0.7), 800 "
          f"steps, every 20; max |q| {np.abs(b0[..., 7:]).max():.4f}, max "
          f"| |quat| - 1 | {qn:.3g}; batched == alone bitwise: "
          f"{np.array_equal(b0, alone)}", flush=True)
    cols = ("px", "py", "pz", "qw", "qx", "qy", "qz", "ql", "qr")
    report("JAX, 1 ulp", j0, j1, 3, cols)
    report("port, 1 ulp", b0, b1, 3, cols)
    report("port batched vs alone", b0, alone, 3, cols)
    report("port vs JAX", b0, j0, 3, cols)


CASES = {"2d_poses": case_2d_poses, "2d_render": case_2d_render,
         "3d_render": case_3d_render}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    for c in args.cases.split(","):
        CASES[c]()


if __name__ == "__main__":
    main()
