"""How far a 1-ulp change of the initial orientation carries in the 3D
squeeze (kernel K2), on the CPU.

Runs the golden-fixture scenes (2 pairs x mug_small x 128 orientations, the
inputs of tests/fixtures/rollout3d_golden.npz) under the datagen (800 steps)
and eval (1,600 steps, regrasp and snapshot at 800) schedules twice: as
given, and with every initial orientation moved up by one float32 ulp
(``np.nextafter``). Prints, for the JAX package's Pallas kernel (interpret
mode) and for the port's plain PyTorch version, the share of lanes whose
snapshot dtheta and dpos stay within 1e-3 of the unperturbed run and the
largest change. That is the floor the port's parity bars have to respect:
rounding differences between two correct implementations move lanes by the
same mechanism. ``--solver jacobi`` runs the kernel's Jacobi branch (and the
Jacobi calibration) in both packages. ``--engine`` probes the pure engines
instead (``engine3d.profile_batch`` of each package, 800 steps) on the
inputs of tests/test_torch_engine3d_rollout.py: grippers 2-3 x mug_small at
64 contact points, 8 orientations with positions jittered by +-2 cm.

``--engine_vs_kernel`` asks a different question of the JAX package alone:
how close its pure engine (``engine3d.profile_batch``) and its Pallas kernel
(interpret mode) come to each other on the inputs of chip_smoke.py phase
11 (d), cut to gripper 0 x mug_small (256 contact points) x the first 128
poses of the datagen grid x 800 steps. It prints the figures that
chip_smoke's ``engine_vs_kernel`` holds the port's engine and K2 to, so
that the bars on the card are set from what the reference itself reaches.

    JAX_PLATFORMS=cpu python scripts/probe_rollout3d_chaos.py \
        [--solver jacobi] [--engine | --engine_vs_kernel]
"""

from __future__ import annotations

import os
import sys

import argparse

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from dgdm_tpu_torch.sim.rollout3d_ref import (  # noqa: E402
    profile_batch_ref,
    readout,
)
from scripts.export_rollout3d_golden import (  # noqa: E402
    SCHEDULES,
    golden_inputs,
    run_pallas_interpret,
)


def profile(raw, poses):
    """(dtheta, dpx, dpy) at the snapshot and the final validity from the
    12 raw outputs."""
    t = [torch.as_tensor(np.array(r)) for r in raw[:9]]
    dth, sdpos, _, valid, _ = readout(*t, torch.as_tensor(poses))
    return (dth.numpy(), sdpos[..., 0].numpy(), sdpos[..., 1].numpy(),
            valid.numpy())


def plain(arrs, poses, steps, rg, snap):
    return profile_batch_ref(*[torch.tensor(a) for a in arrs],
                             torch.tensor(poses), steps=steps,
                             regrasp_every=rg, snapshot_step=snap)


def probe_engines():
    """The 1-ulp probe on the pure engines of both packages."""
    import jax
    import jax.numpy as jnp

    from dgdm_tpu.geom import mesh3d as jmesh
    from dgdm_tpu.geom.fingers import sample_gripper_3d
    from dgdm_tpu.sim import engine3d as jengine3d
    from dgdm_tpu_torch.sim import datagen, engine3d
    from tests.test_torch_engine3d import MUG, N_POSES, NUM_POINTS, poses16

    verts, faces = jmesh.load_obj(MUG)
    grips = [sample_gripper_3d(i) for i in (2, 3)]
    jp = jengine3d.object_properties_3d(verts, faces, num_points=NUM_POINTS)
    tp = engine3d.object_properties_3d(verts, faces, num_points=NUM_POINTS)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jengine3d.make_scene(*g, verts, faces, obj_props=jp) for g in grips])
    tst = datagen.stack_scenes([engine3d.make_scene(*g, verts, faces,
                                                    obj_props=tp)
                                for g in grips])
    poses = poses16(n=N_POSES)
    bumped = poses.copy()
    bumped[:, 2] = np.nextafter(bumped[:, 2], np.float32(10.0))
    runs = (("JAX engine", lambda p: np.asarray(jengine3d.profile_batch(
                 jst, jnp.asarray(p))[0])),
            ("port engine", lambda p: engine3d.profile_batch(
                 tst, torch.tensor(p))[0].numpy()))
    for label, run in runs:
        a, b = run(poses), run(bumped)
        err = np.abs(a - b)
        print(f"{engine3d.SOLVER3} engine (800 steps), {label}: max |dtheta| "
              f"{np.abs(a).max():.4f}; after a 1-ulp orientation change of "
              f"{a.size} lanes: dtheta {np.mean(err < 1e-3):.4f} within "
              f"1e-3, max change {err.max():.3g}", flush=True)


def engine_vs_kernel():
    """JAX's pure engine against its Pallas kernel (interpret mode), the
    figures of chip_smoke.engine_vs_kernel."""
    import jax
    import jax.numpy as jnp

    from dgdm_tpu.geom import mesh3d as jmesh
    from dgdm_tpu.geom.fingers import sample_gripper_3d
    from dgdm_tpu.sim import engine2d as jengine2d
    from dgdm_tpu.sim import engine3d as jengine3d
    from dgdm_tpu.sim import pallas3d
    from scripts.export_rollout3d_golden import MUG

    verts, faces = jmesh.load_obj(MUG)
    props = jengine3d.object_properties_3d(verts, faces)
    scene = jengine3d.make_scene(*sample_gripper_3d(0), verts, faces,
                                 obj_props=props)
    stacked = jax.tree.map(lambda x: x[None], scene)
    poses = jengine2d.pose_grid()[:128].astype(np.float32)
    ed, ep, _, ev = (np.asarray(a) for a in jengine3d.profile_batch(
        stacked, jnp.asarray(poses)))
    raw = run_pallas_interpret(
        [np.asarray(a) for a in pallas3d.scene_arrays_3d(stacked)], poses,
        800, 0, 0)
    t = [torch.as_tensor(np.array(r)) for r in raw[:9]]
    kd, kpos, _, kv, _ = readout(*t, torch.as_tensor(poses))
    kd, kp, kv = (x.numpy() for x in (kd, kpos, kv))
    err, perr = np.abs(ed - kd), np.abs(ep - kp)
    st = {"frac_dth_2e-2": float(np.mean(err < 2e-2)),
          "max_dth_err": float(err.max()),
          "median_dth_err": float(np.median(err)),
          "median_dpos_err": float(np.median(perr)),
          "max_dpos_err": float(perr.max()),
          "corr": float(np.corrcoef(ed.ravel(), kd.ravel())[0, 1]),
          "valid_equal": float(np.mean(ev == kv))}
    print(f"{jengine3d.SOLVER3}: JAX engine vs Pallas interpret, gripper 0 "
          f"x mug_small x 128 grid poses x 800 steps (max |dtheta| "
          f"{np.abs(kd).max():.4f}): {st}", flush=True)


def main(argv=None):
    from dgdm_tpu.sim import engine3d as jengine3d
    from dgdm_tpu_torch.sim import engine3d

    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="newton", choices=["newton", "jacobi"])
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--engine_vs_kernel", action="store_true")
    args = ap.parse_args(argv)
    jengine3d.SOLVER3 = engine3d.SOLVER3 = args.solver
    if args.engine:
        return probe_engines()
    if args.engine_vs_kernel:
        return engine_vs_kernel()
    arrs, poses = golden_inputs()
    bumped = poses.copy()
    bumped[:, 2] = np.nextafter(bumped[:, 2], np.float32(10.0))
    for name, steps, rg, snap in SCHEDULES:
        for label, run in (("pallas interpret", run_pallas_interpret),
                           ("port plain", plain)):
            a = profile(run(arrs, poses, steps, rg, snap), poses)
            b = profile(run(arrs, bumped, steps, rg, snap), bumped)
            parts = []
            for k, x, y in zip(("dtheta", "dpx", "dpy"), a, b):
                err = np.abs(x - y)
                parts.append(f"{k} {np.mean(err < 1e-3):.4f} within 1e-3, "
                             f"max change {err.max():.3g}")
            parts.append(f"final validity equal {np.mean(a[3] == b[3]):.4f}")
            print(f"{name} ({steps} steps), {label}: max |dtheta| "
                  f"{np.abs(a[0]).max():.4f}; after a 1-ulp orientation "
                  f"change of {a[0].size} lanes: " + "; ".join(parts),
                  flush=True)


if __name__ == "__main__":
    main()
