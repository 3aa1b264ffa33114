"""Write the golden outputs of the 3D rollout kernel (K2) for the port.

Runs the JAX package's Pallas kernel ``dgdm_tpu.sim.pallas3d`` in interpret
mode on the CPU (as tests/test_pallas3d.py does) for 2 pairs
(``sample_gripper_3d(0..1)``) x the fixture object ``mug_small`` x 128
orientations at the origin, under the two schedules the port must reproduce:

- ``datagen``: 800 steps, snapshot at the end;
- ``eval``: 1,600 steps, regrasp every 800, snapshot at 800 (the first part
  of the 32,000-step verification schedule).

The scenes are built the way ``dgdm_tpu/eval/simeval3d.py`` builds them:
one ``object_properties_3d(verts, faces)`` per object, at its default of 256
contact points. Writes ``tests/fixtures/rollout3d_golden.npz``: the scene
arrays, the poses and all 12 kernel outputs of each schedule. The port's
tests hold the plain PyTorch version to it on the CPU, and ``chip_smoke.py``
holds the CUDA kernel to it on the card, which needs no JAX.

``--solver jacobi`` runs the kernel's Jacobi branch with
``engine3d.SOLVER3 = "jacobi"`` (so the scene arrays carry the Jacobi
calibration) into ``rollout3d_jacobi_golden.npz``; ``--newton_tol`` > 0
(with ``--newton_iters``) its adaptive Newton loop into
``rollout3d_newton_tol_golden.npz``. Each file records its solver and
Newton settings.

    JAX_PLATFORMS=cpu python scripts/export_rollout3d_golden.py \
        [--solver jacobi | --newton_iters 6 --newton_tol 1e-4]
"""

from __future__ import annotations

import argparse
import os
import sys
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.experimental.pallas as pl  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dgdm_tpu.geom import mesh3d  # noqa: E402
from dgdm_tpu.geom.fingers import sample_gripper_3d  # noqa: E402
from dgdm_tpu.sim import engine3d, pallas3d  # noqa: E402

# (name, steps, regrasp_every, snapshot_step)
SCHEDULES = (("datagen", 800, 0, 0), ("eval", 1600, 800, 800))
OUT_NAMES = ("qw", "qz", "dpx", "dpy", "valid", "sqw", "sqz", "sdx", "sdy",
             "cfull", "ccheap", "citer")
MUG = os.path.join(ROOT, "tests", "fixtures", "scanned_objects", "mug_small",
                   "model.obj")


def golden_inputs(grippers=(0, 1), n: int = 128):
    """Scene arrays (numpy) and (n, 3) poses: orientations over [0, 2pi) at
    the origin."""
    verts, faces = mesh3d.load_obj(MUG)
    props = engine3d.object_properties_3d(verts, faces)
    scenes = [engine3d.make_scene(*sample_gripper_3d(i), verts, faces,
                                  obj_props=props) for i in grippers]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *scenes)
    arrs = [np.asarray(a) for a in pallas3d.scene_arrays_3d(stacked)]
    ths = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    poses = np.stack([np.zeros(n), np.zeros(n), ths], -1).astype(np.float32)
    return arrs, poses


def run_pallas_interpret(arrs, poses, steps, regrasp_every, snapshot_step,
                         newton_iters=pallas3d.NEWTON_KERNEL_ITERS3,
                         newton_tol=0.0):
    """All 12 raw kernel outputs, (B, N) each, from the interpreted TPU
    kernel (the solver of engine3d.SOLVER3, as profile_batch_pallas3d
    resolves it)."""
    orig = pl.pallas_call
    raw = {}

    def interp(*args, **kw):
        kw["interpret"] = True
        call = orig(*args, **kw)

        def run(*a):
            raw["outs"] = call(*a)
            return raw["outs"]
        return run

    def traced(*a):
        # the wrapper's own body, traced once more so that the kernel's raw
        # outputs (before its readout) can be returned
        pallas3d._profile_batch_pallas3d.__wrapped__(
            *a, steps=steps, regrasp_every=regrasp_every,
            snapshot_step=snapshot_step, solver=engine3d.SOLVER3,
            newton_iters=newton_iters, newton_tol=newton_tol)
        return raw["outs"]

    with mock.patch.object(pallas3d.pl, "pallas_call", interp):
        outs = jax.jit(traced)(*[jnp.asarray(a) for a in arrs],
                               jnp.asarray(poses))
    return [np.asarray(o)[:, 0, :] for o in outs]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="newton", choices=["newton", "jacobi"])
    ap.add_argument("--newton_iters", type=int,
                    default=pallas3d.NEWTON_KERNEL_ITERS3)
    ap.add_argument("--newton_tol", type=float, default=0.0)
    ap.add_argument("--out", default=None, help="default: tests/fixtures/"
                    "rollout3d_golden.npz, rollout3d_jacobi_golden.npz with "
                    "--solver jacobi, rollout3d_newton_tol_golden.npz with "
                    "--newton_tol > 0")
    args = ap.parse_args(argv)
    if args.out is None:
        name = ("rollout3d_jacobi_golden.npz" if args.solver == "jacobi"
                else "rollout3d_newton_tol_golden.npz" if args.newton_tol > 0
                else "rollout3d_golden.npz")
        args.out = os.path.join(ROOT, "tests", "fixtures", name)
    engine3d.SOLVER3 = args.solver
    arrs, poses = golden_inputs()
    data = dict(zip(("coefs", "points", "scalars"), arrs))
    data["poses"] = poses
    for name, steps, rg, snap in SCHEDULES:
        data[f"{name}_schedule"] = np.asarray([steps, rg, snap], np.int64)
        outs = run_pallas_interpret(arrs, poses, steps, rg, snap,
                                    args.newton_iters, args.newton_tol)
        for k, v in zip(OUT_NAMES, outs):
            data[f"{name}_{k}"] = v.astype(np.float32)
        print(f"{name}: full/cheap steps per block {outs[9][:, 0]} / "
              f"{outs[10][:, 0]}, iterations per block {outs[11][:, 0]}, "
              f"valid {outs[4].mean():.3f}", flush=True)
    if args.solver != "newton" or args.newton_tol > 0:
        data["solver"] = np.asarray(args.solver)
        data["newton_iters"] = np.asarray(args.newton_iters, np.int64)
        data["newton_tol"] = np.asarray(args.newton_tol, np.float64)
    np.savez_compressed(args.out, **data)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
