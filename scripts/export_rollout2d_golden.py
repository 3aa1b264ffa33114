"""Write the golden outputs of the 2D rollout kernel (K1) for the port.

Runs the JAX package's Pallas kernel ``dgdm_tpu.sim.pallas2d`` in interpret
mode on the CPU (as tests/test_pallas2d.py does) for 2 pairs x 128 poses
under the two schedules the port must reproduce:

- ``datagen``: 200 steps, snapshot at the end;
- ``eval``: 400 steps, regrasp every 200, snapshot at 200 (the first part of
  the 8,000-step verification schedule).

and writes ``tests/fixtures/rollout2d_golden.npz``: the scene arrays, the
poses and all 8 kernel outputs of each schedule. The port's tests hold the
plain PyTorch version to it on the CPU, and ``chip_smoke.py`` holds the CUDA
kernel to it on the card, which needs no JAX. ``--solver jacobi`` runs the
kernel's Jacobi branch instead, with ``engine2d.SOLVER`` set to it so that
the scene arrays carry its calibration (``FITTED_2D``), and writes
``tests/fixtures/rollout2d_jacobi_golden.npz``.

    JAX_PLATFORMS=cpu python scripts/export_rollout2d_golden.py [--solver jacobi]
"""

from __future__ import annotations

import argparse
import os
import sys
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.experimental.pallas as pl  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dgdm_tpu.geom.contour import extract_contours  # noqa: E402
from dgdm_tpu.geom.fingers import sample_gripper_2d  # noqa: E402
from dgdm_tpu.sim import engine2d, pallas2d  # noqa: E402

# (name, steps, regrasp_every, snapshot_step)
SCHEDULES = (("datagen", 200, 0, 0), ("eval", 400, 200, 200))
OUT_NAMES = ("dth", "dpx", "dpy", "fth", "fpx", "fpy", "cfull", "ccheap")


def golden_inputs(icon_seed: int = 3, grippers=(0, 1), n: int = 128):
    """Scene arrays (numpy) and (n, 3) poses: orientations over [0, 2pi) at
    the origin, like tests/test_pallas2d.py."""
    from tests.util_icons import make_icon

    contour = extract_contours(make_icon(icon_seed))
    scenes = [engine2d.make_scene(*sample_gripper_2d(i), contour)
              for i in grippers]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *scenes)
    arrs = [np.asarray(a) for a in pallas2d.scene_arrays(stacked)]
    ths = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    poses = np.stack([np.zeros(n), np.zeros(n), ths], -1).astype(np.float32)
    return arrs, poses


def run_pallas_interpret(arrs, poses, steps, regrasp_every, snapshot_step,
                         solver="newton"):
    """All 8 kernel outputs, (B, N) each, from the interpreted TPU kernel."""
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    with mock.patch.object(pallas2d.pl, "pallas_call", interp):
        dth, dpos, fth, fpos, (cf, cc) = pallas2d.profile_batch_pallas(
            *[jnp.asarray(a) for a in arrs], jnp.asarray(poses), steps=steps,
            regrasp_every=regrasp_every, snapshot_step=snapshot_step,
            return_step_mix=True, solver=solver)
    dpos, fpos = np.asarray(dpos), np.asarray(fpos)
    return [np.asarray(dth), dpos[..., 0], dpos[..., 1], np.asarray(fth),
            fpos[..., 0], fpos[..., 1], np.asarray(cf), np.asarray(cc)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="newton", choices=["newton", "jacobi"])
    ap.add_argument("--out", default=None, help="default: tests/fixtures/"
                    "rollout2d_golden.npz, rollout2d_jacobi_golden.npz with "
                    "--solver jacobi")
    args = ap.parse_args(argv)
    if args.out is None:
        name = ("rollout2d_golden.npz" if args.solver == "newton"
                else "rollout2d_jacobi_golden.npz")
        args.out = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tests", "fixtures", name)
    engine2d.SOLVER = args.solver
    arrs, poses = golden_inputs()
    data = dict(zip(("coefs", "contour", "support", "scalars"), arrs))
    data["poses"] = poses
    for name, steps, rg, snap in SCHEDULES:
        data[f"{name}_schedule"] = np.asarray([steps, rg, snap], np.int64)
        outs = run_pallas_interpret(arrs, poses, steps, rg, snap, args.solver)
        for k, v in zip(OUT_NAMES, outs):
            data[f"{name}_{k}"] = v.astype(np.float32)
        print(f"{name}: max|dth| {np.abs(outs[0]).max():.4f}, full/cheap "
              f"steps per block {outs[6][:, 0]} / {outs[7][:, 0]}")
    data["solver"] = np.asarray(args.solver)
    np.savez_compressed(args.out, **data)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
