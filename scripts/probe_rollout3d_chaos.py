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
same mechanism.

    JAX_PLATFORMS=cpu python scripts/probe_rollout3d_chaos.py
"""

from __future__ import annotations

import os
import sys

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
    """(dtheta, dpx, dpy) at the snapshot from the 12 raw outputs."""
    t = [torch.as_tensor(np.array(r)) for r in raw[:9]]
    dth, sdpos = readout(*t, torch.as_tensor(poses))[:2]
    return dth.numpy(), sdpos[..., 0].numpy(), sdpos[..., 1].numpy()


def plain(arrs, poses, steps, rg, snap):
    return profile_batch_ref(*[torch.tensor(a) for a in arrs],
                             torch.tensor(poses), steps=steps,
                             regrasp_every=rg, snapshot_step=snap)


def main():
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
            print(f"{name} ({steps} steps), {label}: max |dtheta| "
                  f"{np.abs(a[0]).max():.4f}; after a 1-ulp orientation "
                  f"change of {a[0].size} lanes: " + "; ".join(parts),
                  flush=True)


if __name__ == "__main__":
    main()
