"""How far a 1-ulp change of the initial orientation carries in the 2D
squeeze (kernel K1), on the CPU.

Runs the golden-fixture scenes (2 pairs x 128 orientations, the inputs of
tests/fixtures/rollout2d_golden.npz) under the datagen (200 steps) and eval
(400 steps, regrasp and snapshot at 200) schedules twice: as given, and with
every initial orientation moved up by one float32 ulp (``np.nextafter``).
Prints, for the JAX package's Pallas kernel (interpret mode) and for the
port's plain PyTorch version, the share of lanes whose dtheta stays within
1e-3 rad of the unperturbed run. Rounding differences between two correct
implementations move lanes by the same mechanism, which is why the port's
parity bars are a share of lanes and a correlation, not a maximum.

    JAX_PLATFORMS=cpu python scripts/probe_rollout2d_chaos.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from dgdm_tpu_torch.sim.rollout2d_ref import profile_batch_ref  # noqa: E402
from scripts.export_rollout2d_golden import (  # noqa: E402
    SCHEDULES,
    golden_inputs,
    run_pallas_interpret,
)


def plain(arrs, poses, steps, rg, snap):
    out = profile_batch_ref(*[torch.tensor(a) for a in arrs],
                            torch.tensor(poses), steps=steps,
                            regrasp_every=rg, snapshot_step=snap)
    return [o.numpy() for o in out]


def main():
    arrs, poses = golden_inputs()
    bumped = poses.copy()
    bumped[:, 2] = np.nextafter(bumped[:, 2], np.float32(10.0))
    for name, steps, rg, snap in SCHEDULES:
        for label, run in (("pallas interpret", run_pallas_interpret),
                           ("port plain", plain)):
            a = run(arrs, poses, steps, rg, snap)[0]
            b = run(arrs, bumped, steps, rg, snap)[0]
            err = np.abs(a - b)
            print(f"{name} ({steps} steps), {label}: max |dtheta| "
                  f"{np.abs(a).max():.4f}; after a 1-ulp orientation change "
                  f"{np.mean(err < 1e-3):.4f} of {err.size} lanes within "
                  f"1e-3, max change {err.max():.3g}", flush=True)


if __name__ == "__main__":
    main()
