"""The plain 3D rollout (kernel K2's plain version) with its point sums
added in the order of the CUDA kernel (``sum_group`` = 32 threads a rollout;
dgdm_tpu_torch/sim/point_sum.py), at the schedules of
tests/test_torch_rollout3d.py (datagen: 800 steps; eval: 1,600 steps,
regrasp and snapshot at 800): against the committed golden outputs of the
TPU kernel (scripts/export_rollout3d_golden.py: grippers 0-1 x mug_small x
128 poses, 256 contact points) and against the JAX package's Pallas kernel
in interpret mode on the CPU (grippers 2-3, the scenes built on each side by
its own package).

Bars, the same as in tests/test_torch_rollout3d.py: the reference moved;
>= 99% of lanes within 1e-3 and corr >= 0.999 for the snapshot dtheta and
dpos, and in fact 100% within 1e-3 as today; tip-over validity equal;
full/cheap/iteration counters equal per 128-lane block; against Pallas at
the eval schedule the final pose, 800 steps after the regrasp, >= 98% within
1e-3. Against the plain version's default order (``torch.sum`` in float64)
the kernel's order must agree to the last bit on the golden inputs (float32
terms summed in float64 are all but exact), which is what let the kernel
change its thread layout without moving a lane."""

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.sim import rollout3d
from dgdm_tpu_torch.sim.rollout3d_ref import profile_batch_ref, readout
from tests.torch_parity import (
    NAMES3,
    assert_k2_parity,
    assert_k2_profiles,
    golden3d,
)
from tests.torch_parity_jax import k2_pallas_case, k2_profiles

GROUP = rollout3d.THREADS_PER_ROLLOUT
SCHEDULES = {"datagen": (800, 0, 0), "eval": (1600, 800, 800)}


@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_grouped_order_matches_golden(schedule):
    z, arrs, poses = golden3d()
    assert GROUP == 32 and arrs[1].shape == (2, 256, 4)
    steps, rg, snap = SCHEDULES[schedule]
    assert tuple(int(v) for v in z[f"{schedule}_schedule"]) == (steps, rg,
                                                               snap)
    out = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, sum_group=GROUP)
    stats = assert_k2_parity({k: v.numpy() for k, v in zip(NAMES3, out)},
                             {k: z[f"{schedule}_{k}"] for k in NAMES3},
                             z["poses"])
    assert all(v["frac_1e-3"] == 1.0 for v in stats.values()), stats
    base = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                             snapshot_step=snap)
    for k, a, b in zip(NAMES3, out, base):
        assert torch.equal(a, b), f"{k} differs from the default order"


@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_grouped_order_matches_pallas(schedule):
    steps, rg, snap = SCHEDULES[schedule]
    arrs, poses, ref = k2_pallas_case((steps, rg, snap))
    assert arrs[1].shape == (2, 256, 4)
    raw = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, sum_group=GROUP)
    out = k2_profiles(readout(*raw[:9], poses), raw[9:])
    stats = assert_k2_profiles(out, ref)
    assert all(v["frac_1e-3"] == 1.0 for v in stats.values()), stats
    if schedule == "eval":
        assert float(np.mean(np.abs(out["fth"] - ref["fth"]) < 1e-3)) >= 0.98
