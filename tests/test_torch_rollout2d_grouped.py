"""The plain 2D rollout (kernel K1's plain version) with its point sums
added in the CUDA kernel's order (``sum_group`` = 16 threads a rollout;
dgdm_tpu_torch/sim/point_sum.py), against the committed golden outputs of
the TPU kernel and against the JAX package's Pallas kernel in interpret mode
on the CPU, at the schedules of tests/test_torch_rollout2d.py (datagen: 200
steps; eval: 400 steps, regrasp and snapshot at 200).

Bars, the same as there: the reference moved (max |dtheta| > 1e-2); >= 99%
of lanes within 1e-3 and corr >= 0.999 for dtheta and dpos; full/cheap step
counters equal per 128-pose block. The contour of both inputs has 100
points, which 16 does not divide: the upper lanes of a rollout then hold one
point fewer. Against the plain version's default order (``torch.sum`` in
float64) the kernel's order must agree to the last bit on these inputs
(float32 terms summed in float64 are all but exact), which is what let the
kernel change its thread layout without moving a lane."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.sim import pallas2d
from dgdm_tpu_torch.sim import rollout2d
from dgdm_tpu_torch.sim.rollout2d_ref import profile_batch_ref
from tests.torch_parity import NAMES, assert_k1_parity, golden
from tests.torch_parity_jax import interpret, k1_scenes

SCHEDULES = {"datagen": (200, 0, 0), "eval": (400, 200, 200)}
GROUPS = [rollout2d.THREADS_PER_ROLLOUT]


@pytest.fixture(scope="module")
def pallas_case():
    """Scene arrays of 2 pairs x 128 poses for the port, and the Pallas
    kernel's outputs per schedule."""
    jst, tst, poses = k1_scenes()
    arrs = rollout2d.scene_arrays(tst, device="cpu")
    assert arrs[1].shape[1] % GROUPS[0] != 0
    refs = {}
    with interpret(pallas2d):
        for name, (steps, rg, snap) in SCHEDULES.items():
            dth, dpos, _, _, (cf, cc) = pallas2d.profile_batch_pallas(
                *pallas2d.scene_arrays(jst), jnp.asarray(poses), steps=steps,
                regrasp_every=rg, snapshot_step=snap, return_step_mix=True)
            refs[name] = {"dth": np.asarray(dth),
                          "dpx": np.asarray(dpos)[..., 0],
                          "dpy": np.asarray(dpos)[..., 1],
                          "cfull": np.asarray(cf), "ccheap": np.asarray(cc)}
    return arrs, torch.from_numpy(poses), refs


@pytest.mark.parametrize("schedule", ["datagen", "eval"])
@pytest.mark.parametrize("group", GROUPS)
def test_grouped_order_matches_golden(group, schedule):
    z, arrs, poses = golden()
    assert arrs[1].shape[1] == 100 and 100 % group != 0
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    out = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, sum_group=group)
    assert_k1_parity({k: v.numpy() for k, v in zip(NAMES, out)},
                     {k: z[f"{schedule}_{k}"] for k in NAMES})
    base = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                             snapshot_step=snap)
    for k, a, b in zip(NAMES, out, base):
        assert torch.equal(a, b), f"{k} differs from the default order"


@pytest.mark.parametrize("schedule", ["datagen", "eval"])
@pytest.mark.parametrize("group", GROUPS)
def test_grouped_order_matches_pallas(group, schedule, pallas_case):
    arrs, poses, refs = pallas_case
    steps, rg, snap = SCHEDULES[schedule]
    out = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, sum_group=group)
    assert_k1_parity({k: v.numpy() for k, v in zip(NAMES, out)},
                     refs[schedule])
    base = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                             snapshot_step=snap)
    for k, a, b in zip(NAMES, out, base):
        assert torch.equal(a, b), f"{k} differs from the default order"
