"""The port's 3D rollout (kernel K2) vs the JAX package's Pallas kernel run
in interpret mode on the CPU, on 2 pairs x the fixture object mug_small x
128 poses, the scenes built on each side by its own package (one
object_properties_3d per object, 256 contact points, as the verification
and datagen callers build them).

Schedules: datagen (800 steps) and a shortened eval (1,600 steps, regrasp
and snapshot at 800); a pose count that is not a multiple of 128 goes
through the padding with the last pose; the committed golden outputs of the
TPU kernel (scripts/export_rollout3d_golden.py) at both schedules. Each
comparison first asserts that the reference moved (max |dtheta| > 1e-2).
Bars: >= 99% of lanes within 1e-3 and corr >= 0.999 for the snapshot dtheta
and dpos; tip-over validity equal; full/cheap/iteration counters equal per
128-lane block. The CPU path is the plain PyTorch version; the CUDA kernel
is held to it and to the golden fixture on the card by
tests/test_torch_rollout3d_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.sim import datagen as tdatagen
from dgdm_tpu_torch.sim import rollout3d
from dgdm_tpu_torch.sim.rollout3d_ref import profile_batch_ref
from tests.torch_parity import (
    NAMES3,
    assert_k2_parity,
    assert_k2_profiles,
    golden3d,
)
from tests.torch_parity_jax import k2_pallas as _pallas
from tests.torch_parity_jax import k2_profiles as _profiles
from tests.torch_parity_jax import k2_scene_arrays

SCHEDULES = {"datagen": (800, 0, 0), "eval": (1600, 800, 800)}


def _port(tarrs, poses, steps, rg, snap):
    *res, mix = rollout3d.profile_batch(
        *tarrs, torch.from_numpy(poses), steps=steps, regrasp_every=rg,
        snapshot_step=snap, return_step_mix=True)
    return _profiles(res, mix)


@pytest.fixture(scope="module")
def scenes():
    return k2_scene_arrays()


@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_plain_rollout_matches_pallas(scenes, schedule):
    jarrs, tarrs, poses = scenes
    steps, rg, snap = SCHEDULES[schedule]
    ref = _pallas(jarrs, poses, steps, rg, snap)
    out = _port(tarrs, poses, steps, rg, snap)
    assert_k2_profiles(out, ref)
    if schedule == "eval":
        # the final pose 800 steps after the regrasp stays close too
        a, b = out["fth"], ref["fth"]
        assert float(np.mean(np.abs(a - b) < 1e-3)) >= 0.98
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999


def test_pose_padding_matches_pallas(scenes):
    """100 poses (not a multiple of 128), padded with the last pose as the
    JAX callers pad them; the padded lanes vote in the last block's gates."""
    jarrs, tarrs, poses = scenes
    pp = poses[::-1][:100].copy()
    pp[:, 0] = np.linspace(-0.02, 0.02, 100, dtype=np.float32)
    padded = tdatagen.pad_poses(pp, rollout3d.LANE)
    assert padded.shape == (128, 3)
    ref = _pallas(jarrs, padded, 800, 0, 0)
    out = _port(tarrs, padded, 800, 0, 0)
    assert out["dth"].shape == (2, 128) and out["valid"].dtype == bool
    # counters per block, then the 100 real lanes
    assert_k2_profiles(out, ref)
    assert_k2_profiles({k: v[:, :100] for k, v in out.items()},
                       {k: v[:, :100] for k, v in ref.items()}, lane=100)


@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_plain_rollout_matches_golden(schedule):
    """The committed golden outputs (scripts/export_rollout3d_golden.py)."""
    z, arrs, poses = golden3d()
    assert arrs[1].shape == (2, 256, 4)
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    out = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap)
    assert_k2_parity({k: v.numpy() for k, v in zip(NAMES3, out)},
                     {k: z[f"{schedule}_{k}"] for k in NAMES3},
                     z["poses"])


def test_rollout_input_checks():
    z, arrs, poses = golden3d()
    with pytest.raises(ValueError):
        rollout3d.rollout(*arrs, poses[:100])
    with pytest.raises(TypeError):
        rollout3d.rollout(*arrs, poses.double())
    with pytest.raises(ValueError):
        rollout3d.rollout(arrs[0][:1], *arrs[1:], poses)
    with pytest.raises(ValueError):
        rollout3d.rollout(arrs[0], arrs[1][..., :3], arrs[2], poses)
    with pytest.raises(ValueError):
        rollout3d.rollout(arrs[0], arrs[1], arrs[2][..., :16], poses)
