"""The port's 2D rollout (kernel K1) vs the JAX package's Pallas kernel run
in interpret mode on the CPU, on 2 pairs x 128 poses.

Schedules: datagen (200 steps) and a shortened eval (400 steps, regrasp and
snapshot at 200); a pose count that is not a multiple of 128 goes through
profile_pairs_2d's padding. Rollouts shorter than ~150 steps compare states
in which the jaws have not reached the object yet, so each comparison first
asserts that the reference moved (max |dtheta| > 1e-2). Bars: >= 99% of
lanes within 1e-3 and corr >= 0.999 for dtheta and dpos; full/cheap step
counters equal per block. The CPU path is the plain PyTorch version; the
CUDA kernel is held to it and to the golden fixture on the card by
tests/test_torch_rollout2d_cuda.py and chip_smoke.py."""

from unittest import mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.sim import datagen as jdatagen
from dgdm_tpu.sim import pallas2d
from dgdm_tpu_torch.sim import datagen as tdatagen
from dgdm_tpu_torch.sim import rollout2d
from dgdm_tpu_torch.sim.rollout2d_ref import profile_batch_ref
from tests.torch_parity import NAMES, assert_k1_parity, golden
from tests.torch_parity_jax import interpret, k1_scenes

SCHEDULES = {"datagen": (200, 0, 0), "eval": (400, 200, 200)}


def _interpret():
    return interpret(pallas2d)


@pytest.fixture(scope="module")
def scenes():
    return k1_scenes()


@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_plain_rollout_matches_pallas(scenes, schedule):
    jst, tst, poses = scenes
    steps, rg, snap = SCHEDULES[schedule]
    with _interpret():
        dth, dpos, fth, fpos, (cf, cc) = pallas2d.profile_batch_pallas(
            *pallas2d.scene_arrays(jst), jnp.asarray(poses), steps=steps,
            regrasp_every=rg, snapshot_step=snap, return_step_mix=True)
    ref = {"dth": dth, "dpx": np.asarray(dpos)[..., 0],
           "dpy": np.asarray(dpos)[..., 1], "cfull": cf, "ccheap": cc}
    out = rollout2d.rollout(*rollout2d.scene_arrays(tst, device="cpu"),
                            torch.from_numpy(poses), steps=steps,
                            regrasp_every=rg, snapshot_step=snap)
    assert_k1_parity({k: v.numpy() for k, v in zip(NAMES, out)}, ref)
    if schedule == "eval":
        # the final pose 200 steps after the regrasp stays close too
        ft = np.asarray(fth)
        assert float(np.mean(np.abs(out[3].numpy() - ft) < 1e-3)) >= 0.98
        assert np.corrcoef(out[3].numpy().ravel(), ft.ravel())[0, 1] > 0.999


def test_profile_pairs_padding_matches_pallas(scenes):
    """100 poses (not a multiple of 128) through profile_pairs_2d: both
    packages pad with the last pose; the padded lanes vote in the gates."""
    jst, tst, poses = scenes
    pp = poses[::-1][:100].copy()
    pp[:, 0] = np.linspace(-0.03, 0.03, 100, dtype=np.float32)
    with _interpret(), mock.patch.object(jdatagen.jax, "default_backend",
                                         lambda: "tpu"):
        ref = jdatagen.profile_pairs_2d(jst, pp)
    res = tdatagen.profile_pairs_2d(tst, pp, block=False, device="cpu")
    assert res["n"] == 100 and res["delta_theta"].shape == (2, 128)
    out = tdatagen.fetch_pairs_2d(res)
    assert out["delta_theta"].shape == (2, 100)
    assert_k1_parity(
        {"dth": out["delta_theta"], "dpx": out["delta_pos"][..., 0],
         "dpy": out["delta_pos"][..., 1]},
        {"dth": ref["delta_theta"], "dpx": ref["delta_pos"][..., 0],
         "dpy": ref["delta_pos"][..., 1]})


@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_plain_rollout_matches_golden(schedule):
    """The committed golden outputs (scripts/export_rollout2d_golden.py)."""
    z, arrs, poses = golden()
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    out = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap)
    assert_k1_parity({k: v.numpy() for k, v in zip(NAMES, out)},
                     {k: z[f"{schedule}_{k}"] for k in NAMES})


def test_rollout_input_checks():
    z, arrs, poses = golden()
    with pytest.raises(ValueError):
        rollout2d.rollout(*arrs, poses[:100])
    with pytest.raises(TypeError):
        rollout2d.rollout(*arrs, poses.double())
    with pytest.raises(ValueError):
        rollout2d.rollout(arrs[0][:1], *arrs[1:], poses)
