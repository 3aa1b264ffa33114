"""The Jacobi branch of the port's 2D rollout (kernel K1's plain version,
``solver="jacobi"``) vs the JAX package's Pallas kernel run in interpret
mode on the CPU (``pallas2d.py:221-334``), on 2 pairs x 128 poses, with
``engine2d.SOLVER`` set to "jacobi" in both packages so that the scene
arrays carry the Jacobi calibration (``FITTED_2D``) and the solver is
resolved from it at call time.

Schedules and bars as tests/test_torch_rollout2d.py: datagen (200 steps)
and eval (400 steps, regrasp and snapshot at 200); the reference moved (max
|dtheta| > 1e-2); >= 99% of lanes within 1e-3 and corr >= 0.999 for dtheta
and dpos; full/cheap step counters equal per 128-pose block (every normal
Jacobi step is a full solve). The plain version is also held to the golden
fixture (scripts/export_rollout2d_golden.py --solver jacobi), in its default
summation order and in the CUDA kernel's (16 threads a rollout)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.sim import engine2d as jeng2
from dgdm_tpu.sim import pallas2d
from dgdm_tpu_torch.sim import engine2d as teng2
from dgdm_tpu_torch.sim import rollout2d
from dgdm_tpu_torch.sim.rollout2d_ref import profile_batch_ref
from tests.torch_parity import GOLDEN_JACOBI, NAMES, assert_k1_parity, golden
from tests.torch_parity_jax import interpret, k1_scenes

SCHEDULES = {"datagen": (200, 0, 0), "eval": (400, 200, 200)}


@pytest.fixture
def jacobi():
    """engine2d.SOLVER = "jacobi" in both packages for one test."""
    old = (jeng2.SOLVER, teng2.SOLVER)
    jeng2.SOLVER = teng2.SOLVER = "jacobi"
    yield
    jeng2.SOLVER, teng2.SOLVER = old


@pytest.fixture(scope="module")
def scenes():
    return k1_scenes()


@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_plain_jacobi_matches_pallas(scenes, schedule, jacobi):
    jst, tst, poses = scenes
    steps, rg, snap = SCHEDULES[schedule]
    with interpret(pallas2d):
        dth, dpos, fth, _, (cf, cc) = pallas2d.profile_batch_pallas(
            *pallas2d.scene_arrays(jst), jnp.asarray(poses), steps=steps,
            regrasp_every=rg, snapshot_step=snap, return_step_mix=True)
    ref = {"dth": dth, "dpx": np.asarray(dpos)[..., 0],
           "dpy": np.asarray(dpos)[..., 1], "cfull": cf, "ccheap": cc}
    arrs = rollout2d.scene_arrays(tst, device="cpu")
    # the Jacobi calibration rides in the scalar slots
    assert float(arrs[3][0, 0, 9]) == np.float32(teng2.FITTED_2D["k_contact"])
    out = rollout2d.rollout(*arrs, torch.from_numpy(poses), steps=steps,
                            regrasp_every=rg, snapshot_step=snap)
    out = {k: v.numpy() for k, v in zip(NAMES, out)}
    assert_k1_parity(out, ref)
    assert (out["ccheap"] == 0).all() and (out["cfull"] > 0).all()
    if schedule == "eval":
        ft = np.asarray(fth)
        assert float(np.mean(np.abs(out["fth"] - ft) < 1e-3)) >= 0.98
        assert np.corrcoef(out["fth"].ravel(), ft.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("sum_group", [0, rollout2d.THREADS_PER_ROLLOUT])
@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_plain_jacobi_matches_golden(schedule, sum_group):
    """The committed Jacobi golden outputs, the plain version adding its
    point sums in torch.sum's order (0) and in the CUDA kernel's (16)."""
    z, arrs, poses = golden(GOLDEN_JACOBI)
    assert str(z["solver"]) == "jacobi"
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    out = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, sum_group=sum_group,
                            solver="jacobi")
    assert_k1_parity({k: v.numpy() for k, v in zip(NAMES, out)},
                     {k: z[f"{schedule}_{k}"] for k in NAMES})


def test_solver_resolves_at_call_time():
    """solver=None reads engine2d.SOLVER when called; an unknown solver
    raises, also through engine2d.SOLVER."""
    z, arrs, poses = golden(GOLDEN_JACOBI)
    kw = dict(steps=200)
    old = teng2.SOLVER
    try:
        teng2.SOLVER = "jacobi"
        a = rollout2d.profile_batch(*arrs, poses, **kw)
        b = rollout2d.profile_batch(*arrs, poses, solver="jacobi", **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        teng2.SOLVER = "newton"
        c = rollout2d.profile_batch(*arrs, poses, **kw)
        assert not torch.equal(a[0], c[0])
        teng2.SOLVER = "gauss"
        with pytest.raises(ValueError, match="solver"):
            rollout2d.profile_batch(*arrs, poses, **kw)
    finally:
        teng2.SOLVER = old
    with pytest.raises(ValueError, match="solver"):
        rollout2d.rollout(*arrs, poses, solver="gauss")
