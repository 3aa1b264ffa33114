"""The Jacobi branch of the port's 3D rollout (kernel K2's plain version,
``solver="jacobi"``, ``pallas3d.py:302-433``) vs the JAX package's Pallas
kernel run in interpret mode on the CPU, with ``engine3d.SOLVER3`` set to
"jacobi" in both packages so that the scene arrays carry the Jacobi
calibration and the solver resolves from it at call time; and vs the golden
fixture of the TPU kernel (scripts/export_rollout3d_golden.py --solver
jacobi: grippers 0-1 x mug_small x 128 orientations, 256 contact points).

The 3D Jacobi squeeze is chaotic at its grip (ROADMAP Queue 3): a 1-ulp
change of every initial orientation leaves only 83.2% of the 256 lanes'
dtheta within 1e-3 of the Pallas kernel's own run after 800 steps, with
changes up to 0.178 rad (81.3% for the plain version; dpx 99.2%, dpy 97.7%;
the final tip-over flag equal on 96.9%; scripts/probe_rollout3d_chaos.py
--solver jacobi). So the rollouts are held by bars set from that probe, and
the phase before the grip tightly:

- 300 steps (the drop onto the plane, every step a full Jacobi solve): all
  four raw pose planes within 1e-5 of the Pallas kernel, counters equal;
- 800 steps (datagen), the reference moved (max |dtheta| > 1e-2): >= 75% of
  lanes within 1e-3 for dtheta and >= 95% for dpx and dpy, the median
  |ddtheta| <= 1e-4, validity equal on >= 95% of lanes, the full-step and
  iteration counters equal per 128-pose block (every normal step a full
  solve of 8 sweeps; no cheap steps).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.sim import engine3d as J
from dgdm_tpu.sim import pallas3d
from dgdm_tpu_torch.sim import engine3d as T
from dgdm_tpu_torch.sim import rollout3d
from dgdm_tpu_torch.sim.rollout3d_ref import profile_batch_ref
from tests.torch_parity import NAMES3, k2_profile
from tests.torch_parity_jax import interpret, k2_profiles, k2_scene_arrays

GOLDEN_JACOBI3 = os.path.join(os.path.dirname(__file__), "fixtures",
                              "rollout3d_jacobi_golden.npz")


def assert_jacobi_profiles(a, b, lane=128):
    """The chaos-aware bars of the module docstring on read-out profiles;
    prints the figures (pytest -s)."""
    assert np.abs(b["dth"]).max() > 1e-2, "reference rollout did not move"
    for k, need in (("dth", 0.75), ("dpx", 0.95), ("dpy", 0.95)):
        err = np.abs(np.asarray(a[k]) - np.asarray(b[k]))
        assert np.isfinite(a[k]).all(), k
        frac = float(np.mean(err < 1e-3))
        print(f"{k}: {frac:.4f} of lanes within 1e-3, median err "
              f"{np.median(err):.3g}, max err {err.max():.3g}")
        assert frac >= need, (k, frac)
        if k == "dth":
            assert np.median(err) <= 1e-4
    valid = float(np.mean(np.asarray(a["valid"]) == np.asarray(b["valid"])))
    print(f"validity equal on {valid:.4f} of lanes")
    assert valid >= 0.95
    for k in ("cfull", "ccheap", "citer"):
        np.testing.assert_array_equal(np.asarray(a[k])[:, ::lane],
                                      np.asarray(b[k])[:, ::lane])


@pytest.fixture
def jacobi():
    """engine3d.SOLVER3 = "jacobi" in both packages for one test."""
    old = (J.SOLVER3, T.SOLVER3)
    J.SOLVER3 = T.SOLVER3 = "jacobi"
    jax.clear_caches()
    yield
    J.SOLVER3, T.SOLVER3 = old
    jax.clear_caches()


def _pallas_raw(jarrs, poses, steps):
    """The Pallas kernel's profiles with counters (interpret mode)."""
    with interpret(pallas3d):
        *res, mix = pallas3d.profile_batch_pallas3d(
            *jarrs, jnp.asarray(poses), steps=steps, return_step_mix=True)
    return k2_profiles(res, mix)


@pytest.mark.parametrize("steps", [300, 800])
def test_plain_jacobi_matches_pallas(steps, jacobi):
    """Gripper 2 x mug_small x 128 orientations, the scenes built on each
    side by its own package."""
    jarrs, tarrs, poses = k2_scene_arrays()
    jarrs = [a[:1] for a in jarrs]
    tarrs = [a[:1] for a in tarrs]
    # the Jacobi calibration rides in the scalar slots
    assert float(tarrs[2][0, 0, 14]) == np.float32(T.default_calib3()
                                                   .k_contact)
    assert float(tarrs[2][0, 0, 12]) == 1.0
    ref = _pallas_raw(jarrs, poses, steps)
    *res, mix = rollout3d.profile_batch(*tarrs, torch.from_numpy(poses),
                                        steps=steps, return_step_mix=True)
    out = k2_profiles(res, mix)
    assert (out["ccheap"] == 0).all() and (out["cfull"] == steps).all()
    assert (out["citer"] == steps * T.SOLVER_ITERS).all()
    if steps == 300:
        for k in ("dth", "dpx", "dpy", "fth"):
            err = np.abs(out[k] - ref[k])
            print(f"{k}: max err {err.max():.3g} after {steps} steps")
            assert err.max() <= 1e-5, k
        for k in ("valid", "cfull", "ccheap", "citer"):
            np.testing.assert_array_equal(out[k], ref[k])
    else:
        assert_jacobi_profiles(out, ref)


def test_plain_jacobi_matches_golden():
    """The committed Jacobi golden outputs at the datagen schedule (the
    plain version in its default summation order; the CUDA kernel's order
    is held bitwise to the kernel by tests/test_torch_rollout3d_cuda.py)."""
    z = np.load(GOLDEN_JACOBI3)
    assert str(z["solver"]) == "jacobi"
    arrs = [torch.from_numpy(z[k]) for k in ("coefs", "points", "scalars")]
    poses = torch.from_numpy(z["poses"])
    steps, rg, snap = (int(v) for v in z["datagen_schedule"])
    assert (steps, rg, snap) == (800, 0, 0)
    out = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, solver="jacobi")
    assert_jacobi_profiles(
        k2_profile({k: v.numpy() for k, v in zip(NAMES3, out)}, z["poses"]),
        k2_profile({k: z[f"datagen_{k}"] for k in NAMES3}, z["poses"]))
