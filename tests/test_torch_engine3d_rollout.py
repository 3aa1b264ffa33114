"""Whole rollouts of the port's pure 3D engine against the JAX package's
engine on the CPU: ``engine3d.profile_batch`` through its caller
``datagen3d.profile_pairs_3d(use_pallas=False)`` over 800 steps under the
Newton solver (Jacobi, ``eval_rollout_batch_3d`` and ``rollout_trace3d``:
tests/test_torch_engine3d_eval.py, a file of its own so that the two spread
over test workers), its pose chunks; and the solver switch
``engine3d.SOLVER3``, read at call time by the calibration, the pure engine,
the rollout kernel's wrappers and ``sim_eval_batch_3d``, an unknown solver
raising everywhere.

Scenes: grippers 2 and 3 x mug_small at 64 contact points, each package
building and baking its own; 8 orientations with positions jittered by
+-2 cm (at the origin the Jacobi engine barely moves: max |dtheta| 2.3e-3).
Bar (a) in 3D (ROADMAP): the reference moved (max |dtheta| > 1e-2); dtheta
within 2e-2 on every lane, the median |ddpos| <= 1e-3, validity equal. The
Jacobi engine is chaotic at its grip: a 1-ulp change of every initial
orientation moves the JAX engine itself by up to 2.7e-2 rad on these 16
lanes, 25% of them by more than 1e-3 (``scripts/probe_rollout3d_chaos.py
--solver jacobi --engine``), so under Jacobi the bar holds dtheta within 2e-2
on >= 90% of the lanes and its median within 1e-3 (ROADMAP Queue 3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.geom import mesh3d as jmesh
from dgdm_tpu.geom.fingers import sample_gripper_3d
from dgdm_tpu.sim import engine3d as J
from dgdm_tpu_torch.eval import simeval3d as tsimeval3d
from dgdm_tpu_torch.geom.fingers import normalize_y
from dgdm_tpu_torch.sim import datagen as tdatagen
from dgdm_tpu_torch.sim import datagen3d as tdatagen3d
from dgdm_tpu_torch.sim import engine3d as T
from dgdm_tpu_torch.sim import rollout3d
from dgdm_tpu_torch.sim.rollout3d_ref import profile_batch_ref
from tests.test_torch_engine3d import MUG, NUM_POINTS, N_POSES, poses16


def bar_a_3d(td, tp, tv, jd, jp, jv, chaotic=False):
    """Bar (a) in 3D (``chaotic``: its Jacobi form); prints the figures
    (pytest -s)."""
    jd, jp, jv = (np.asarray(a) for a in (jd, jp, jv))
    assert np.abs(jd).max() > 1e-2, "reference rollout did not move"
    err = np.abs(td - jd)
    dpos = float(np.median(np.abs(tp - jp)))
    print(f"max |ddtheta| {err.max():.3g} (within 2e-2 on "
          f"{np.mean(err <= 2e-2):.4f} of lanes, median {np.median(err):.3g})"
          f", median |ddpos| {dpos:.3g}, max |dtheta| {np.abs(jd).max():.3g}"
          f", valid equal {np.mean(tv == jv):.4f}")
    if chaotic:
        assert np.mean(err <= 2e-2) >= 0.9 and np.median(err) <= 1e-3
    else:
        assert err.max() <= 2e-2
    assert dpos <= 1e-3
    np.testing.assert_array_equal(tv, jv)


@pytest.fixture
def solver3():
    """Sets engine3d.SOLVER3 in both packages for one test."""
    old = (J.SOLVER3, T.SOLVER3)

    def set_(s):
        J.SOLVER3 = T.SOLVER3 = s
        jax.clear_caches()

    yield set_
    J.SOLVER3, T.SOLVER3 = old
    jax.clear_caches()


@pytest.fixture(scope="module")
def pairs():
    verts, faces = jmesh.load_obj(MUG)
    grips = [sample_gripper_3d(i) for i in (2, 3)]
    jp = J.object_properties_3d(verts, faces, num_points=NUM_POINTS)
    tp = T.object_properties_3d(verts, faces, num_points=NUM_POINTS)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        J.make_scene(*g, verts, faces, obj_props=jp) for g in grips])
    tst = tdatagen.stack_scenes([
        T.make_scene(*g, verts, faces, obj_props=tp) for g in grips])
    return jst, tst, (verts, faces)


def check_profile_batch(pairs, solver, solver3):
    """engine3d.profile_batch through profile_pairs_3d(use_pallas=False) in
    one chunk, 800 steps, against JAX's by bar (a) in 3D."""
    solver3(solver)
    jst, tst, _ = pairs
    poses = poses16(n=N_POSES)
    jd, jp, _, jv = J.profile_batch(jst, jnp.asarray(poses))
    assert tst.hgrid is None
    td, tp, tv = tdatagen3d.profile_pairs_3d(tst, poses, use_pallas=False,
                                             device="cpu")
    assert td.shape == (2, N_POSES) and tp.shape == (2, N_POSES, 2)
    assert tv.dtype == bool
    bar_a_3d(td, tp, tv, jd, jp, jv, chaotic=solver == "jacobi")


@pytest.mark.parametrize("solver", ["newton"])
def test_profile_batch_matches_jax(pairs, solver, solver3):
    check_profile_batch(pairs, solver, solver3)


def test_profile_pairs_3d_pose_chunks(pairs):
    """5 poses a chunk (the last one ragged) give the one-chunk result."""
    _, tst, _ = pairs
    poses = poses16(n=N_POSES)
    kw = dict(steps=40, use_pallas=False, device="cpu")
    one = tdatagen3d.profile_pairs_3d(tst, poses, **kw)
    five = tdatagen3d.profile_pairs_3d(tst, poses, pose_chunk=5, **kw)
    for a, b in zip(one, five):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_solver3_resolves_at_call_time(pairs, solver3):
    """SOLVER3 = "jacobi" gives Jacobi results in default_calib3, the pure
    engine's step, rollout3d.profile_batch (plain version on the CPU) and
    sim_eval_batch_3d; "newton" Newton ones."""
    jst, tst, (verts, faces) = pairs
    solver3("jacobi")
    assert T.default_calib3().k_contact == float(
        np.float32(J.default_calib3().k_contact))
    assert T.default_calib3().mu_plane == 1.0
    arrs = rollout3d.scene_arrays_3d(tst, device="cpu")
    assert float(arrs[2][0, 0, 12]) == 1.0          # Jacobi mu_plane slot
    poses = torch.from_numpy(tdatagen.pad_poses(poses16())[:128])
    kw = dict(steps=60)
    jac = rollout3d.profile_batch(*arrs, poses, return_step_mix=True, **kw)
    direct = profile_batch_ref(*arrs, poses, solver="jacobi", **kw)
    assert torch.equal(jac[-1][2], direct[11])
    # every normal Jacobi step is a full solve of SOLVER_ITERS sweeps
    assert float(jac[-1][1].max()) == 0.0
    assert torch.equal(jac[-1][2], jac[-1][0] * T.SOLVER_ITERS)
    newton = profile_batch_ref(*arrs, poses, solver="newton", **kw)
    assert not torch.equal(newton[11], direct[11])
    # the pure engine's step
    st = T.init_state(T.expand_scene3(T.with_hgrid(tst), 1),
                      torch.from_numpy(poses16()))
    sc = T.expand_scene3(T.with_hgrid(tst), 1)
    a = T.step(sc, st, torch.tensor([0.5, -0.5]))
    b = T.step_jacobi3(sc, st, torch.tensor([0.5, -0.5]))
    assert all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("pos", "vel", "om"))
    # sim_eval_batch_3d launches the Jacobi branch with its calibration
    y = np.concatenate(sample_gripper_3d(7))[None]
    m = tsimeval3d.sim_eval_batch_3d(normalize_y(y, fingers_3d=True),
                                     [(verts, faces)], num_rot=8,
                                     total_steps=120, regrasp_every=60,
                                     device="cpu")
    from dgdm_tpu_torch.geom.fingers import denormalize_y
    yd = denormalize_y(normalize_y(y, fingers_3d=True), fingers_3d=True)
    props = T.object_properties_3d(verts, faces)
    sarr = rollout3d.scene_arrays_3d(tdatagen.stack_scenes([T.make_scene(
        yd[0, :21], yd[0, 21:], verts, faces, obj_props=props)]),
        device="cpu")
    thetas = (np.linspace(-1.0, 1.0, 8) * np.pi + np.pi).astype(np.float32)
    th_p = tdatagen.pad_poses(thetas[:, None], 128)[:, 0]
    p = torch.from_numpy(np.stack([0 * th_p, 0 * th_p, th_p], -1))
    ref = rollout3d.profile_batch(*sarr, p, steps=120, regrasp_every=60,
                                  snapshot_step=60, solver="jacobi")
    np.testing.assert_array_equal(m[0]["delta_theta"],
                                  ref[0][0, :8].numpy() * 180 / np.pi)


def test_unknown_solver_raises(pairs, solver3):
    _, tst, _ = pairs
    arrs = rollout3d.scene_arrays_3d(tst, device="cpu")
    poses = torch.from_numpy(tdatagen.pad_poses(poses16())[:128])
    with pytest.raises(ValueError, match="solver"):
        rollout3d.profile_batch(*arrs, poses, steps=4, solver="gauss")
    solver3("gauss")
    for call in (T.default_calib3,
                 lambda: rollout3d.profile_batch(*arrs, poses, steps=4),
                 lambda: profile_batch_ref(*arrs, poses, steps=4),
                 lambda: T.profile_batch(tst, torch.from_numpy(poses16()),
                                         steps=2)):
        with pytest.raises(ValueError, match="solver"):
            call()
