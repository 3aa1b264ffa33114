"""The port's pure 3D engine (dgdm_tpu_torch/sim/engine3d.py) against the
JAX package's engine, jitted on the CPU, under its three contact solvers
(``engine3d.SOLVER3`` set in both packages; the JAX engine reads it at trace
time, so its caches are cleared around each switch): the calibration
tables, the finger height-grid bake, the bilinear lookup, the quaternion
helpers and initial states, one step and its VJP, and ``return_diag``; plus
ports of tests/test_engine3d.py::test_quat_math and
::test_pyramid_solver_smoke and of
tests/test_newton_solver.py::test_newton3d_settles_and_finite.

Scenes: grippers 2 and 3 x mug_small at 64 contact points, built by each
package; the port's scene takes the JAX scene's height grid, so that both
engines step from identical inputs. Bars:

- the bake: heights within 1e-7 m everywhere; slopes within 1e-6 for the
  smooth sheet and, for the hull envelope, within 5e-5 on >= 98% of the
  lattice nodes. The remaining nodes lie on facet edges of the envelope,
  where the two packages' float32 sheets (a few ulp apart) pick different
  facets of equal height: the slope there is discontinuous, and the heights
  still agree to 1e-7;
- one step from mid-squeeze states (step 760 of a Newton squeeze of 8
  jittered poses, fingers touching in the batch; every solver steps from
  them): every state leaf within 1e-4 of its largest entry; its VJP (state
  leaves and per-pose calibration knobs) likewise for the leaves, and each
  knob within 1e-4 of the summed magnitudes of its per-pose JAX terms (a
  knob's gradient sums terms of both signs over the poses; ROADMAP Queue 3,
  "Calibration gradients").
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.geom import mesh3d as jmesh
from dgdm_tpu.geom.fingers import sample_gripper_3d
from dgdm_tpu.sim import engine2d as J2
from dgdm_tpu.sim import engine3d as J
from dgdm_tpu.sim.types import State3D as JState3D
from dgdm_tpu_torch.geom import mesh3d as tmesh
from dgdm_tpu_torch.sim import datagen as tdatagen
from dgdm_tpu_torch.sim import engine2d as T2
from dgdm_tpu_torch.sim import engine3d as T
from dgdm_tpu_torch.sim.types import State3D
from tests import torch_parity  # noqa: F401  (one intra-op thread)

MUG = os.path.join(os.path.dirname(__file__), "fixtures", "scanned_objects",
                   "mug_small", "model.obj")
FIELDS = ("pos", "quat", "vel", "om", "q", "qd")
CTRL = (0.5, -0.5)
SOLVERS = ("newton", "jacobi", "pyramid")
NUM_POINTS = 64
N_POSES = 8
# the knobs each solver reads
KNOBS = {
    "newton": ("mu_plane", "mu_finger", "k_contact", "b_contact", "unload",
               "rough", "c_r", "restitution", "w_fmult", "plane_corner",
               "clamp_k", "clamp_w", "ram", "clamp_press", "mu_ballistic",
               "om_release"),
    "jacobi": ("mu_plane", "mu_finger", "k_contact", "b_contact", "unload",
               "rough"),
    "pyramid": ("mu_plane", "mu_finger", "k_contact", "b_contact", "unload",
                "c_r"),
}


@pytest.fixture(params=SOLVERS)
def solver(request):
    old = (J.SOLVER3, T.SOLVER3)
    J.SOLVER3 = T.SOLVER3 = request.param
    jax.clear_caches()
    yield request.param
    J.SOLVER3, T.SOLVER3 = old
    jax.clear_caches()


@pytest.fixture(scope="module")
def pairs():
    """Grippers 2-3 x mug_small (64 contact points): stacked scenes of each
    package; the port's carries the JAX scene's height grid."""
    verts, faces = jmesh.load_obj(MUG)
    grips = [sample_gripper_3d(i) for i in (2, 3)]
    jp = J.object_properties_3d(verts, faces, num_points=NUM_POINTS)
    tp = T.object_properties_3d(verts, faces, num_points=NUM_POINTS)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        J.make_scene(*g, verts, faces, obj_props=jp) for g in grips])
    tst = tdatagen.stack_scenes([
        T.make_scene(*g, verts, faces, obj_props=tp) for g in grips])
    tst = dataclasses.replace(tst, hgrid=torch.tensor(np.asarray(jst.hgrid)))
    return jst, tst


def poses16(seed=0, n=16):
    """n orientations with positions jittered by +-2 cm (orientations at
    the origin barely move the Jacobi engine)."""
    rng = np.random.RandomState(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([rng.uniform(-0.02, 0.02, n),
                     rng.uniform(-0.02, 0.02, n), th], -1).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _tstate(jstate, grad=False) -> State3D:
    return State3D(**{f: torch.tensor(np.asarray(getattr(jstate, f)),
                                      requires_grad=grad) for f in FIELDS})


_MID = {}


def _mid_squeeze(jst, tst):
    """A mid-squeeze JAX state (2 pairs x 8 poses): step 760 of a Newton
    squeeze from 8 jittered poses, computed once with the port's engine (one
    torch thread; the jitted JAX scan is several times slower on a CPU that
    parallel test workers share, and the two trajectories agree to 5e-7
    rad); every solver's step starts from it."""
    if not _MID:
        old = T.SOLVER3
        T.SOLVER3 = "newton"
        try:
            sc = T.expand_scene3(tst, 1)
            ctrl = torch.tensor(CTRL)
            st = T.init_state(sc, torch.from_numpy(poses16(n=N_POSES)))
            for _ in range(760):
                st = T.step(sc, st, ctrl)
        finally:
            T.SOLVER3 = old
        _MID["state"] = JState3D(**{f: jnp.asarray(getattr(st, f).numpy())
                                    for f in FIELDS})
    return _MID["state"]


def test_calib_tables_match_jax(solver):
    tc, jc = T.default_calib3(), J.default_calib3()
    for f in T2.CALIB_FIELDS:
        assert np.float32(getattr(tc, f)) == np.float32(getattr(jc, f)), f
    if solver == "jacobi":
        assert tc.k_contact == float(np.float32(T2.K_CONTACT * T.K_MULT3))
        assert tc.c_r == float(np.float32(0.0526))
    else:
        table = T.FITTED_3D_NEWTON if solver == "newton" \
            else T.FITTED_3D_PYRAMID
        assert tc.k_contact == float(np.float32(table["k_contact"]))


def test_calib_knob_defaults_match_jax():
    """The ten 3D probe knobs of Calib: JAX's defaults, exact no-ops."""
    assert len(T2.CALIB_FIELDS) == len(J2.CALIB_FIELDS) == 19
    assert set(T2.CALIB_FIELDS) == set(J2.CALIB_FIELDS)
    jd = J2.default_calib()
    td = T2.default_calib()
    for f in T2.CALIB_FIELDS[8:]:
        assert getattr(td, f) == float(getattr(jd, f)), f


@pytest.mark.parametrize("surface", ["envelope", "smooth"])
def test_bake_height_grids_matches_jax(surface):
    old = (J.CONTACT_SURFACE_3D, T.CONTACT_SURFACE_3D)
    J.CONTACT_SURFACE_3D = T.CONTACT_SURFACE_3D = surface
    try:
        yl, yr = sample_gripper_3d(2)
        tg, jg = T.bake_height_grids(yl, yr), np.asarray(
            J.bake_height_grids(yl, yr))
    finally:
        J.CONTACT_SURFACE_3D, T.CONTACT_SURFACE_3D = old
    assert tg.shape == jg.shape == (2, T.HGRID_H, T.HGRID_W, 3)
    assert tg.dtype == np.float32 and np.ptp(jg[..., 0]) > 1e-3
    np.testing.assert_allclose(tg[..., 0], jg[..., 0], atol=1e-7, rtol=0)
    err = np.abs(tg[..., 1:] - jg[..., 1:]).max(-1)
    if surface == "smooth":
        assert err.max() < 1e-6
    else:
        frac = float(np.mean(err < 5e-5))
        print(f"envelope slopes within 5e-5 on {frac:.4f} of the nodes")
        assert frac >= 0.98


def test_hgrid_is_baked_on_first_use_only(pairs):
    """make_scene leaves the grid unset (the kernel's paths never bake);
    with_hgrid fills it per pair from the LRU, with the bake's values."""
    verts, faces = tmesh.load_obj(MUG)
    props = T.object_properties_3d(verts, faces, num_points=64)
    grips = [sample_gripper_3d(i) for i in (5, 6)]
    st = tdatagen.stack_scenes([T.make_scene(*g, verts, faces,
                                             obj_props=props)
                                for g in grips])
    assert st.hgrid is None and st.bottom_pts.shape == (2, 1, 3)
    filled = T.with_hgrid(st)
    assert filled.hgrid.shape == (2, 2, T.HGRID_H, T.HGRID_W, 3)
    assert T.with_hgrid(filled) is filled
    y = st.yl[1].numpy().astype(np.float64).reshape(-1), \
        st.yr[1].numpy().astype(np.float64).reshape(-1)
    np.testing.assert_array_equal(filled.hgrid[1].numpy(),
                                  T.bake_height_grids(*y))


def test_bilerp_and_its_vjp_match_jax():
    rng = np.random.RandomState(0)
    grid = rng.normal(size=(T.HGRID_H, T.HGRID_W, 3)).astype(np.float32)
    # inside, on the edges and beyond the lattice (clipped)
    x = rng.uniform(-0.13, 0.13, 300).astype(np.float32)
    z = rng.uniform(-0.01, 0.13, 300).astype(np.float32)
    jout, vjp = jax.vjp(J._bilerp, jnp.asarray(grid), jnp.asarray(x),
                        jnp.asarray(z))
    tg, tx, tz = (torch.tensor(a, requires_grad=True) for a in (grid, x, z))
    tout = T._bilerp(tg, tx, tz)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-6, rtol=1e-6)
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jg = vjp(jnp.asarray(cot))
    (tout * torch.tensor(cot)).sum().backward()
    for a, b in zip((tg.grad, tx.grad, tz.grad), jg):
        assert _rel(a, b) < 1e-5


def test_quat_math():
    """Port of tests/test_engine3d.py::test_quat_math."""
    th = 1.1
    q = torch.tensor([np.cos(th / 2), 0, 0, np.sin(th / 2)],
                     dtype=torch.float32)
    r = T.quat_to_mat(q).numpy()
    expect = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    np.testing.assert_allclose(r, expect, atol=1e-6)
    np.testing.assert_allclose(float(T._z_angle(q)), th, atol=1e-6)
    q2 = q
    for _ in range(100):
        q2 = T.quat_integrate(q2, torch.tensor([0.0, 0.0, 1.0]), 0.001)
    np.testing.assert_allclose(float(T._z_angle(q2)), th + 0.1, atol=1e-3)
    # and against JAX on random quaternions and spins
    rng = np.random.RandomState(1)
    qs = rng.normal(size=(5, 4)).astype(np.float32)
    oms = rng.normal(size=(5, 3)).astype(np.float32)
    for qa, oa in zip(qs, oms):
        np.testing.assert_allclose(
            T.quat_integrate(torch.tensor(qa), torch.tensor(oa), 0.002),
            np.asarray(J.quat_integrate(jnp.asarray(qa), jnp.asarray(oa),
                                        0.002)), atol=1e-6)
        np.testing.assert_allclose(
            T.quat_to_mat(torch.tensor(qa)),
            np.asarray(J.quat_to_mat(jnp.asarray(qa))), atol=1e-6)


def test_init_state_matches_jax(pairs):
    jst, tst = pairs
    poses = poses16()
    js = jax.vmap(lambda sc: jax.vmap(lambda p: J.init_state(sc, p))(
        jnp.asarray(poses)))(jst)
    ts = T.init_state(T.expand_scene3(tst, 1), torch.from_numpy(poses))
    for f in FIELDS:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.shape == b.shape == (2, 16) + b.shape[2:], f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=f)


def test_step_matches_jax(pairs, solver):
    jst, tst = pairs
    jstate = _mid_squeeze(jst, tst)
    ctrl = jnp.asarray(CTRL, jnp.float32)
    jout = jax.jit(jax.vmap(lambda s, st: jax.vmap(
        lambda x: J.step(s, x, ctrl))(st)))(jst, jstate)
    sc = T.expand_scene3(tst, 1)
    ts = _tstate(jstate)
    tout = T.step(sc, ts, torch.tensor(CTRL))
    # fingers touch somewhere in the batch: the step exercises the contacts
    act = T._contacts(sc, ts).act.sum(-1).numpy()        # (2, 8, 3)
    assert act[..., :2].sum() > 0 and act[..., 2].sum() > 0
    for f in FIELDS:
        assert _rel(getattr(tout, f).numpy(), getattr(jout, f)) < 1e-4, f


def test_step_vjp_matches_jax(pairs, solver):
    jst, tst = pairs
    jstate = _mid_squeeze(jst, tst)
    n = N_POSES
    ctrl = jnp.asarray(CTRL, jnp.float32)
    knobs = KNOBS[solver]
    jcal0 = J.default_calib3()
    jcal = jax.tree.map(lambda x: jnp.full((2, n), x, jnp.float32), jcal0)

    def f(state, cal):
        return jax.vmap(lambda sc, st, c: jax.vmap(
            lambda x, c1: J.step(sc, x, ctrl, calib=c1))(st, c))(
            jst, state, cal)

    out = jax.eval_shape(f, jstate, jcal)
    rng = np.random.RandomState(1)
    cot = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), out)
    gst, gcal = jax.jit(lambda s, c, ct: jax.vjp(f, s, c)[1](ct))(
        jstate, jcal, cot)

    ts = _tstate(jstate, grad=True)
    tcal = T2.Calib(**{k: torch.tensor(float(getattr(jcal0, k)),
                                       requires_grad=k in knobs)
                       for k in T2.CALIB_FIELDS})
    tout = T.step(T.expand_scene3(tst, 1), ts, torch.tensor(CTRL),
                  calib=tcal)
    sum((getattr(tout, k) * torch.tensor(np.asarray(getattr(cot, k)))).sum()
        for k in FIELDS).backward()
    for k in FIELDS:
        assert _rel(getattr(ts, k).grad, getattr(gst, k)) < 1e-4, k
    for k in knobs:
        g = getattr(tcal, k).grad
        g = 0.0 if g is None else float(g)
        per_pose = np.asarray(getattr(gcal, k), np.float64)
        err = abs(g - per_pose.sum()) / max(np.abs(per_pose).sum(), 1e-12)
        assert err < 1e-4, (k, g, per_pose.sum(), err)


def test_return_diag_matches_jax(pairs):
    jst, tst = pairs
    old = (J.SOLVER3, T.SOLVER3)
    J.SOLVER3 = T.SOLVER3 = "newton"
    try:
        jax.clear_caches()
        jstate = _mid_squeeze(jst, tst)
        ctrl = jnp.asarray(CTRL, jnp.float32)
        _, jd = jax.jit(jax.vmap(lambda s, st: jax.vmap(
            lambda x: J.step_newton3(s, x, ctrl, return_diag=True))(st)))(
            jst, jstate)
        _, td = T.step_newton3(T.expand_scene3(tst, 1), _tstate(jstate),
                               torch.tensor(CTRL), return_diag=True)
    finally:
        J.SOLVER3, T.SOLVER3 = old
        jax.clear_caches()
    assert set(td) == set(jd)
    for k in jd:
        a, b = td[k].numpy(), np.asarray(jd[k])
        assert a.shape == b.shape, k
        assert _rel(a, b) < 1e-4, k


def test_pyramid_solver_smoke():
    """Port of tests/test_engine3d.py::test_pyramid_solver_smoke: the
    pyramidal-cone solver integrates stably with its calibration."""
    verts, faces = tmesh.box_mesh(0.035, 0.045, 0.04, 0.04)
    scene = T.with_hgrid(T.make_scene(*sample_gripper_3d(0), verts, faces,
                                      num_points=64))
    old = T.SOLVER3
    try:
        T.SOLVER3 = "pyramid"
        calib = T.default_calib3()
        st = T.init_state(scene, torch.tensor([0.0, 0.0, 0.4]))
        ctrl = torch.tensor([0.5, -0.5])
        for _ in range(300):
            st = T.step_newton3_pyramid(scene, st, ctrl, calib=calib)
    finally:
        T.SOLVER3 = old
    pos = st.pos.numpy()
    assert np.isfinite(pos).all() and np.isfinite(st.om.numpy()).all()
    assert np.abs(pos).max() < 0.5
    q = st.q.numpy()
    assert q[0] > 0.01 and q[1] < -0.01


def test_newton3d_settles_and_finite():
    """Port of tests/test_newton_solver.py::test_newton3d_settles_and_finite:
    a grounded box must not tip over."""
    verts, faces = tmesh.box_mesh(0.035, 0.045, 0.04, 0.04)
    yl, yr = sample_gripper_3d(1)
    scene = T.make_scene(yl, yr, verts, faces, num_points=128)
    old = T.SOLVER3
    T.SOLVER3 = "newton"
    try:
        poses = np.stack([np.zeros(4), np.zeros(4),
                          np.linspace(0, np.pi, 4)], -1).astype(np.float32)
        dth, dpos, fth, valid = T.profile(scene, torch.from_numpy(poses),
                                          steps=200)
    finally:
        T.SOLVER3 = old
    assert np.isfinite(dth.numpy()).all() and np.isfinite(dpos.numpy()).all()
    assert valid.numpy().all()
