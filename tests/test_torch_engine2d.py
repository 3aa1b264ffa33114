"""The port's pure 2D engine (dgdm_tpu_torch/sim/engine2d.py) and its
verification schedule (eval/simeval.py::eval_rollout_batch) against the JAX
package's engine, jitted on the CPU, under both contact solvers
(``engine2d.SOLVER`` set in both packages; the JAX engine reads it at trace
time, so its caches are cleared around each switch).

Bars:

- one step from mid-squeeze states (step 180 of a JAX rollout, where both
  fingers touch the object somewhere in the batch): the same contact sets,
  every state field within 1e-5; the VJP with respect to the state and
  per-pose finger coefficients within 1e-4 of the largest JAX entry of
  each (one step is not chaotic; per-pose coefficients keep the comparison
  free of cross-pose cancellation); each Calib knob, a 0-d tensor whose
  gradient sums terms of both signs over the poses, within 1e-4 of the
  summed magnitudes of its per-pose JAX terms (per pose, the float32 VJP of
  either package lies up to ~5e-4 from a float64 one on these states:
  scripts/probe_engine2d_vjp.py);
- whole rollouts (chaotic, 200+ steps): the reference moved (max |dtheta| >
  1e-2), >= 99% of lanes within 1e-3 and corr >= 0.999 for dtheta and dpos
  (bar (a) of tests/torch_parity.py); after the 400-step schedule the final
  orientation by corr >= 0.999 and its 3-class change (metrics threshold)
  equal on >= 98% of lanes.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.eval import simeval as jsimeval
from dgdm_tpu.geom.contour import extract_contours
from dgdm_tpu.geom.fingers import sample_gripper_2d
from dgdm_tpu.sim import engine2d as J
from dgdm_tpu_torch.core.config import NORM
from dgdm_tpu_torch.eval import simeval as tsimeval
from dgdm_tpu_torch.eval.metrics import three_class
from dgdm_tpu_torch.geom.spline import gripper2d_spline
from dgdm_tpu_torch.sim import datagen as tdatagen
from dgdm_tpu_torch.sim import engine2d as T
from dgdm_tpu_torch.sim.types import State2D
from tests.torch_parity import assert_k1_parity
from tests.util_icons import make_icon

FIELDS = ("com", "theta", "vel", "om", "zb", "vz", "q", "qd")
KNOBS = ("mu_plane", "mu_finger", "mu_torsion", "k_contact", "b_contact",
         "unload", "rough", "c_r")
CTRL = (0.2, -0.2)


@pytest.fixture(params=["newton", "jacobi"])
def solver(request):
    old = (J.SOLVER, T.SOLVER)
    J.SOLVER = T.SOLVER = request.param
    jax.clear_caches()
    yield request.param
    J.SOLVER, T.SOLVER = old
    jax.clear_caches()


@pytest.fixture(scope="module")
def pairs():
    """Grippers 0 and 1 x icon 3 (100 contour points): stacked scenes of
    each package."""
    contour = extract_contours(make_icon(3))
    grips = [sample_gripper_2d(i) for i in range(2)]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs),
                       *[J.make_scene(*g, contour) for g in grips])
    tst = tdatagen.stack_scenes([T.make_scene(*g, contour) for g in grips])
    return jst, tst


def _poses(n, seed=0, jitter=0.01):
    rng = np.random.RandomState(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([rng.uniform(-jitter, jitter, n),
                     rng.uniform(-jitter, jitter, n), th],
                    -1).astype(np.float32)


def _tstate(jstate) -> State2D:
    return State2D(**{f: torch.tensor(np.asarray(getattr(jstate, f)))
                      for f in FIELDS})


_MID = {}


def _mid_squeeze(jst, solver):
    """JAX states after 180 steps of 16 orientations at the origin, (2
    pairs, 16 poses), under ``solver`` (computed once per solver)."""
    if solver not in _MID:
        ctrl = jnp.asarray(CTRL, jnp.float32)

        def one(sc, p):
            body = lambda s, _: (J.step(sc, s, ctrl), None)  # noqa: E731
            return jax.lax.scan(body, J.init_state(sc, p), None,
                                length=180)[0]

        _MID[solver] = jax.jit(jax.vmap(lambda sc: jax.vmap(
            lambda p: one(sc, p))(jnp.asarray(_poses(16, jitter=0.0)))))(jst)
    return _MID[solver]


def test_calib_tables_match_jax(solver):
    for tc, jc in ((T.default_calib(), J.default_calib()),
                   (T.nominal_calib(), J.nominal_calib())):
        for f in T.CALIB_FIELDS:
            assert np.float32(getattr(tc, f)) == np.float32(getattr(jc, f)), f
    table = T.FITTED_2D_NEWTON if solver == "newton" else T.FITTED_2D
    assert T.default_calib().k_contact == float(np.float32(table["k_contact"]))


def test_init_state_matches_jax(pairs):
    jst, tst = pairs
    poses = _poses(16)
    js = jax.vmap(lambda sc: jax.vmap(lambda p: J.init_state(sc, p))(
        jnp.asarray(poses)))(jst)
    ts = T.init_state(T.expand_scene(tst, 1), torch.from_numpy(poses))
    for f in FIELDS:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7, err_msg=f)


def _contacts(scene, state):
    _, _, _, _, px, py = T._point_kinematics(scene, state)
    return T._finger_contacts(scene, state, px, py)[3]


def test_step_matches_jax(pairs, solver):
    jst, tst = pairs
    jstate = _mid_squeeze(jst, solver)
    sc = T.expand_scene(tst, 1)
    ts = _tstate(jstate)
    ctrl = jnp.asarray(CTRL, jnp.float32)
    jout = jax.jit(jax.vmap(lambda s, st: jax.vmap(
        lambda x: J.step(s, x, ctrl))(st)))(jst, jstate)
    tout = T.step(sc, ts, torch.tensor(CTRL))
    # the same contact sets, both fingers touching somewhere
    act = _contacts(sc, ts).numpy()                    # (2, N, 2, P)
    def jact_of(s, x):
        _, r, pts_w, vel_pts = J._point_kinematics(s, x)
        return J._finger_contacts(s, x, pts_w, vel_pts, r)[2]

    jact = jax.vmap(jax.vmap(jact_of, in_axes=(None, 0)))(jst, jstate)
    np.testing.assert_array_equal(act, np.asarray(jact))
    per_finger = act.sum(-1)                           # (2, N, 2)
    assert (per_finger[..., 0] > 0).any() and (per_finger[..., 1] > 0).any()
    if solver == "newton":
        # poses that run the full 3 Newton iterations (the rest run 2)
        full = int((per_finger.sum(-1) > 0).sum())
        assert 0 < full < per_finger.shape[0] * per_finger.shape[1]
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_step_vjp_matches_jax(pairs, solver):
    jst, tst = pairs
    jstate = _mid_squeeze(jst, solver)
    n = 16
    ctrl = jnp.asarray(CTRL, jnp.float32)
    # per-(pair, pose) finger coefficients and calibration
    jcl = jnp.repeat(jst.coef_l[:, None], n, axis=1)
    jcr = jnp.repeat(jst.coef_r[:, None], n, axis=1)
    jcal0 = J.default_calib()
    jcal = jax.tree.map(lambda x: jnp.full((2, n), x, jnp.float32), jcal0)

    def f(state, cl, cr, cal):
        def one(sc, x, l, r, c):
            return J.step(sc.replace(coef_l=l, coef_r=r), x, ctrl, calib=c)
        return jax.vmap(lambda sc, st, l, r, c: jax.vmap(
            lambda x, l1, r1, c1: one(sc, x, l1, r1, c1))(st, l, r, c))(
            jst, state, cl, cr, cal)

    out = jax.eval_shape(f, jstate, jcl, jcr, jcal)
    rng = np.random.RandomState(1)
    cot = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), out)
    gst, gcl, gcr, gcal = jax.jit(
        lambda *a: jax.vjp(f, *a[:4])[1](a[4]))(jstate, jcl, jcr, jcal, cot)

    ts = State2D(**{k: torch.tensor(np.asarray(getattr(jstate, k)),
                                    requires_grad=True) for k in FIELDS})
    cl = torch.tensor(np.asarray(jcl), requires_grad=True)
    cr = torch.tensor(np.asarray(jcr), requires_grad=True)
    sc = dataclasses.replace(T.expand_scene(tst, 1), coef_l=cl, coef_r=cr)
    tcal = T.Calib(**{k: torch.tensor(float(getattr(jcal0, k)),
                                      requires_grad=True) for k in KNOBS})
    tout = T.step(sc, ts, torch.tensor(CTRL), calib=tcal)
    sum((getattr(tout, k) * torch.tensor(np.asarray(getattr(cot, k)))).sum()
        for k in FIELDS).backward()
    for k in FIELDS:
        assert _rel(getattr(ts, k).grad, getattr(gst, k)) < 1e-4, k
    assert np.abs(np.asarray(gcl)).max() > 0 and np.abs(
        np.asarray(gcr)).max() > 0
    assert _rel(cl.grad, gcl) < 1e-4 and _rel(cr.grad, gcr) < 1e-4
    # a knob's gradient is a sum over the poses, whose terms cancel: its
    # error is held relative to the sum of their magnitudes
    for k in KNOBS:
        g = getattr(tcal, k).grad
        g = 0.0 if g is None else float(g)
        per_pose = np.asarray(getattr(gcal, k), np.float64)
        err = abs(g - per_pose.sum()) / max(np.abs(per_pose).sum(), 1e-12)
        assert err < 1e-4, (k, g, per_pose.sum(), err)


def test_step_newton_forces_match_jax(pairs):
    jst, tst = pairs
    old = J.SOLVER
    J.SOLVER = "newton"
    try:
        jax.clear_caches()
        jstate = _mid_squeeze(jst, "newton")
    finally:
        J.SOLVER = old
    ctrl = jnp.asarray(CTRL, jnp.float32)
    _, jd = jax.jit(jax.vmap(lambda s, st: jax.vmap(lambda x: J.step_newton(
        s, x, ctrl, return_forces=True))(st)))(jst, jstate)
    _, td = T.step_newton(T.expand_scene(tst, 1), _tstate(jstate),
                          torch.tensor(CTRL), return_forces=True)
    for k in ("lam_n", "lam_t", "torque_fing", "torque_plane", "n_active",
              "depth", "act"):
        a, b = td[k].numpy(), np.asarray(jd[k])
        assert a.shape == b.shape, k
        assert _rel(a, b) < 1e-4, k


def test_profile_batch_matches_jax(pairs, solver):
    """engine2d.profile_batch through its caller
    ``profile_pairs_2d(use_pallas=False)``, 48 poses a chunk (the last one
    ragged), against the JAX engine's profile_batch."""
    jst, tst = pairs
    poses = _poses(64)
    jd, jp, jf = J.profile_batch(jst, jnp.asarray(poses))
    out = tdatagen.profile_pairs_2d(tst, poses, chunk=48, use_pallas=False,
                                    device="cpu")
    td, tp, tf = (out[k] for k in tdatagen.OUT_KEYS_2D)
    assert td.shape == (2, 64) and tp.shape == (2, 64, 2)
    jp = np.asarray(jp)
    assert_k1_parity({"dth": td, "dpx": tp[..., 0], "dpy": tp[..., 1]},
                     {"dth": np.asarray(jd), "dpx": jp[..., 0],
                      "dpy": jp[..., 1]})
    assert ((tf >= 0) & (tf < 2 * np.pi)).all()


def test_eval_rollout_batch_matches_jax(pairs, solver):
    """The verification schedule cut to 400 steps: regrasp every 200 and
    the first-squeeze snapshot at 200."""
    jst, tst = pairs
    thetas = np.linspace(0, 2 * np.pi, 64, endpoint=False).astype(np.float32)
    kw = dict(first_squeeze=200, total_steps=400, regrasp_every=200)
    jd, jp, jf, jfp = (np.asarray(a) for a in jsimeval.eval_rollout_batch(
        jst, jnp.asarray(thetas), **kw))
    td, tp, tf, tfp = (a.numpy() for a in tsimeval.eval_rollout_batch(
        tst, torch.from_numpy(thetas), **kw))
    assert td.shape == (2, 64) and tfp.shape == (2, 64, 2)
    assert_k1_parity({"dth": td, "dpx": tp[..., 0], "dpy": tp[..., 1]},
                     {"dth": jd, "dpx": jp[..., 0], "dpy": jp[..., 1]})
    assert np.corrcoef(tf.ravel(), jf.ravel())[0, 1] >= 0.999

    def cls(f):
        turn = (f - thetas + np.pi) % (2 * np.pi) - np.pi
        return three_class(turn, NORM.threshold_2d[0])

    assert float(np.mean(cls(tf) == cls(jf))) >= 0.98
    assert np.isfinite(tfp).all()


def test_rollout_trace_matches_jax(pairs):
    jst, tst = pairs
    jsc = jax.tree.map(lambda x: x[0], jst)
    tsc = _scene0(pairs)
    pose = np.asarray([0.0, 0.0, 2.0], np.float32)
    jt = np.asarray(J.rollout_trace(jsc, jnp.asarray(pose), steps=200,
                                    every=10))
    tt = T.rollout_trace(tsc, torch.from_numpy(pose), steps=200,
                         every=10).numpy()
    assert tt.shape == jt.shape == (20, 5)
    # the first rows, before the jaws reach the object
    np.testing.assert_allclose(tt[:8], jt[:8], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-3)


def _scene_at(stacked, b):
    """Pair b of a stacked scene."""
    return type(stacked)(**{f.name: getattr(stacked, f.name)[b]
                            for f in dataclasses.fields(stacked)})


def _scene0(pairs):
    return _scene_at(pairs[1], 0)


def test_grad_through_rollout_wrt_calib(pairs):
    """Port of tests/test_differentiability.py: d(dtheta^2)/d(log mu_plane)
    through a 220-step rollout at a contacting pose is finite and non-zero."""
    scene = _scene0(pairs)
    pose = torch.tensor([0.0, 0.0, 2.0])
    log_mu = torch.zeros((), requires_grad=True)
    calib = dataclasses.replace(T.default_calib(), mu_plane=torch.exp(log_mu))
    dth, _, _ = T.rollout(scene, pose, steps=220, calib=calib)
    (dth ** 2).backward()
    g = float(log_mu.grad)
    assert np.isfinite(g) and abs(g) > 0.0


def test_grad_through_rollout_wrt_gripper_shape(pairs):
    """d(rollout dtheta)/d(left finger control points)."""
    scene = _scene0(pairs)
    yl, _ = sample_gripper_2d(0)
    y = torch.tensor(yl, dtype=torch.float32, requires_grad=True)
    sc = dataclasses.replace(scene, coef_l=gripper2d_spline().coefs(y))
    dth, _, _ = T.rollout(sc, torch.tensor([0.0, 0.0, 2.0]), steps=220)
    dth.backward()
    g = y.grad.numpy()
    assert g.shape == (7,) and np.isfinite(g).all()
    assert np.abs(g).max() > 0.0
