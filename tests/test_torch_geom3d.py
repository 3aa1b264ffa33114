"""Port 3D geometry and scene building vs the JAX package: bit-exact 3D
gripper seeds, the B-spline surface (basis, height, slopes <= 1e-6), the
numpy mesh tools on both fixture objects (sampling equal under a seed, mass
properties <= 1e-9), the hull-envelope contact surface and its per-cell
polynomial fit (<= 1e-6 m), the host part of engine3d (finger masses, object
properties, make_scene) and the dense kernel inputs of scene_arrays_3d."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.geom import envelope3d as jenv
from dgdm_tpu.geom import fingers as jfingers
from dgdm_tpu.geom import mesh3d as jmesh
from dgdm_tpu.geom import spline as jspline
from dgdm_tpu.sim import engine2d as jeng2
from dgdm_tpu.sim import engine3d as jeng
from dgdm_tpu.sim import oracle3d as joracle
from dgdm_tpu.sim import pallas3d
from dgdm_tpu.sim import surface_fit as jfit
from dgdm_tpu_torch.core.config import GRIPPER_3D
from dgdm_tpu_torch.geom import envelope3d as tenv
from dgdm_tpu_torch.geom import fingers as tfingers
from dgdm_tpu_torch.geom import mesh3d as tmesh
from dgdm_tpu_torch.geom import spline as tspline
from dgdm_tpu_torch.sim import datagen as tdatagen
from dgdm_tpu_torch.sim import engine2d as teng2
from dgdm_tpu_torch.sim import engine3d as teng
from dgdm_tpu_torch.sim import rollout3d
from dgdm_tpu_torch.sim import rollout3d_ref
from dgdm_tpu_torch.sim import surface_fit as tfit

OBJECTS = os.path.join(os.path.dirname(__file__), "fixtures",
                       "scanned_objects")


def _mesh(name):
    return jmesh.load_obj(os.path.join(OBJECTS, name, "model.obj"))


def _query(seed, n=300):
    """Query points over and a little beyond the finger's (x, z) span."""
    g = GRIPPER_3D
    rs = np.random.RandomState(seed)
    x = rs.uniform(g.ctrl_x_min - 0.005, g.ctrl_x_max + 0.005, n)
    z = rs.uniform(g.ctrl_z_min - 0.005, g.ctrl_z_max + 0.005, n)
    return x.astype(np.float32), z.astype(np.float32)


def test_sample_gripper_3d_bit_exact():
    for i in range(64):
        for a, b in zip(tfingers.sample_gripper_3d(i),
                        jfingers.sample_gripper_3d(i)):
            np.testing.assert_array_equal(a, b)
    yl, yr = jfingers.sample_gripper_3d(3)
    np.testing.assert_array_equal(tfingers.ctrlpts_3d(yl, yr),
                                  jfingers.ctrlpts_3d(yl, yr))
    for f3d in (False, True):
        np.testing.assert_array_equal(
            tfingers.sample_grippers_batch(5, 4, fingers_3d=f3d),
            jfingers.sample_grippers_batch(5, 4, fingers_3d=f3d))
    y = np.linspace(-1, 1, 42).astype(np.float32)
    np.testing.assert_array_equal(
        tfingers.denormalize_y(y, fingers_3d=True),
        np.asarray(jfingers.denormalize_y(y, fingers_3d=True)))


def test_bspline_basis_and_operators():
    g = GRIPPER_3D
    for deg, n in ((g.degree_u, g.nu), (g.degree_v, g.nv)):
        kt, kj = (tspline.clamped_knot_vector(deg, n),
                  jspline.clamped_knot_vector(deg, n))
        np.testing.assert_array_equal(kt, kj)
        u = np.linspace(0.0, 1.0, 101)
        np.testing.assert_allclose(tspline.bspline_basis(deg, kt, n, u),
                                   jspline.bspline_basis(deg, kj, n, u),
                                   atol=1e-6)
        for a, b in zip(tspline._piecewise_poly_from_basis(deg, kt, n),
                        jspline._piecewise_poly_from_basis(deg, kj, n)):
            np.testing.assert_allclose(a, b, atol=1e-6)
    ts, js = tspline.gripper3d_surface(), jspline.gripper3d_surface()
    np.testing.assert_allclose(ts.grid_basis(25).numpy(),
                               np.asarray(js.grid_basis(25)), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7, 41])
def test_surface_height_and_slopes(seed):
    ts, js = tspline.gripper3d_surface(), jspline.gripper3d_surface()
    yl, _ = jfingers.sample_gripper_3d(seed)
    yc = yl.reshape(GRIPPER_3D.nu, GRIPPER_3D.nv).astype(np.float32)
    x, z = _query(seed)
    jh = np.asarray(js.height(jnp.asarray(yc), jnp.asarray(x), jnp.asarray(z)))
    th = ts.height(torch.from_numpy(yc), torch.from_numpy(x),
                   torch.from_numpy(z)).numpy()
    assert np.ptp(jh) > 1e-3
    np.testing.assert_allclose(th, jh, atol=1e-6, rtol=0)
    for a, b in zip(ts.slopes(torch.from_numpy(yc), torch.from_numpy(x),
                              torch.from_numpy(z)),
                    js.slopes(jnp.asarray(yc), jnp.asarray(x),
                              jnp.asarray(z))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["mug_small", "crate_big"])
def test_mesh3d_equal(name, tmp_path):
    path = os.path.join(OBJECTS, name, "model.obj")
    jv, jf = jmesh.load_obj(path)
    tv, tf = tmesh.load_obj(path)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tmesh.triangle_areas(tv, tf),
                                  jmesh.triangle_areas(jv, jf))
    for seed in (0, 3):
        np.testing.assert_array_equal(tmesh.sample_surface(tv, tf, 256, seed),
                                      jmesh.sample_surface(jv, jf, 256, seed))
    tm, tc, ti = tmesh.mass_properties(tv, tf, 700.0)
    jm, jc, ji = jmesh.mass_properties(jv, jf, 700.0)
    assert abs(tm - jm) <= 1e-9
    np.testing.assert_allclose(tc, jc, atol=1e-9, rtol=0)
    np.testing.assert_allclose(ti, ji, atol=1e-9, rtol=0)
    for a, b in zip(tmesh.bbox(tv), jmesh.bbox(jv)):
        np.testing.assert_array_equal(a, b)
    assert tmesh.filter_object(tv) == jmesh.filter_object(jv)
    assert tmesh.filter_object(tv, 0.01) == jmesh.filter_object(jv, 0.01)
    out = str(tmp_path / "m.obj")
    tmesh.save_obj(out, tv, tf)
    for a, b in zip(tmesh.load_obj(out), (tv, tf)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for a, b in zip(tmesh.box_mesh(0.03, 0.02, 0.04, 0.04),
                    jmesh.box_mesh(0.03, 0.02, 0.04, 0.04)):
        np.testing.assert_array_equal(a, b)


def test_surface_grid_and_slabs_equal():
    """The sheet the hulls are built on: float32 heights (<= 1e-6 m; the
    JAX side runs them jitted, where XLA may fuse multiply-adds)."""
    yl, yr = jfingers.sample_gripper_3d(2)
    np.testing.assert_allclose(tenv._surface_grid(yl),
                               joracle._surface_grid(yl), atol=1e-6, rtol=0)
    for a, b in zip(tenv._finger_slab_meshes(yr, 12, num_z=2),
                    joracle._finger_slab_meshes(yr, 12, num_z=2)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("side", ["upper", "lower"])
def test_finger_envelope_equal(side):
    yl, yr = jfingers.sample_gripper_3d(4)
    y = yl if side == "upper" else yr
    x, z = _query(5, 400)
    th, tsx, tsz = tenv.finger_envelope(y, x, z, side)
    jh, jsx, jsz = jenv.finger_envelope(y, x, z, side)
    assert np.ptp(jh) > 1e-3
    np.testing.assert_allclose(th, jh, atol=1e-6, rtol=0)
    # facet slopes (dimensionless) of hulls built on float32 sheets that
    # differ by a few ulp
    np.testing.assert_allclose(tsx, jsx, atol=5e-5, rtol=0)
    np.testing.assert_allclose(tsz, jsz, atol=5e-5, rtol=0)


def test_fit_surface_equal():
    ys = np.stack([np.concatenate(jfingers.sample_gripper_3d(i))[:21]
                   for i in range(3)])
    sides = ["upper", "lower", "upper"]
    tc = tfit.fit_surface_batch(ys, sides=sides)
    jc = jfit.fit_surface_batch(ys, sides=sides)
    assert tc.shape == (3, tfit.TOT_SEG, tfit.DEG_X + 1, tfit.DEG_Z + 1)
    assert (tfit.N_SEG, tfit.NZ_SEG, tfit.DEG_X, tfit.DEG_Z) == (
        jfit.N_SEG, jfit.NZ_SEG, jfit.DEG_X, jfit.DEG_Z)
    x, z = _query(6, 500)
    x, z = x.astype(np.float64), z.astype(np.float64)
    for i in range(3):
        th, jh = tfit.eval_fit(tc[i], x, z), jfit.eval_fit(jc[i], x, z)
        assert np.ptp(jh) > 1e-3
        np.testing.assert_allclose(th, jh, atol=1e-6, rtol=0)
    # the smooth-sheet fit (no envelope) against the float32 B-spline fit
    ts, js = tfit.fit_surface(ys[0]), jfit.fit_surface(ys[0])
    np.testing.assert_allclose(tfit.eval_fit(ts, x, z),
                               jfit.eval_fit(js, x, z), atol=1e-6, rtol=0)


def test_engine3d_host_constants():
    for name in ("K_PLANE3", "B_PLANE3", "SOLVER_ITERS", "V_REST_THRESH",
                 "CONTACT_SURFACE_3D", "FITTED_3D_NEWTON", "SOLVER3",
                 "FITTED_3D_PYRAMID", "UNLOAD3", "ROUGH3", "K_MULT3",
                 "HGRID_H", "HGRID_W", "_LS_ALPHAS3"):
        assert getattr(teng, name) == getattr(jeng, name), name
    # two Newton counts: the pure engine's and the kernel's
    assert teng.NEWTON_ITERS3 == jeng.NEWTON_ITERS3
    assert rollout3d.NEWTON_KERNEL_ITERS3 == pallas3d.NEWTON_KERNEL_ITERS3
    tc, jc = teng.default_calib3(), jeng.default_calib3()
    for name in teng2.CALIB_FIELDS:
        assert getattr(tc, name) == float(getattr(jc, name)), name
    assert teng2.default_calib().restitution == float(
        jeng2.default_calib().restitution) == 0.0
    assert rollout3d_ref.LANE == pallas3d.LANE
    assert rollout3d_ref.EPS_SETTLED == pallas3d.EPS_SETTLED


def test_finger_masses_and_object_properties():
    for i in (0, 9):
        yl, yr = jfingers.sample_gripper_3d(i)
        # hull volumes of the float32 sheets above
        np.testing.assert_allclose(teng.finger_masses_3d(yl, yr),
                                   jeng.finger_masses_3d(yl, yr),
                                   rtol=1e-6, atol=0)
    verts, faces = _mesh("mug_small")
    tp = teng.object_properties_3d(verts, faces)
    jp = jeng.object_properties_3d(verts, faces)
    assert len(tp) == len(jp) == 5 and tp[3].shape == (256, 3)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-9,
                                   rtol=0)


@pytest.mark.parametrize("name", ["mug_small", "crate_big"])
def test_make_scene_and_scene_arrays_equal(name):
    verts, faces = _mesh(name)
    grips = [jfingers.sample_gripper_3d(i) for i in (0, 5)]
    jp = jeng.object_properties_3d(verts, faces)
    tp = teng.object_properties_3d(verts, faces)
    js = [jeng.make_scene(*g, verts, faces, obj_props=jp) for g in grips]
    ts = [teng.make_scene(*g, verts, faces, obj_props=tp) for g in grips]
    for a, b in zip(ts, js):
        # the port bakes the height grid on the pure engine's first use
        # (tests/test_torch_engine3d.py holds the bake to JAX's)
        assert a.hgrid is None
        for f in dataclasses.fields(a):
            if f.name == "hgrid":
                continue
            np.testing.assert_allclose(getattr(a, f.name).numpy(),
                                       np.asarray(getattr(b, f.name)),
                                       atol=1e-6, err_msg=f.name)
    # make_scene without obj_props samples its own 192 points
    own = teng.make_scene(*grips[0], verts, faces)
    assert own.points.shape == (192, 3)
    np.testing.assert_allclose(
        own.points.numpy(),
        np.asarray(jeng.make_scene(*grips[0], verts, faces).points),
        atol=1e-6)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *js)
    tst = tdatagen.stack_scenes(ts)
    tc, tpts, tsc = rollout3d.scene_arrays_3d(tst, device="cpu")
    jc, jpts, jsc = (np.asarray(a) for a in pallas3d.scene_arrays_3d(jst))
    assert tc.shape == jc.shape == (2, 2, 24, 4, 3)
    assert tpts.shape == jpts.shape == (2, 256, 4)
    assert tsc.shape == jsc.shape == (2, 1, 32)
    np.testing.assert_allclose(tpts.numpy(), jpts, atol=1e-6)
    np.testing.assert_allclose(tsc.numpy(), jsc, atol=1e-6, rtol=1e-6)
    # the fitted per-cell polynomials: equal as surfaces to 1e-6 m
    x, z = _query(8, 400)
    x, z = x.astype(np.float64), z.astype(np.float64)
    for b in range(2):
        for f in range(2):
            th = tfit.eval_fit(tc[b, f].numpy().astype(np.float64), x, z)
            jh = jfit.eval_fit(jc[b, f].astype(np.float64), x, z)
            np.testing.assert_allclose(th, jh, atol=1e-6, rtol=0)
