"""Port geometry and scene building vs the JAX package: config values,
bit-exact gripper seeds, spline operators, synthetic shapes, contours,
make_scene and
scene_arrays (<= 1e-6), pose grids."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.core import config as jcfg
from dgdm_tpu.geom import contour as jcontour
from dgdm_tpu.geom import fingers as jfingers
from dgdm_tpu.geom import shapes as jshapes
from dgdm_tpu.geom import spline as jspline
from dgdm_tpu.sim import engine2d as jeng
from dgdm_tpu.sim import pallas2d
from dgdm_tpu_torch.core import config as tcfg
from dgdm_tpu_torch.geom import contour as tcontour
from dgdm_tpu_torch.geom import fingers as tfingers
from dgdm_tpu_torch.geom import shapes as tshapes
from dgdm_tpu_torch.geom import spline as tspline
from dgdm_tpu_torch.sim import datagen as tdatagen
from dgdm_tpu_torch.sim import engine2d as teng
from dgdm_tpu_torch.sim import rollout2d
from tests.util_icons import make_icon


@pytest.mark.parametrize("name", ["GRIPPER_2D", "GRIPPER_3D", "OBJECT_2D",
                                  "OBJECT_3D", "SIM", "NORM", "DIFFUSION",
                                  "GUIDANCE"])
def test_config_fields_equal(name):
    a, b = getattr(tcfg, name), getattr(jcfg, name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    if name == "SIM":
        assert (a.contact_k, a.contact_b) == (b.contact_k, b.contact_b)
    assert tcfg.GUIDED_OBJECTIVES == jcfg.GUIDED_OBJECTIVES
    assert tcfg.ALL_OBJECTIVES == jcfg.ALL_OBJECTIVES
    assert tcfg.ICON_TEST_OBJECT_IDS == jcfg.ICON_TEST_OBJECT_IDS


def test_sample_gripper_2d_bit_exact():
    for i in range(64):
        for a, b in zip(tfingers.sample_gripper_2d(i),
                        jfingers.sample_gripper_2d(i)):
            np.testing.assert_array_equal(a, b)
    yl, yr = jfingers.sample_gripper_2d(3)
    np.testing.assert_array_equal(tfingers.ctrlpts_2d(yl, yr),
                                  jfingers.ctrlpts_2d(yl, yr))
    y = np.linspace(-1, 1, 14).astype(np.float32)
    np.testing.assert_array_equal(tfingers.denormalize_y(y),
                                  np.asarray(jfingers.denormalize_y(y)))
    np.testing.assert_allclose(tfingers.normalize_y(tfingers.denormalize_y(y)),
                               y, atol=1e-6)


def test_spline_operators_equal():
    np.testing.assert_array_equal(tspline._cubic_moment_operator(7),
                                  jspline._cubic_moment_operator(7))
    np.testing.assert_array_equal(tspline.cubic_coef_operator(7, -0.12, 0.12),
                                  jspline.cubic_coef_operator(7, -0.12, 0.12))
    xq = np.linspace(-0.12, 0.12, 200)
    np.testing.assert_array_equal(
        tspline.cubic_basis_matrix(7, -0.12, 0.12, xq),
        jspline.cubic_basis_matrix(7, -0.12, 0.12, xq))
    ts, js = tspline.gripper2d_spline(), jspline.gripper2d_spline()
    yl, _ = jfingers.sample_gripper_2d(5)
    y = yl.astype(np.float32)
    jc = np.asarray(js.coefs(jnp.asarray(y)))
    tc = ts.coefs(torch.from_numpy(y))
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-6)
    x = np.random.RandomState(0).uniform(-0.13, 0.13, 50).astype(np.float32)
    jv, jd = js.evaluate_with_derivative(jnp.asarray(jc), jnp.asarray(x))
    tv, td = ts.evaluate_with_derivative(torch.from_numpy(jc.copy()),
                                         torch.from_numpy(x))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3, 5, 10000])
def test_contours_equal(seed):
    img = make_icon(seed) if seed < 100 else tcontour.synthetic_icon(seed)
    from dgdm_tpu.cli.datagen import synthetic_icon

    if seed >= 100:
        np.testing.assert_array_equal(img, synthetic_icon(seed))
    np.testing.assert_array_equal(tcontour.extract_contours(img),
                                  jcontour.extract_contours(img))


@pytest.mark.parametrize("family", tshapes.FAMILIES)
def test_shapes_equal(family):
    for seed in range(3):
        np.testing.assert_array_equal(tshapes.synthetic_icon(seed, family),
                                      jshapes.synthetic_icon(seed, family))
    i = tshapes.FAMILIES.index(family)
    img = tshapes.suite_icon(i)
    np.testing.assert_array_equal(img, jshapes.suite_icon(i))
    np.testing.assert_array_equal(tcontour.extract_contours(img),
                                  jcontour.extract_contours(img))


@pytest.mark.parametrize("icon,grip", [(3, 0), (5, 7)])
def test_make_scene_and_scene_arrays_equal(icon, grip):
    contour = jcontour.extract_contours(make_icon(icon))
    yl, yr = jfingers.sample_gripper_2d(grip)
    js = jeng.make_scene(yl, yr, contour)
    ts = teng.make_scene(yl, yr, contour)
    for f in dataclasses.fields(ts):
        np.testing.assert_allclose(getattr(ts, f.name).numpy(),
                                   np.asarray(getattr(js, f.name)),
                                   atol=1e-6, err_msg=f.name)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), js, js)
    tst = tdatagen.stack_scenes([ts, ts])
    for a, b in zip(rollout2d.scene_arrays(tst, device="cpu"),
                    pallas2d.scene_arrays(jst)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_pose_grids_equal():
    for g, p in ((360, 5), (12, 1), (8, 2)):
        np.testing.assert_array_equal(teng.pose_grid(g, p), jeng.pose_grid(g, p))
    assert teng.pose_grid().shape == (9000, 3)
    padded = tdatagen.pad_poses(teng.pose_grid())
    assert padded.shape == (9088, 3)
    np.testing.assert_array_equal(padded[9000:], np.broadcast_to(
        padded[8999], (88, 3)))


def test_calib_and_constants_equal():
    tc, jc = teng.default_calib(), jeng.default_calib()
    for name in teng.CALIB_FIELDS:
        assert getattr(tc, name) == float(getattr(jc, name)), name
    for name in ("K_CONTACT", "B_CONTACT", "K_PLANE", "B_PLANE", "UNLOAD",
                 "DEPTH_EL_CAP", "ROUGH", "ROUGH_SAT", "SOLVER_ITERS",
                 "IMPEDANCE", "NEWTON_ITERS", "_LS_ALPHAS", "SOLVER",
                 "FITTED_2D_NEWTON"):
        assert getattr(teng, name) == getattr(jeng, name), name
    assert rollout2d.LANE == pallas2d.LANE
    assert rollout2d.EPS_SETTLED == pallas2d.EPS_SETTLED
    assert teng.NEWTON_ITERS == pallas2d.NEWTON_KERNEL_ITERS


@pytest.mark.parametrize("fingers_3d", [False, True])
def test_fast_sample_y_shape_range_seed(fingers_3d):
    """The on-device batch sampler: JAX's shape, dtype and range, and the
    same values from the same seed. Neither package promises one stream
    for the two: torch's generator is not JAX's PRNG, so no value is
    compared with ``dgdm_tpu.geom.fingers.fast_sample_y``'s."""
    g = tcfg.GRIPPER_3D if fingers_3d else tcfg.GRIPPER_2D
    ref = jfingers.fast_sample_y(jax.random.PRNGKey(0), 64, fingers_3d)

    def draw(seed):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return tfingers.fast_sample_y(gen, 64, fingers_3d, device="cpu")

    y = draw(3)
    assert y.shape == ref.shape == (64, 2, g.num_ctrl)
    assert y.dtype == torch.float32 and str(ref.dtype) == "float32"
    assert y.device.type == "cpu"
    assert float(y.min()) >= g.ctrl_y_min and float(y.max()) <= g.ctrl_y_max
    # spread over the range, not a constant
    assert float(y.max() - y.min()) > 0.9 * (g.ctrl_y_max - g.ctrl_y_min)
    assert torch.equal(draw(3), y)
    assert not torch.equal(draw(4), y)
