"""Port guided sampling vs the JAX package on a reduced grid (grid 8,
num_pos 1-2, B = 2): same weights (models/convert.py), same numpy noise and
objects. Bars: cond_grad <= 1e-4 relative; sample / sample_sweep /
sample_multi_object <= 2e-4 (the bar of tests/test_guidance.py);
convergence centers equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.design.guidance import GuidedSampler2D as JSampler
from dgdm_tpu.design.guidance import pose_grid_normalized as j_grid
from dgdm_tpu.models.profile2d import ProfileForward2D as JProfile
from dgdm_tpu.models.unet1d import ConditionalUnet1D as JUnet
from dgdm_tpu_torch.core.config import GUIDANCE
from dgdm_tpu_torch.design.guidance import GuidedSampler2D, pose_grid_normalized
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GRID, NUM_POS, B = 8, 2, 2


@pytest.fixture(scope="module")
def samplers():
    ju = JUnet(down_dims=(16, 32))
    jc = JProfile(width=32, num_trunk=2, object_ch=20)
    key = jax.random.PRNGKey(0)
    uparams = jax.tree.map(np.asarray, ju.init(
        key, jnp.zeros((B, 14, 1)), jnp.zeros((B,), jnp.int32))["params"])
    cv = jc.init(key, jnp.zeros((2, 14)), jnp.zeros((2, 1)), jnp.zeros((2, 2)),
                 jnp.zeros((2,)), jnp.zeros((2, 20)), train=True)
    rs = np.random.RandomState(0)
    # running statistics away from their init values, so they matter
    cvars = {
        "params": jax.tree.map(np.asarray, cv["params"]),
        "batch_stats": {
            k: {"mean": (0.1 * rs.randn(*v["mean"].shape)).astype(np.float32),
                "var": (1.0 + 0.3 * np.abs(rs.randn(*v["var"].shape))
                        ).astype(np.float32)}
            for k, v in cv["batch_stats"].items()},
    }
    js = JSampler(ju, jc, grid_size=GRID, num_pos=NUM_POS, pose_chunks=4)
    tu = ConditionalUnet1D(down_dims=(16, 32))
    tu.load_state_dict({k: torch.from_numpy(v) for k, v in
                        convert.unet_state_dict(uparams).items()})
    tc = ProfileForward2D(width=32, num_trunk=2, object_ch=20)
    tc.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                        convert.profile2d_state_dict(cvars).items()})
    ts = GuidedSampler2D(tu, tc, grid_size=GRID, num_pos=NUM_POS,
                         pose_chunks=4, device="cpu")
    return js, uparams, cvars, ts


def _inputs(seed):
    rs = np.random.RandomState(seed)
    noise = rs.randn(B, 14, 1).astype(np.float32)
    objs = (0.5 * rs.randn(2, 20)).astype(np.float32)
    return noise, objs


def test_pose_grid_equal():
    for g, p in ((360, 5), (8, 2), (12, 1)):
        np.testing.assert_array_equal(pose_grid_normalized(g, p), j_grid(g, p))


@pytest.mark.parametrize("objective", ["rotate", "shift_up", "convergence"])
def test_cond_grad_matches(samplers, objective):
    js, _, cvars, ts = samplers
    noise, objs = _inputs(1)
    x = 0.3 * noise
    centers = np.array([1, 6]) if objective == "convergence" else None
    jw, jsq = js._objective_weights(
        objective, None if centers is None else jnp.asarray(centers), B)
    tw, tsq = ts._objective_weights(
        objective, None if centers is None else torch.from_numpy(centers), B)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jf = js._encode_object(cvars, jnp.asarray(objs[0]))
    poses = pose_grid_normalized(GRID, NUM_POS)
    ref = np.asarray(js.cond_grad(cvars, jnp.asarray(x), jnp.asarray(9), jf,
                                  jw, jsq, jnp.asarray(poses)))
    tf = ts._encode_object(torch.from_numpy(objs[0]))
    out = ts.cond_grad(torch.from_numpy(x), 9, tf, tw, tsq,
                       torch.from_numpy(poses)).numpy()
    assert np.abs(ref).max() > 1e-4
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("objective", ["rotate_clockwise", "shift_left"])
def test_sample_matches(samplers, objective):
    js, uparams, cvars, ts = samplers
    noise, objs = _inputs(2)
    scale = 5.0
    ref = np.asarray(js.sample(uparams, cvars, jnp.asarray(noise),
                               jnp.asarray(objs[0]), objective,
                               jnp.asarray(scale)))
    out = ts.sample(noise, objs[0], objective, scale).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_convergence_sample_and_centers(samplers):
    js, uparams, cvars, ts = samplers
    noise, objs = _inputs(3)
    thr = 0.05
    jc = np.asarray(js.find_convergence_centers(cvars, jnp.asarray(noise),
                                                jnp.asarray(objs[0]), thr))
    tc = ts.find_convergence_centers(noise, objs[0], thr).numpy()
    np.testing.assert_array_equal(tc, jc)
    ref = np.asarray(js.sample(uparams, cvars, jnp.asarray(noise),
                               jnp.asarray(objs[0]), "convergence",
                               jnp.asarray(1.0), centers=jnp.asarray(jc)))
    out = ts.sample(noise, objs[0], "convergence", 1.0,
                    centers=torch.from_numpy(tc)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_sample_sweep_matches(samplers):
    js, uparams, cvars, ts = samplers
    noise, objs = _inputs(4)
    names = ["rotate", "shift_up", "rotate_clockwise", "convergence"]
    jin = js.sweep_inputs(cvars, names, jnp.asarray(objs), fingers_3d=False)
    tin = ts.sweep_inputs(names, objs, fingers_3d=False)
    assert tin[4] == jin[4] and len(tin[4]) == 6
    for a, b in zip(tin[1:4], jin[1:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = np.asarray(js.sample_sweep(uparams, cvars, jnp.asarray(noise),
                                     *jin[:4]))
    out = ts.sample_sweep(noise, *tin[:4]).numpy()
    assert out.shape == (6, B, 14, 1)
    np.testing.assert_allclose(out, ref, atol=2e-4)
    # the fused sweep reproduces the serial per-objective runs of the port
    for i, (name, oi) in enumerate(tin[4][:2]):
        serial = ts.sample(noise, objs[oi], name,
                           GUIDANCE.scale(False, name)).numpy()
        np.testing.assert_allclose(out[i], serial, atol=2e-4)


def test_sample_multi_object_matches(samplers):
    js, uparams, cvars, ts = samplers
    noise, objs = _inputs(5)
    ref = np.asarray(js.sample_multi_object(
        uparams, cvars, jnp.asarray(noise), jnp.asarray(objs), "shift_up",
        jnp.asarray(1.0)))
    out = ts.sample_multi_object(noise, objs, "shift_up", 1.0).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4)
