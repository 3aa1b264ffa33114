"""The port's 2D trace (``engine2d.rollout_trace``) with re-grasps against the
JAX package's, on the CPU: gripper 0 x icon 3 (tests/util_icons.py), 16
jittered orientations, 400 steps, a regrasp at 200, rows every 10 and every
30 (an interval that does not divide the depth).

Bars, per trace column over every row and lane: theta within 1e-4 rad;
x, y and the finger slides ql, qr within 1e-5 m; first the reference must
have turned (max |theta - theta0| > 1e-2, the non-zero guard of parity bar
(a)). They come from ``JAX_PLATFORMS=cpu python
scripts/probe_trace_chaos.py --cases 2d_poses``: a 1-ulp change of every
initial orientation moves JAX's own trace by up to 2.62e-5 rad and 8.6e-7
m over these 400 steps (the port's by 1.24e-5 rad and 6.5e-7 m); the port
lies 2.38e-6 rad and 3.1e-7 m from JAX's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.geom.contour import extract_contours
from dgdm_tpu.geom.fingers import sample_gripper_2d
from dgdm_tpu.sim import engine2d as J
from dgdm_tpu_torch.sim import engine2d as T
from tests import torch_parity  # noqa: F401  (one torch thread)
from tests.util_icons import make_icon

THETA_BAR, POS_BAR = 1e-4, 1e-5


def _poses(n=16, seed=0, jitter=0.01):
    rng = np.random.RandomState(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([rng.uniform(-jitter, jitter, n),
                     rng.uniform(-jitter, jitter, n), th],
                    -1).astype(np.float32)


@pytest.mark.parametrize("every", [10, 30])
def test_rollout_trace_with_regrasp_matches_jax(every):
    contour = extract_contours(make_icon(3))
    yl, yr = sample_gripper_2d(0)
    poses = _poses()
    kw = dict(steps=400, every=every, regrasp_every=200)
    jsc = J.make_scene(yl, yr, contour)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda p: J.rollout_trace(jsc, p, **kw)))(jnp.asarray(poses)))
    out = T.rollout_trace(T.make_scene(yl, yr, contour),
                          torch.from_numpy(poses), **kw).numpy()
    rows = -(-400 // every)
    assert out.shape == ref.shape == (16, rows, 5)
    assert np.isfinite(out).all()
    assert np.abs(ref[..., 2] - poses[:, None, 2]).max() > 1e-2
    err = np.abs(out - ref).reshape(-1, 5).max(0)
    print(f"every {every}: max |port - JAX| x, y, theta, ql, qr: {err}")
    assert err[2] <= THETA_BAR, err
    assert max(err[0], err[1], err[3], err[4]) <= POS_BAR, err
