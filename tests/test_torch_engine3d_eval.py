"""The port's pure 3D engine against the JAX package's on the CPU, beside
tests/test_torch_engine3d_rollout.py (its scenes, poses and bars, which its
docstring states): ``engine3d.profile_batch`` over 800 steps under the
Jacobi solver, ``simeval3d.eval_rollout_batch_3d`` on the verification
schedule cut to 900 steps (regrasp and snapshot at 800), and
``rollout_trace3d``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.eval import simeval3d as jsimeval3d
from dgdm_tpu.sim import engine3d as J
from dgdm_tpu_torch.eval import simeval3d as tsimeval3d
from dgdm_tpu_torch.sim import engine3d as T
from tests.test_torch_engine3d import N_POSES
from tests.test_torch_engine3d_rollout import (  # noqa: F401 (fixtures)
    check_profile_batch,
    pairs,
    solver3,
)


@pytest.mark.parametrize("solver", ["jacobi"])
def test_profile_batch_matches_jax(pairs, solver, solver3):  # noqa: F811
    check_profile_batch(pairs, solver, solver3)


def test_eval_rollout_batch_3d_matches_jax(pairs):  # noqa: F811
    """The verification schedule cut to 900 steps (regrasp every 800, the
    first-squeeze snapshot at 800), gripper 2 x 8 orientations at the
    origin."""
    jst, tst, _ = pairs
    jst = jax.tree.map(lambda x: x[:1], jst)
    tst = type(tst)(**{k: (None if v is None else v[:1])
                       for k, v in vars(tst).items()})
    thetas = np.linspace(0, 2 * np.pi, N_POSES,
                         endpoint=False).astype(np.float32)
    kw = dict(first_squeeze=800, total_steps=900, regrasp_every=800)
    jd, jp, jf, jfp = (np.asarray(a) for a in jsimeval3d.eval_rollout_batch_3d(
        jst, jnp.asarray(thetas), **kw))
    td, tp, tf, tfp = (a.numpy() for a in tsimeval3d.eval_rollout_batch_3d(
        tst, torch.from_numpy(thetas), **kw))
    assert td.shape == (1, N_POSES) and tfp.shape == (1, N_POSES, 2)
    assert np.abs(jd).max() > 1e-2
    assert np.abs(td - jd).max() <= 2e-2
    assert float(np.median(np.abs(tp - jp))) <= 1e-3
    assert np.abs((tf - jf + np.pi) % (2 * np.pi) - np.pi).max() <= 2e-2
    assert float(np.median(np.abs(tfp - jfp))) <= 1e-3


def test_rollout_trace3d_matches_jax(pairs):  # noqa: F811
    jst, tst, _ = pairs
    jsc = jax.tree.map(lambda x: x[0], jst)
    tsc = type(tst)(**{k: (None if v is None else v[0])
                       for k, v in vars(tst).items()})
    pose = np.asarray([0.01, -0.01, 2.0], np.float32)
    jt = np.asarray(J.rollout_trace3d(jsc, jnp.asarray(pose), steps=800,
                                      every=40))
    tt = T.rollout_trace3d(tsc, torch.from_numpy(pose), steps=800,
                           every=40).numpy()
    assert tt.shape == jt.shape == (20, 9)
    # the drop, before the jaws reach the object
    np.testing.assert_allclose(tt[:8], jt[:8], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=2e-3)
