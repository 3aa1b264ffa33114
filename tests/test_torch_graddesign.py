"""Gradient-based gripper design (dgdm_tpu_torch/design/graddesign.py)
against the JAX package's ``dgdm_tpu/design/graddesign.py`` on the CPU.

Bars: ``scene_with_y`` equals make_scene's coefficients to rtol 1e-5 /
atol 1e-7; the optimiser's updates equal optax's chain
(clip_by_global_norm(1.0), adam) to 1e-6 over 5 steps; in iteration 0 of
``design_gradient_2d`` (smoothed, num_rot 8, num_pairs 4, holdout_draws 2)
the candidates and jitter are equal bit for bit, and the per-candidate mean
objectives and the start's held-out value are within 2e-3 (whitened units)
for both contact solvers. The 200-step rollouts are chaotic: moving every
initial orientation by one ulp moves the per-draw mean objective by up to
9.1e-5 (Newton) and 6.6e-4 (Jacobi) on this setup."""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dgdm_tpu.design import graddesign as JG
from dgdm_tpu.sim import engine2d as J
from dgdm_tpu_torch.design import graddesign as TG
from dgdm_tpu_torch.geom.fingers import sample_gripper_2d
from dgdm_tpu_torch.sim import engine2d as T
from tests import torch_parity  # noqa: F401  (one torch thread a worker)


def _contour(n=100):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rad = 0.035 * (1 + 0.2 * np.sin(3 * ang) + 0.08 * np.cos(5 * ang))
    return np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)


@pytest.fixture(params=["newton", "jacobi"])
def solver(request):
    old = (J.SOLVER, T.SOLVER)
    J.SOLVER = T.SOLVER = request.param
    jax.clear_caches()
    yield request.param
    J.SOLVER, T.SOLVER = old
    jax.clear_caches()


def test_scene_with_y_matches_host_coefs():
    yl, yr = sample_gripper_2d(3)
    scene = T.make_scene(yl, yr, _contour())
    rebuilt = TG.scene_with_y(scene, torch.tensor(yl, dtype=torch.float32),
                              torch.tensor(yr, dtype=torch.float32))
    for a, b in ((rebuilt.coef_l, scene.coef_l),
                 (rebuilt.coef_r, scene.coef_r)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_design_gradient_is_finite_and_nonzero():
    """Backprop through the 200-step contact rollout (each step
    checkpointed) yields a usable signal."""
    yl, yr = sample_gripper_2d(0)
    scene = T.make_scene(yl, yr, _contour())
    y = torch.tensor(np.stack([yl, yr]), dtype=torch.float32,
                     requires_grad=True)
    # full squeeze length: finger contact only begins ~70% in
    val = TG.mean_objective(y, scene, torch.zeros(4, 2), "rotate_clockwise",
                            steps=200, checkpointed=True)
    val.backward()
    assert np.isfinite(float(val.detach()))
    g = y.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0.0


def test_optimiser_matches_optax():
    """The same gradients, fed for 5 steps (norms above and below the clip
    at 1), give optax's updates."""
    rng = np.random.RandomState(0)
    y0 = rng.uniform(-0.04, 0.01, (2, 7)).astype(np.float32)
    grads = [(rng.normal(size=(2, 7)) * s).astype(np.float32)
             for s in (2.0, 0.05, 0.5, 3.0, 0.01)]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    state = opt.init(jnp.asarray(y0))
    port = TG.ClippedAdam(torch.tensor(y0), 1e-3)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        ours = port.step(torch.tensor(g))
        np.testing.assert_allclose(ours.numpy(), np.asarray(upd), rtol=0,
                                   atol=1e-6)


def _record_jax(calls):
    """jax.jit that records each call of the jitted function."""
    real_jit = jax.jit

    def rec_jit(fn, *a, **kw):
        jf = real_jit(fn, *a, **kw)

        def wrapped(*args):
            out = jf(*args)
            calls.append((args, out))
            return out
        return wrapped
    return rec_jit


def test_iteration0_matches_jax(solver):
    yl, yr = sample_gripper_2d(0)
    kw = dict(objective="rotate_clockwise", num_rot=8, steps=200, iters=1,
              num_pairs=4, holdout_draws=2)
    jcalls = []
    with mock.patch.object(JG.jax, "jit", _record_jax(jcalls)):
        jo = JG.design_gradient_2d(yl, yr, _contour(), **kw)
    tcalls = []
    real = TG.mean_objective

    def rec(y, scene, xy, *a, **k):
        out = real(y, scene, xy, *a, **k)
        tcalls.append((y, xy, out))
        return out

    with mock.patch.object(TG, "mean_objective", rec):
        to = TG.design_gradient_2d(yl, yr, _contour(), device="cpu", **kw)
    (jc, _, jxy), jfv = next((a, o) for a, o in jcalls
                             if a[0].shape == (8, 2, 7))
    tc, txy, tfv = tcalls[0]
    # the same candidates and jitter, bit for bit
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
    err = np.abs(tfv.numpy() - np.asarray(jfv))
    print(f"{solver}: per-candidate |diff| max {err.max():.3g}, held-out "
          f"start {jo['holdout'][0]:.6f} vs {to['holdout'][0]:.6f}")
    assert np.isfinite(tfv.numpy()).all() and err.max() < 2e-3
    assert abs(to["holdout"][0] - jo["holdout"][0]) < 2e-3
    assert len(to["history"]) == 1 and len(to["holdout"]) == 2


def test_design_gradient_improves_objective():
    """A short smoothed-ascent run improves the held-out simulated
    objective (port of the JAX package's test of the same name): some
    iterate strictly beats the start on the paired held-out draws, the
    returned design is the held-out argmax, and projection keeps it in the
    generator's control range."""
    yl, yr = sample_gripper_2d(0)
    out = TG.design_gradient_2d(
        yl, yr, _contour(), objective="rotate_clockwise",
        num_rot=8, steps=200, iters=8, lr=1e-3, device="cpu",
    )
    hist = out["history"]
    assert len(hist) == 8 and all(np.isfinite(hist))
    hold = out["holdout"]
    assert len(hold) == 9 and all(np.isfinite(hold))
    assert max(hold[1:]) > hold[0], hold
    assert np.allclose(hold[out["best_iter"] + 1], max(hold))
    g = TG.GRIPPER_2D
    assert out["y"].min() >= g.ctrl_y_min - 1e-6
    assert out["y"].max() <= g.ctrl_y_max + 1e-6
