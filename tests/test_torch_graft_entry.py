"""The port's flagship entry points (dgdm_tpu_torch/graft_entry.py) against
``__graft_entry__.py``: the guided-denoise step at a small
``_flagship_pieces`` shape (grid 8 x 2 x 2, B = 4, classifier width 32, UNet
(16, 32), 2 pose chunks) from the JAX function's weights
(models/convert.py), on zero inputs as ``entry()`` passes and on random
ones, within 1e-5; ``entry()``'s example arguments at the flagship shape;
``dryrun_multichip(4, device="cpu")`` on 4 gloo ranks prints the JAX
function's summary line."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as jentry
from dgdm_tpu.design.guidance import pose_grid_normalized as j_grid
from dgdm_tpu.diffusion import ddim as jddim
from dgdm_tpu_torch import graft_entry
from dgdm_tpu_torch.models import convert
from tests import torch_parity  # noqa: F401  (one torch thread)

SMALL = dict(grid_size=8, num_pos=2, batch=4, width=32, pose_chunks=2,
             unet_dims=(16, 32))


def _jax_step(sampler, grid_size, num_pos):
    """``__graft_entry__.entry``'s guided_denoise_step on a given grid."""
    sched = jddim.make_schedule(15)
    poses = jnp.asarray(j_grid(grid_size, num_pos))

    def step(unet_params, cls_vars, x, obj_flat):
        b = x.shape[0]
        t = jnp.asarray(12)
        eps = sampler.unet.apply({"params": unet_params}, x,
                                 jnp.full((b,), t))
        w, sq = sampler._objective_weights("rotate_clockwise", None, b)
        obj_feat = sampler._encode_object(cls_vars, obj_flat)
        g = sampler.cond_grad(cls_vars, x, t, obj_feat, w, sq, poses)
        eps = eps - jnp.sqrt(1.0 - sched.alphas_cumprod[t]) * g * 0.001
        return jddim.ddim_step(sched, eps, t, jnp.asarray(9), x)

    return step


@pytest.mark.parametrize("inputs", ["zeros", "random"])
def test_guided_denoise_step_matches_jax(inputs):
    jsampler, uparams, cvars = jentry._flagship_pieces(**SMALL)
    sampler = graft_entry._flagship_pieces(**SMALL, device="cpu")
    sampler.unet.load_state_dict({
        k: torch.from_numpy(np.asarray(v))
        for k, v in convert.unet_state_dict(uparams).items()})
    sampler.classifier.load_state_dict({
        k: torch.from_numpy(np.asarray(v))
        for k, v in convert.profile2d_state_dict(cvars).items()})
    if inputs == "zeros":
        x = np.zeros((4, 14, 1), np.float32)
        obj = np.zeros((200,), np.float32)
    else:
        rs = np.random.RandomState(0)
        x = rs.randn(4, 14, 1).astype(np.float32)
        obj = (0.5 * rs.randn(200)).astype(np.float32)
    ref = np.asarray(_jax_step(jsampler, 8, 2)(
        uparams, cvars, jnp.asarray(x), jnp.asarray(obj)))
    fn = graft_entry.guided_denoise_step(sampler)
    out = fn(torch.from_numpy(x), torch.from_numpy(obj)).numpy()
    assert out.shape == (4, 14, 1) and np.isfinite(out).all()
    assert np.abs(ref - x).max() > 1e-3
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_entry_example_args():
    fn, (x, obj) = graft_entry.entry(device="cpu")
    assert callable(fn)
    assert x.shape == (16, 14, 1) and obj.shape == (200,)
    assert x.device.type == "cpu" and x.dtype == torch.float32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_dryrun_multichip_cpu(capsys):
    out = graft_entry.dryrun_multichip(4, device="cpu", timeout=300)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK on 4 devices (mesh dp=2 "
                           "sp=2): dynamics loss="), line
    assert out["guided_shape"] == (4, 14, 1)
    assert out["dth_shape"] == (4, 4)
    assert np.isfinite([out["dynamics_loss"], out["diffusion_loss"]]).all()
