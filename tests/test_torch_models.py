"""Port networks and DDIM vs the JAX package: weights carried across with
dgdm_tpu_torch.models.convert, seeded numpy inputs fed to both, float32
(TF32 off). Bars: forward outputs <= 1e-5, DDIM functions <= 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.diffusion import ddim as jddim
from dgdm_tpu.models import embeddings as jemb
from dgdm_tpu.models.profile2d import ProfileForward2D as JProfile
from dgdm_tpu.models.unet1d import ConditionalUnet1D as JUnet
from dgdm_tpu_torch.diffusion import ddim as tddim
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.models import embeddings as temb
from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(tree, seed):
    """Random-valued copy of a flax tree (GroupNorm/BatchNorm scales away
    from 1, biases and running stats away from 0) so every leaf matters."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*np.shape(a))).astype(
            np.float32), tree)


@pytest.fixture(scope="module")
def unet_pair():
    ju = JUnet(down_dims=(16, 32))
    params = ju.init(jax.random.PRNGKey(0), jnp.zeros((2, 14, 1)),
                     jnp.zeros((2,), jnp.int32))["params"]
    params = _perturbed(_np_tree(params), 1)
    tu = ConditionalUnet1D(down_dims=(16, 32))
    tu.load_state_dict({k: torch.from_numpy(v) for k, v in
                        convert.unet_state_dict(params).items()})
    return ju, params, tu.eval()


@pytest.fixture(scope="module")
def profile_pair():
    jc = JProfile(width=32, num_trunk=2, object_ch=20)
    v = jc.init(jax.random.PRNGKey(0), jnp.zeros((2, 14)), jnp.zeros((2, 1)),
                jnp.zeros((2, 2)), jnp.zeros((2,)), jnp.zeros((2, 20)),
                train=True)
    v = {"params": _perturbed(_np_tree(v["params"]), 2),
         "batch_stats": _np_tree(v["batch_stats"])}
    rs = np.random.RandomState(3)
    v["batch_stats"] = jax.tree.map(
        lambda a: (np.abs(a + rs.randn(*a.shape)) + 0.5).astype(np.float32),
        v["batch_stats"])
    tc = ProfileForward2D(width=32, num_trunk=2, object_ch=20)
    tc.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in
                        convert.profile2d_state_dict(v).items()})
    return jc, v, tc.eval()


def test_convert_round_trip(unet_pair, profile_pair, tmp_path):
    _, params, tu = unet_pair
    back = convert.flax_unet(convert.unet_state_dict(params))
    jax.tree.map(np.testing.assert_array_equal, back, params)
    _, v, tc = profile_pair
    back = convert.flax_profile2d(convert.profile2d_state_dict(v))
    jax.tree.map(np.testing.assert_array_equal, back, v)
    # npz: state_dict + constructor arguments rebuild the same module
    path = str(tmp_path / "unet.npz")
    convert.save_npz(path, tu.state_dict(), {"down_dims": [16, 32]})
    tu2 = convert.load_model(path, "unet")
    for (k, a), (k2, b) in zip(tu.state_dict().items(),
                               tu2.state_dict().items()):
        assert k == k2 and torch.equal(a, b)


def test_upsample_impulse_alignment():
    """flax ConvTranspose((4,), 2, 'SAME') == torch ConvTranspose1d(4, 2, 1)
    with the converter's flipped kernel, checked on unit impulses."""
    import flax.linen as nn

    rs = np.random.RandomState(4)
    kernel = rs.randn(4, 3, 2).astype(np.float32)
    m = nn.ConvTranspose(2, (4,), strides=(2,), padding="SAME")
    tconv = torch.nn.ConvTranspose1d(3, 2, 4, stride=2, padding=1)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(np.flip(kernel, 0).transpose(1, 2, 0))))
        tconv.bias.zero_()
    for pos in (0, 3, 6):
        x = np.zeros((1, 7, 3), np.float32)
        x[0, pos, 1] = 1.0
        ref = np.asarray(m.apply({"params": {"kernel": kernel,
                                             "bias": np.zeros(2, np.float32)}},
                                 x))
        out = tconv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)


def test_unet_forward_matches_flax(unet_pair):
    ju, params, tu = unet_pair
    rs = np.random.RandomState(5)
    x = rs.randn(3, 14, 1).astype(np.float32)
    t = np.array([0, 7, 12], np.int32)
    ref = np.asarray(ju.apply({"params": params}, x, t))
    out = tu(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy()
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_profile2d_forward_matches_flax(profile_pair):
    jc, v, tc = profile_pair
    rs = np.random.RandomState(6)
    b = 5
    ins = [rs.uniform(-1, 1, s).astype(np.float32)
           for s in ((b, 14), (b, 1), (b, 2), (b,), (b, 20))]
    ref = np.asarray(jc.apply(v, *ins, train=False))
    out = tc(*[torch.from_numpy(a) for a in ins]).detach().numpy()
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # encode_object / trunk split used by guidance
    feat = tc.encode_object(torch.from_numpy(ins[4]))
    ref_f = np.asarray(jc.apply(v, ins[4], method="encode_object"))
    np.testing.assert_allclose(feat.detach().numpy(), ref_f, atol=1e-5)


@pytest.mark.parametrize("fn", ["timestep_embedding", "sinusoidal_pos_emb",
                                "nerf_embed", "mish"])
def test_embeddings_match(fn):
    rs = np.random.RandomState(7)
    if fn == "nerf_embed":
        x = rs.uniform(-1, 1, (4, 2)).astype(np.float32)
        args = ()
    elif fn == "mish":
        x = rs.randn(64).astype(np.float32) * 5
        args = ()
    else:
        x = rs.uniform(0, 15, (6,)).astype(np.float32)
        args = (32,)
    ref = np.asarray(getattr(jemb, fn)(jnp.asarray(x), *args))
    out = getattr(temb, fn)(torch.from_numpy(x), *args).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_ddim_functions_match():
    js, ts = jddim.make_schedule(15), tddim.make_schedule(15)
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(),
                               np.asarray(js.alphas_cumprod), atol=1e-6)
    np.testing.assert_array_equal(tddim.inference_timesteps(15, 5),
                                  jddim.inference_timesteps(15, 5))
    np.testing.assert_array_equal(tddim.prev_timesteps(15, 5),
                                  jddim.prev_timesteps(15, 5))
    rs = np.random.RandomState(8)
    x = rs.randn(4, 14, 1).astype(np.float32)
    eps = rs.randn(4, 14, 1).astype(np.float32)
    for t, pt in zip(jddim.inference_timesteps(15, 5),
                     jddim.prev_timesteps(15, 5)):
        ref = np.asarray(jddim.ddim_step(js, jnp.asarray(eps), int(t),
                                         int(pt), jnp.asarray(x)))
        out = tddim.ddim_step(ts, torch.from_numpy(eps), int(t), int(pt),
                              torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)
    tt = np.array([0, 5, 14, 3])
    ref = np.asarray(jddim.add_noise(js, jnp.asarray(x), jnp.asarray(eps),
                                     jnp.asarray(tt)))
    out = tddim.add_noise(ts, torch.from_numpy(x), torch.from_numpy(eps),
                          torch.from_numpy(tt)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
