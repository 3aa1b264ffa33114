"""Port PointNet++ and the 3D dynamics network vs the JAX package:
farthest-point sampling (with fewer points than samples, where the distances
tie at zero), ball query (with groups padded outside the ball), one set
abstraction, the PointNet++ encoder and ProfileForward3D at width 32 with
weights carried by dgdm_tpu_torch.models.convert, seeded numpy inputs fed to
both, float32. Bars: indices equal, forward outputs <= 1e-5; the flax <->
torch weight maps round-trip exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.models import pointnet2 as jpn
from dgdm_tpu.models.profile3d import ProfileForward3D as JProfile3D
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.models import pointnet2 as tpn
from dgdm_tpu_torch.models.profile3d import ProfileForward3D

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _cloud(seed, b, n):
    return np.random.RandomState(seed).uniform(-1, 1, (b, n, 3)).astype(
        np.float32)


def _randomized(variables, seed):
    """Random-valued copy of a flax tree: parameters perturbed, running
    statistics away from their init values, so every leaf matters."""
    rs = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*np.shape(a))).astype(
            np.float32), variables["params"])
    stats = jax.tree.map(
        lambda a: (np.abs(np.asarray(a) + 0.3 * rs.randn(*np.shape(a)))
                   + 0.5).astype(np.float32), variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("n,npoint", [(300, 64), (100, 128)])
def test_farthest_point_sample(n, npoint):
    """n < npoint: once every point is taken all distances are zero and
    both argmaxes take the first index."""
    xyz = _cloud(1, 3, n)
    ref = np.asarray(jpn.farthest_point_sample(jnp.asarray(xyz), npoint))
    out = tpn.farthest_point_sample(torch.from_numpy(xyz), npoint).numpy()
    np.testing.assert_array_equal(out, ref)
    if n < npoint:
        assert (out[:, n:] == 0).all()
        assert all(len(set(row[:n])) == n for row in out)
    np.testing.assert_allclose(
        tpn.pairwise_sqdist(torch.from_numpy(xyz),
                            torch.from_numpy(xyz[:, :7])).numpy(),
        np.asarray(jpn.pairwise_sqdist(jnp.asarray(xyz),
                                       jnp.asarray(xyz[:, :7]))),
        atol=1e-5)


@pytest.mark.parametrize("radius,nsample", [(0.2, 32), (0.5, 16)])
def test_ball_query(radius, nsample):
    xyz = _cloud(2, 2, 200)
    centers = xyz[:, ::10]
    ref = np.asarray(jpn.ball_query(radius, nsample, jnp.asarray(xyz),
                                    jnp.asarray(centers)))
    out = tpn.ball_query(radius, nsample, torch.from_numpy(xyz),
                         torch.from_numpy(centers)).numpy()
    np.testing.assert_array_equal(out, ref)
    # groups with fewer in-ball points than nsample pad with their first
    counts = (((xyz[:, None] - centers[:, :, None]) ** 2).sum(-1)
              <= radius ** 2).sum(-1)
    short = counts < nsample
    assert short.any()
    b, m = np.argwhere(short)[0]
    c = counts[b, m]
    assert (out[b, m, c:] == out[b, m, 0]).all()


def test_set_abstraction_matches_flax():
    xyz = _cloud(3, 2, 150)
    feats = np.random.RandomState(4).randn(2, 150, 5).astype(np.float32)
    jsa = jpn.SetAbstraction(32, 0.4, 16, (8, 12))
    v = jsa.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats))
    v = _randomized(v, 5)
    ref_xyz, ref = jsa.apply(v, jnp.asarray(xyz), jnp.asarray(feats))
    tsa = tpn.SetAbstraction(32, 0.4, 16, 3 + 5, (8, 12))
    wrapped = {k: {"object_encoder": {"sa1": v[k]}} for k in v}
    prefix = "object_encoder.sa1."
    tsa.load_state_dict({
        k[len(prefix):]: torch.from_numpy(np.asarray(a))
        for k, a in convert.profile3d_state_dict(wrapped).items()})
    out_xyz, out = tsa.eval()(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(out_xyz.numpy(), np.asarray(ref_xyz))
    assert np.abs(np.asarray(ref)).max() > 1e-2
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def profile3d_pair():
    jc = JProfile3D(width=32)
    v = jc.init(jax.random.PRNGKey(0), jnp.zeros((2, 42)), jnp.zeros((2, 1)),
                jnp.zeros((2, 2)), jnp.zeros((2,)), jnp.asarray(_cloud(0, 2, 64)))
    v = _randomized(v, 6)
    tc = ProfileForward3D(width=32)
    tc.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in
                        convert.profile3d_state_dict(v).items()})
    return jc, v, tc.eval()


def test_convert_round_trip_3d(profile3d_pair, tmp_path):
    _, v, tc = profile3d_pair
    back = convert.flax_profile3d(convert.profile3d_state_dict(v))
    jax.tree.map(np.testing.assert_array_equal, back, v)
    path = str(tmp_path / "dyn3d.npz")
    convert.save_npz(path, tc.state_dict(), {"width": 32, "params_ch": 42})
    tc2 = convert.load_model(path, "profile3d")
    assert isinstance(tc2, ProfileForward3D)
    for (k, a), (k2, b) in zip(tc.state_dict().items(),
                               tc2.state_dict().items()):
        assert k == k2 and torch.equal(a, b)


@pytest.mark.parametrize("n_points", [100, 600])
def test_pointnet2_and_profile3d_match_flax(profile3d_pair, n_points):
    """100 points: fewer than SA1's 512 samples (FPS ties at zero)."""
    jc, v, tc = profile3d_pair
    rs = np.random.RandomState(7)
    b = 3
    obj = _cloud(8, b, n_points)
    ins = [rs.uniform(-1, 1, s).astype(np.float32)
           for s in ((b, 42), (b, 1), (b, 2), (b,))]
    ref_f = np.asarray(jc.apply(v, jnp.asarray(obj), method="encode_object"))
    feat = tc.encode_object(torch.from_numpy(obj)).detach().numpy()
    assert feat.shape == (b, 32) and np.abs(ref_f).max() > 1e-2
    np.testing.assert_allclose(feat, ref_f, atol=1e-5, rtol=0)
    ref = np.asarray(jc.apply(v, *ins, obj))
    out = tc(*[torch.from_numpy(a) for a in ins],
             torch.from_numpy(obj)).detach().numpy()
    assert out.shape == (b, 3) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # trunk on one object feature broadcast over the rows (guidance's use)
    ref_t = np.asarray(jc.apply(v, *ins, jnp.asarray(ref_f[:1]),
                                method="trunk"))
    out_t = tc.trunk(*[torch.from_numpy(a) for a in ins],
                     torch.from_numpy(feat[:1])).detach().numpy()
    np.testing.assert_allclose(out_t, ref_t, atol=1e-5, rtol=0)
