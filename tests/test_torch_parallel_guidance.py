"""The port's pose-grid sharding of guided sampling (design/guidance.py
with a ``parallel/mesh.make_mesh`` mesh) on 4 gloo ranks on the CPU, a
dp 2 x sp 2 mesh, from the weights of tests/test_torch_guidance.py (grid 8,
num_pos 2, B = 2):

- the mesh: rank i * sp + j at dp coordinate i and sp coordinate j, its
  groups holding the ranks that share the other coordinate; ``replicate``
  leaves rank 0's parameters and buffers on every rank;
- ``sample`` (shift_up; convergence, whose objective weights are per pose),
  ``sample_sweep`` and ``sample_multi_object``: every rank returns the same
  samples, within 2e-6 of the port in one process (the bar of
  tests/test_multichip.py's mesh sampler) and within 2e-4 of the JAX
  package's sampler on its (dp, sp) mesh over the conftest's 8 CPU devices
  with the same weights (the bar of tests/test_guidance.py).
"""

import numpy as np
import jax.numpy as jnp

from dgdm_tpu.design.guidance import GuidedSampler2D as JSampler
from dgdm_tpu.parallel import mesh as jmesh
from dgdm_tpu_torch.parallel import launch
from tests import torch_dist_ranks
from tests import torch_parity  # noqa: F401  (one torch thread)
from tests.test_torch_guidance import GRID, NUM_POS, _inputs
from tests.test_torch_guidance import samplers  # noqa: F401  (fixture)


def test_guided_sampler_sp_sharded(samplers, tmp_path):  # noqa: F811
    js, uparams, cvars, ts = samplers
    noise, objs = _inputs(4)
    centers = np.array([1, 6])
    spec = {f"u/{k}": v.numpy() for k, v in ts.unet.state_dict().items()}
    spec.update({f"c/{k}": v.numpy()
                 for k, v in ts.classifier.state_dict().items()})
    spec.update(grid=GRID, num_pos=NUM_POS, noise=noise, objs=objs,
                centers=centers)
    path = str(tmp_path / "spec.npz")
    np.savez(path, **spec)
    ranks = launch.start(4, "tests.torch_dist_ranks:guided_sampler",
                         {"spec": path}, backend="gloo", timeout=300)
    one = torch_dist_ranks.run_sampler(ts, spec)
    # the JAX package's sampler on its (dp, sp) mesh of 8 CPU devices
    mesh = jmesh.make_mesh(axes=("dp", "sp"))
    jm = JSampler(js.unet, js.classifier, grid_size=GRID, num_pos=NUM_POS,
                  mesh=mesh)
    jn, jo = jnp.asarray(noise), jnp.asarray(objs)
    feats, w, rsq, scales, _ = jm.sweep_inputs(
        cvars, ["rotate", "shift_left"], jo, False)
    ref = {
        "shift_up": jm.sample(uparams, cvars, jn, jo[0], "shift_up",
                              jnp.asarray(5.0)),
        "convergence": jm.sample(uparams, cvars, jn, jo[0], "convergence",
                                 jnp.asarray(1.0),
                                 centers=jnp.asarray(centers)),
        "multi": jm.sample_multi_object(uparams, cvars, jn, jo,
                                        "rotate_clockwise", jnp.asarray(5.0)),
        "sweep": jm.sample_sweep(uparams, cvars, jn, feats, w, rsq, scales),
    }
    outs = ranks.wait()
    for r, out in enumerate(outs):
        lay = out["layout"]
        i, j = divmod(r, 2)
        assert lay["shape"] == {"dp": 2, "sp": 2}
        assert lay["coords"] == {"dp": i, "sp": j}, (r, lay)
        assert lay["members"] == {"dp": [j, 2 + j], "sp": [2 * i, 2 * i + 1]}
        for k, v in lay["replicated"].items():      # rank 0's, everywhere
            np.testing.assert_array_equal(
                v, outs[0]["layout"]["replicated"][k], err_msg=k)
        for k in ("shift_up", "convergence", "multi", "sweep"):
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)
            assert np.abs(one[k] - noise).max() > 1e-3, k
            np.testing.assert_allclose(out[k], one[k], rtol=0, atol=2e-6,
                                       err_msg=k)
            np.testing.assert_allclose(out[k], np.asarray(ref[k]), rtol=0,
                                       atol=2e-4, err_msg=k)
    assert one["sweep"].shape == (4, 2, 14, 1)
