"""The port's 2D data-parallel simulation routes (dgdm_tpu_torch/parallel/,
sim/datagen.py, eval/simeval.py) on 4 gloo ranks on the CPU against the
same calls in one process: ``profile_pairs_2d`` on the kernel's route (its
plain version here, through ``block=False`` and ``fetch_pairs_2d``, where
the gather happens) and the pure engine's, and ``sim_eval_batch_2d``, 4
pairs split one a rank. A pair's rollouts do not depend on the other
pairs, so every output and metric must be bitwise equal; the reference
must have moved (max |dtheta| > 1e-2), so the rollouts run the 200-step
squeeze (the verification 400 steps, a regrasp at 200)."""

import numpy as np

from dgdm_tpu_torch.parallel import launch
from tests import torch_dist_ranks
from tests import torch_parity  # noqa: F401  (one torch thread)


def _assert_bitwise(got, ref, what):
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            _assert_bitwise(got[k], ref[k], f"{what}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_bitwise(g, r, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=what)


def test_profile_pairs_and_sim_eval_2d_split_over_dp():
    ranks = launch.start(4, "tests.torch_dist_ranks:sims_2d", backend="gloo",
                         timeout=300)
    ref = torch_dist_ranks.sims_2d()
    outs = ranks.wait()
    for k in ("kernel", "engine"):
        assert np.abs(ref[k]["delta_theta"]).max() > 1e-2, k
    assert max(np.abs(m["delta_theta"]).max() for m in ref["eval"]) > 1.0
    for r, out in enumerate(outs):
        _assert_bitwise(out, ref, f"rank {r}")
