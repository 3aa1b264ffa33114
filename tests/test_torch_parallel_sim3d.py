"""The port's 3D data-parallel simulation routes (sim/datagen3d.py,
eval/simeval3d.py) on 4 gloo ranks on the CPU against the same calls in one
process: ``profile_pairs_3d`` on the kernel's route (its plain version
here) and the pure engine's, and ``sim_eval_batch_3d``, 4 grippers x
mug_small split one a rank. A pair's rollouts do not depend on the other
pairs, so every output and metric must be bitwise equal. The rollouts run
one 800-step squeeze, the first point at which the jaws have gripped (the
reference must have moved: max |dtheta| > 1e-2)."""

import numpy as np

from dgdm_tpu_torch.parallel import launch
from tests import torch_dist_ranks
from tests import torch_parity  # noqa: F401  (one torch thread)
from tests.test_torch_parallel_sim import _assert_bitwise


def test_profile_pairs_and_sim_eval_3d_split_over_dp():
    ranks = launch.start(4, "tests.torch_dist_ranks:sims_3d", backend="gloo",
                         timeout=600)
    ref = torch_dist_ranks.sims_3d()
    outs = ranks.wait()
    for k in ("kernel", "engine"):
        assert np.abs(ref[k][0]).max() > 1e-2, k
    assert max(np.abs(m["delta_theta"]).max() for m in ref["eval"]) > 1.0
    for r, out in enumerate(outs):
        _assert_bitwise(out, ref, f"rank {r}")
