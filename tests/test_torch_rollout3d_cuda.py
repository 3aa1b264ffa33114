"""The CUDA rollout kernel (K2, csrc/rollout3d.cu) on the card, held to its
plain PyTorch version and to the golden outputs of the TPU kernel.

Imports no JAX, so it runs on a GPU host without it; the repository's
tests/conftest.py does import JAX, so there run it without the conftest:

    python -m pytest --noconftest tests/test_torch_rollout3d_cuda.py -q

Without a CUDA device every test here skips."""

import pytest
import torch

from dgdm_tpu_torch.sim import rollout3d
from dgdm_tpu_torch.sim.rollout3d_ref import profile_batch_ref
# a sibling module, imported by its own name: pytest puts tests/ on the path
# (no package), and another installed ``tests`` package may shadow this one
from torch_parity import NAMES3, assert_k2_parity, golden3d


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_cuda_kernel_matches_plain_and_golden(schedule):
    _need_cuda()
    z, arrs, poses = golden3d()
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    before = rollout3d.KERNEL_LAUNCHES["rollout3d"]
    out = rollout3d.rollout(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap)
    torch.cuda.synchronize()
    assert rollout3d.KERNEL_LAUNCHES["rollout3d"] == before + 1
    ref = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap)
    out = {k: v.cpu().numpy() for k, v in zip(NAMES3, out)}
    p = poses.cpu().numpy()
    assert_k2_parity(out, {k: v.cpu().numpy() for k, v in zip(NAMES3, ref)},
                     p)
    assert_k2_parity(out, {k: z[f"{schedule}_{k}"] for k in NAMES3}, p)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_cuda_kernel_matches_plain_bitwise(schedule):
    """Bitwise equal, on all 12 output planes, to the plain version adding
    its point sums in the order of the kernel's layout."""
    _need_cuda()
    g = rollout3d.THREADS_PER_ROLLOUT
    z, arrs, poses = golden3d()
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    out = rollout3d.rollout_cuda(*arrs, poses, steps, rg, snap)
    torch.cuda.synchronize()
    plan = rollout3d.LAST_PLAN
    assert plan["threads_per_rollout"] == g
    assert plan["cluster"] * plan["threads"] == 128 * g
    assert plan["max_active_clusters"] > 0
    ref = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, sum_group=g)
    for k, a, b in zip(NAMES3, out, ref):
        assert torch.equal(a, b), f"{k} differs from the plain version"


@pytest.mark.cuda
def test_cuda_launcher_refuses_more_points_than_fit():
    """256 contact points on 32 threads a rollout: 8 points a lane, 192 KB a block
    of held geometry. A point count whose geometry does not fit a block's
    shared memory is refused, not launched."""
    _need_cuda()
    _, arrs, poses = golden3d()
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    before = rollout3d.KERNEL_LAUNCHES["rollout3d"]
    big = arrs[1].repeat(1, 2, 1)
    with pytest.raises(RuntimeError, match="point count"):
        rollout3d.rollout_cuda(arrs[0], big, arrs[2], poses, 200, 0, 0)
    assert rollout3d.KERNEL_LAUNCHES["rollout3d"] == before


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_inputs():
    _need_cuda()
    _, arrs, poses = golden3d()
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    with pytest.raises(ValueError):
        rollout3d.rollout(*arrs, poses[:100])
    with pytest.raises(ValueError):
        rollout3d.rollout(*arrs, poses.cpu())
    with pytest.raises(TypeError):
        rollout3d.rollout(*arrs, poses.double())
