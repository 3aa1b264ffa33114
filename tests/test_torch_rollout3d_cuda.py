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
