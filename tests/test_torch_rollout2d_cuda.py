"""The CUDA rollout kernel (K1, csrc/rollout2d.cu) on the card, held to its
plain PyTorch version and to the golden outputs of the TPU kernel.

Imports no JAX, so it runs on a GPU host without it; the repository's
tests/conftest.py does import JAX, so there run it without the conftest:

    python -m pytest --noconftest tests/test_torch_rollout2d_cuda.py -q

Without a CUDA device every test here skips."""

import pytest
import torch

from dgdm_tpu_torch.sim import rollout2d
from dgdm_tpu_torch.sim.rollout2d_ref import profile_batch_ref
# a sibling module, imported by its own name: pytest puts tests/ on the path
# (no package), and another installed ``tests`` package may shadow this one
from torch_parity import NAMES, assert_k1_parity, golden


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_cuda_kernel_matches_plain_and_golden(schedule):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    z, arrs, poses = golden()
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    before = rollout2d.KERNEL_LAUNCHES["rollout2d"]
    out = rollout2d.rollout(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap)
    torch.cuda.synchronize()
    assert rollout2d.KERNEL_LAUNCHES["rollout2d"] == before + 1
    ref = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap)
    out = {k: v.cpu().numpy() for k, v in zip(NAMES, out)}
    assert_k1_parity(out, {k: v.cpu().numpy() for k, v in zip(NAMES, ref)})
    assert_k1_parity(out, {k: z[f"{schedule}_{k}"] for k in NAMES})


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    _, arrs, poses = golden()
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    with pytest.raises(ValueError):
        rollout2d.rollout(*arrs, poses[:100])
    with pytest.raises(ValueError):
        rollout2d.rollout(*arrs, poses.cpu())
