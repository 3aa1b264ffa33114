"""The CUDA rollout kernel (K1, csrc/rollout2d.cu) on the card, both
instantiations (Newton, Jacobi), held to its plain PyTorch version (all 9
output planes, the contact count of plane 8 included) and to the golden
outputs of the TPU kernel (their 8 planes).

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
from torch_parity import GOLDEN_JACOBI, NAMES, assert_k1_parity, golden

# the kernel's output planes: the golden files' 8, then the contact count
PLANES = NAMES + ("ccontact",)


def _assert_bitwise(out, ref):
    assert len(out) == len(ref) == len(PLANES)
    for k, a, b in zip(PLANES, out, ref):
        assert torch.equal(a, b), f"{k} differs from the plain version"


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
@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_cuda_kernel_matches_plain_bitwise(schedule):
    """Bitwise equal, on all 9 output planes, to the plain version adding
    its point sums in the order of the kernel's layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    g = rollout2d.THREADS_PER_ROLLOUT
    z, arrs, poses = golden()
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    out = rollout2d.rollout_cuda(*arrs, poses, steps, rg, snap)
    torch.cuda.synchronize()
    plan = rollout2d.LAST_PLAN
    assert plan["threads_per_rollout"] == g
    assert plan["cluster"] * plan["threads"] == 128 * g
    assert plan["max_active_clusters"] > 0
    ref = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, sum_group=g)
    _assert_bitwise(out, ref)


@pytest.mark.cuda
def test_cuda_launcher_refuses_more_points_than_fit():
    """100 contour points on 16 threads a rollout: 7 points a lane, 63 KB a block
    of held geometry. A point count whose geometry does not fit a block's
    shared memory is refused, not launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    _, arrs, poses = golden()
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    before = rollout2d.KERNEL_LAUNCHES["rollout2d"]
    big = arrs[1].repeat(1, 5, 1)
    with pytest.raises(RuntimeError, match="point count"):
        rollout2d.rollout_cuda(arrs[0], big, *arrs[2:], poses, 200, 0, 0)
    assert rollout2d.KERNEL_LAUNCHES["rollout2d"] == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_cuda_jacobi_matches_plain_bitwise_and_golden(schedule):
    """The Jacobi instantiation: bitwise equal, on all 9 output planes, to
    the plain version in the kernel's summation order, and within the bars
    of the Jacobi golden fixture; every normal step is a full solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    g = rollout2d.THREADS_PER_ROLLOUT
    z, arrs, poses = golden(GOLDEN_JACOBI)
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    before = rollout2d.KERNEL_LAUNCHES["rollout2d_jacobi"]
    out = rollout2d.rollout(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, solver="jacobi")
    torch.cuda.synchronize()
    assert rollout2d.KERNEL_LAUNCHES["rollout2d_jacobi"] == before + 1
    ref = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, sum_group=g, solver="jacobi")
    _assert_bitwise(out, ref)
    out = {k: v.cpu().numpy() for k, v in zip(NAMES, out)}
    assert (out["ccheap"] == 0).all()
    assert_k1_parity(out, {k: z[f"{schedule}_{k}"] for k in NAMES})


@pytest.mark.cuda
def test_cuda_jacobi_refuses_more_points_than_fit():
    """Jacobi holds 12 floats a contour point and 3 a support point: 300
    contour points (19 a lane) do not fit a block's shared memory, where
    the Newton slab (9 floats a point) does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    _, arrs, poses = golden(GOLDEN_JACOBI)
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    big = arrs[1].repeat(1, 3, 1)
    before = rollout2d.KERNEL_LAUNCHES["rollout2d_jacobi"]
    with pytest.raises(RuntimeError, match="point count"):
        rollout2d.rollout_cuda(arrs[0], big, *arrs[2:], poses, 200, 0, 0,
                               "jacobi")
    assert rollout2d.KERNEL_LAUNCHES["rollout2d_jacobi"] == before
    newton = rollout2d.KERNEL_LAUNCHES["rollout2d"]
    rollout2d.rollout_cuda(arrs[0], big, *arrs[2:], poses, 10, 0, 0,
                           "newton")
    torch.cuda.synchronize()
    assert rollout2d.KERNEL_LAUNCHES["rollout2d"] == newton + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 7])
@pytest.mark.parametrize("p", [100, 272, 17])
def test_cuda_jacobi_matches_plain_bitwise_at_point_counts(p, s):
    """The Jacobi instantiation at the package's 100 contour points (7 a
    lane, all with their impulses in registers), at 272 (17 a lane: 8 in
    registers, 9 in the shared-memory slab; the most the launcher accepts
    at 64 supports) and at fewer points than lanes (17), with 64 supports
    (4 a lane, all in registers) and 7 (fewer than lanes): bitwise equal to
    the plain version in the kernel's order on all 9 planes over the
    Jacobi golden fixture's datagen schedule (200 steps), its pairs and
    poses with the contour repeated to P points and the first S supports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    z, arrs, poses = golden(GOLDEN_JACOBI)
    steps, rg, snap = (int(v) for v in z["datagen_schedule"])
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    contour = arrs[1].repeat(1, 3, 1)[:, :p].contiguous()
    support = arrs[2][:, :s].contiguous()
    arrs = [arrs[0], contour, support, arrs[3]]
    out = rollout2d.rollout_cuda(*arrs, poses, steps, rg, snap, "jacobi")
    torch.cuda.synchronize()
    ref = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, solver="jacobi",
                            sum_group=rollout2d.THREADS_PER_ROLLOUT)
    assert float(out[6].amax()) > 0.0
    _assert_bitwise(out, ref)


@pytest.mark.cuda
def test_cuda_jacobi_launcher_accepts_272_points_at_64_supports():
    """The largest Jacobi count the launcher takes at 64 supports: 272
    contour points (17 a lane) fit a block's shared memory, 288 do not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    _, arrs, poses = golden(GOLDEN_JACOBI)
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    assert arrs[2].shape[1] == 64
    before = rollout2d.KERNEL_LAUNCHES["rollout2d_jacobi"]
    big = arrs[1].repeat(1, 3, 1)
    rollout2d.rollout_cuda(arrs[0], big[:, :272].contiguous(), *arrs[2:],
                           poses, 10, 0, 0, "jacobi")
    torch.cuda.synchronize()
    assert rollout2d.KERNEL_LAUNCHES["rollout2d_jacobi"] == before + 1
    assert rollout2d.LAST_PLAN["shared_bytes"] <= 232448
    with pytest.raises(RuntimeError, match="point count"):
        rollout2d.rollout_cuda(arrs[0], big[:, :288].contiguous(),
                               *arrs[2:], poses, 10, 0, 0, "jacobi")
    assert rollout2d.KERNEL_LAUNCHES["rollout2d_jacobi"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("p", [100, 272, 384, 17])
def test_cuda_newton_matches_plain_bitwise_at_point_counts(p):
    """The Newton instantiation, whose full solve keeps only a lane's
    points in contact, at the package's 100 contour points (7 a lane), at
    272 and 384 (17 and 24 a lane; 384 is the most its slab takes) and at
    fewer points than lanes (17): bitwise equal to the plain version in the
    kernel's order on all 9 planes over the golden fixture's datagen
    schedule (200 steps), its pairs and poses with the contour repeated to
    P points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    z, arrs, poses = golden()
    steps, rg, snap = (int(v) for v in z["datagen_schedule"])
    arrs, poses = [a.cuda() for a in arrs], poses.cuda()
    contour = arrs[1].repeat(1, 4, 1)[:, :p].contiguous()
    arrs = [arrs[0], contour, *arrs[2:]]
    out = rollout2d.rollout_cuda(*arrs, poses, steps, rg, snap, "newton")
    torch.cuda.synchronize()
    ref = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, solver="newton",
                            sum_group=rollout2d.THREADS_PER_ROLLOUT)
    assert float(out[8].amax()) > 0.0
    _assert_bitwise(out, ref)


def _contact_case(case):
    """The golden fixture's pairs, their contour moved so that every point
    is in contact when the jaws first reach it ("all": each point pushed
    0.2 m away from the center along y, beyond both jaw surfaces at rest)
    or none ever is ("none": shrunk to 5% about the center of mass), and
    128 poses at theta 0 spread over 2 cm in x (CUDA tensors)."""
    _, arrs, _ = golden()
    arrs = [a.cuda() for a in arrs]
    contour, scal = arrs[1].clone(), arrs[3]
    com = scal[:, 0, 3:5][:, None, :]
    if case == "all":
        y = contour[..., 1]
        contour[..., 1] = torch.where(y >= com[..., 1], y + 0.2, y - 0.2)
    else:
        contour = com + 0.05 * (contour - com)
    poses = torch.zeros(128, 3, device="cuda")
    poses[:, 0] = torch.linspace(-0.01, 0.01, 128, device="cuda")
    return [arrs[0], contour.contiguous(), *arrs[2:]], poses


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["newton", "jacobi"])
@pytest.mark.parametrize("case", ["all", "none"])
def test_cuda_kernel_matches_plain_bitwise_in_and_out_of_contact(case,
                                                                  solver):
    """Every point of every rollout in contact (Newton: in each full
    solve, so a warp's compacted loop runs its full count), and no point
    ever in contact (the compacted loop runs no pass and every contour sum
    is +0.0): bitwise equal to the plain version on all 9 planes, 200
    steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the rollout kernel runs on the card")
    arrs, poses = _contact_case(case)
    p = arrs[1].shape[1]
    out = rollout2d.rollout_cuda(*arrs, poses, 200, 0, 0, solver)
    torch.cuda.synchronize()
    ref = profile_batch_ref(*arrs, poses, steps=200, solver=solver,
                            sum_group=rollout2d.THREADS_PER_ROLLOUT)
    _assert_bitwise(out, ref)
    assert float(out[6].amin()) >= 1.0
    if case == "none":
        assert float(out[8].amax()) == 0.0
    elif solver == "newton":
        assert bool((out[8] == p * out[6]).all())
    else:
        assert float(out[8].amin()) > 0.0
