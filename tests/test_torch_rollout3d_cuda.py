"""The CUDA rollout kernel (K2, csrc/rollout3d.cu) on the card, held to its
plain PyTorch version and to the golden outputs of the TPU kernel: the
Newton instantiation, the adaptive-Newton one (``newton_tol``) and the
Jacobi one, each with its golden fixture.

Imports no JAX, so it runs on a GPU host without it; the repository's
tests/conftest.py does import JAX, so there run it without the conftest:

    python -m pytest --noconftest tests/test_torch_rollout3d_cuda.py -q

Without a CUDA device every test here skips."""

import os

import numpy as np
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


def _fixture(name):
    z = np.load(os.path.join(os.path.dirname(__file__), "fixtures", name))
    arrs = [torch.as_tensor(z[k], device="cuda")
            for k in ("coefs", "points", "scalars")]
    return z, arrs, torch.as_tensor(z["poses"], device="cuda")


def _jacobi_bars(out, ref, poses, valid_min):
    """The chaos-aware Jacobi bars of tests/test_torch_rollout3d_jacobi.py
    (kernel against the TPU kernel's golden outputs); the final tip-over
    flag after the eval schedule's 1,600 steps is held on ``valid_min`` =
    90% of the lanes (a 1-ulp change of the orientations keeps 94.9% of
    them for the TPU kernel, 93.0% for the plain version:
    scripts/probe_rollout3d_chaos.py --solver jacobi)."""
    from torch_parity import k2_profile

    a, b = k2_profile(out, poses), k2_profile(ref, poses)
    assert np.abs(b["dth"]).max() > 1e-2
    for k, need in (("dth", 0.75), ("dpx", 0.95), ("dpy", 0.95)):
        assert np.mean(np.abs(a[k] - b[k]) < 1e-3) >= need, k
    assert np.median(np.abs(a["dth"] - b["dth"])) <= 1e-4
    assert np.mean(a["valid"] == b["valid"]) >= valid_min
    for k in ("cfull", "ccheap", "citer"):
        np.testing.assert_array_equal(a[k][:, ::128], b[k][:, ::128])


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["datagen", "eval"])
def test_cuda_jacobi_matches_plain_bitwise_and_golden(schedule):
    """The Jacobi instantiation (solver="jacobi"): bitwise equal to the
    plain version in the kernel's order on all 12 planes, launched under
    its own counter, and within the Jacobi bars of its golden fixture."""
    _need_cuda()
    z, arrs, poses = _fixture("rollout3d_jacobi_golden.npz")
    steps, rg, snap = (int(v) for v in z[f"{schedule}_schedule"])
    before = dict(rollout3d.KERNEL_LAUNCHES)
    out = rollout3d.rollout(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, solver="jacobi")
    torch.cuda.synchronize()
    assert rollout3d.KERNEL_LAUNCHES["rollout3d_jacobi"] == \
        before["rollout3d_jacobi"] + 1
    assert rollout3d.KERNEL_LAUNCHES["rollout3d"] == before["rollout3d"]
    ref = profile_batch_ref(*arrs, poses, steps=steps, regrasp_every=rg,
                            snapshot_step=snap, solver="jacobi",
                            sum_group=rollout3d.THREADS_PER_ROLLOUT)
    for k, a, b in zip(NAMES3, out, ref):
        assert torch.equal(a, b), f"{k} differs from the plain version"
    _jacobi_bars({k: v.cpu().numpy() for k, v in zip(NAMES3, out)},
                 {k: z[f"{schedule}_{k}"] for k in NAMES3}, z["poses"],
                 0.95 if schedule == "datagen" else 0.90)


@pytest.mark.cuda
def test_cuda_newton_tol_matches_plain_bitwise_and_golden():
    """The adaptive-Newton instantiation (newton_iters 6, newton_tol 1e-4)
    at the datagen schedule: bitwise equal to the plain version, iteration
    counts that differ between blocks, within the bars of its fixture."""
    _need_cuda()
    z, arrs, poses = _fixture("rollout3d_newton_tol_golden.npz")
    kw = dict(newton_iters=int(z["newton_iters"]),
              newton_tol=float(z["newton_tol"]))
    before = rollout3d.KERNEL_LAUNCHES["rollout3d_newton_tol"]
    out = rollout3d.rollout(*arrs, poses, steps=800, **kw)
    torch.cuda.synchronize()
    assert rollout3d.KERNEL_LAUNCHES["rollout3d_newton_tol"] == before + 1
    ref = profile_batch_ref(*arrs, poses, steps=800,
                            sum_group=rollout3d.THREADS_PER_ROLLOUT, **kw)
    for k, a, b in zip(NAMES3, out, ref):
        assert torch.equal(a, b), f"{k} differs from the plain version"
    it = out[11][:, 0].cpu().numpy()
    assert it[0] != it[1] and (it > out[9][:, 0].cpu().numpy()).all()
    assert_k2_parity({k: v.cpu().numpy() for k, v in zip(NAMES3, out)},
                     {k: z[f"datagen_{k}"] for k in NAMES3}, z["poses"])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [256, 200, 17])
def test_cuda_jacobi_matches_plain_bitwise_at_point_counts(p):
    """The Jacobi instantiation at the launcher's largest point count (256,
    8 points a lane), at one that is no multiple of 32 (200: the lanes hold
    7 or 6 points) and at fewer points than lanes (17): bitwise equal to the
    plain version in the kernel's order on all 12 planes, over the datagen
    schedule of the Jacobi golden fixture's pairs with their first P
    points."""
    _need_cuda()
    z, arrs, poses = _fixture("rollout3d_jacobi_golden.npz")
    arrs = [arrs[0], arrs[1][:, :p].contiguous(), arrs[2]]
    out = rollout3d.rollout_cuda(*arrs, poses, 800, 0, 0, solver="jacobi")
    torch.cuda.synchronize()
    ref = profile_batch_ref(*arrs, poses, steps=800, solver="jacobi",
                            sum_group=rollout3d.THREADS_PER_ROLLOUT)
    assert float(out[9].amax()) > 0.0
    for k, a, b in zip(NAMES3, out, ref):
        assert torch.equal(a, b), f"{k} differs from the plain version"


@pytest.mark.cuda
@pytest.mark.parametrize("p", [257, 512])
def test_cuda_jacobi_launcher_refuses_more_points_than_fit(p):
    """The Jacobi sweeps hold 8 points a lane (and the slab 12 floats a
    point): 257 points (9 a lane) and 512 are refused, not launched."""
    _need_cuda()
    _, arrs, poses = _fixture("rollout3d_jacobi_golden.npz")
    before = rollout3d.KERNEL_LAUNCHES["rollout3d_jacobi"]
    big = arrs[1].repeat(1, 2, 1)[:, :p].contiguous()
    with pytest.raises(RuntimeError, match="point count"):
        rollout3d.rollout_cuda(arrs[0], big, arrs[2], poses, 100, 0, 0,
                               solver="jacobi")
    assert rollout3d.KERNEL_LAUNCHES["rollout3d_jacobi"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [0.0, 1e-4])
@pytest.mark.parametrize("p", [256, 200, 17])
def test_cuda_newton_matches_plain_bitwise_at_point_counts(p, tol):
    """The Newton instantiations at the launcher's largest point count (256,
    8 points a lane), at one that is no multiple of 32 (200) and at fewer
    points than lanes (17), with the fixed iteration count (``newton_tol``
    0: the Newton golden fixture's pairs and poses) and the adaptive loop
    (``newton_iters`` 6, ``newton_tol`` 1e-4: the newton_tol fixture's):
    bitwise equal to the plain version in the kernel's order on all 12
    planes over 800 steps. A count that is no multiple of 32 leaves some of
    each pass's vector totals on lanes that hold fewer points, and the
    friction factor that pass A writes for passes B and C is read back only
    for the lane's own points."""
    _need_cuda()
    if tol:
        z, arrs, poses = _fixture("rollout3d_newton_tol_golden.npz")
        kw = dict(newton_iters=int(z["newton_iters"]), newton_tol=tol)
        inst = "rollout3d_newton_tol"
    else:
        z, arrs, poses = _fixture("rollout3d_golden.npz")
        kw = dict(newton_iters=None, newton_tol=0.0)
        inst = "rollout3d"
    arrs = [arrs[0], arrs[1][:, :p].contiguous(), arrs[2]]
    before = rollout3d.KERNEL_LAUNCHES[inst]
    out = rollout3d.rollout_cuda(*arrs, poses, 800, 0, 0, solver="newton",
                                 **kw)
    torch.cuda.synchronize()
    assert rollout3d.KERNEL_LAUNCHES[inst] == before + 1
    ref = profile_batch_ref(*arrs, poses, steps=800, solver="newton",
                            sum_group=rollout3d.THREADS_PER_ROLLOUT, **kw)
    assert float(out[9].amax()) > 0.0
    for k, a, b in zip(NAMES3, out, ref):
        assert torch.equal(a, b), f"{k} differs from the plain version"
