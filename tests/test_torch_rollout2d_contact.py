"""Contact compaction of K1's Newton solve (``full_solve`` of
dgdm_tpu_torch/csrc/rollout2d.cu), held on the CPU through the kernel's
plain version (``sim/rollout2d_ref.py``).

The kernel's full solve stores the geometry of a lane's points in contact
only (act != 0) and runs its contour passes over those. That changes no bit
when every term of a point out of contact is +0 or -0 and the lane-ordered
float64 sum skips it without effect. Here every contour-shaped point sum
that the plain version's Newton solve takes (per iteration the grip load,
the 8 force and moment sums and the 14 Hessian entries of the kernel's
contour pass, and the 3 line-search energies: 26) is intercepted with the
solve's ``act``, on a real 200-step rollout of the 2D datagen cell's
traffic (a synthetic icon, a gripper of the pool block drawn from the
cell's pool seed, one 128-pose block of the padded 9,088-pose grid). Each
is held bit for bit, in float64 and -0.0 included, to the same lane-ordered
sum (``point_sum64(..., group=16)``: lane r adds p = r, r + 16, ... onto
+0.0, then the xor butterfly) with the points out of contact skipped.

Output plane 8 of ``profile_batch_ref`` (each rollout's points in contact
summed over its block's full solves, or over its solves with Jacobi) is
held to a count of the same ``act`` tensors, masked by the block's own
branch decisions, for both solvers. The card tests
(tests/test_torch_rollout2d_cuda.py) hold the kernel's plane 8 to this
one."""

import sys

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
from dgdm_tpu_torch.geom.fingers import sample_gripper_2d
from dgdm_tpu_torch.sim import datagen, engine2d, rollout2d, rollout2d_ref
from dgdm_tpu_torch.sim.point_sum import point_sum64

G = rollout2d.THREADS_PER_ROLLOUT
# the 2D datagen cell's gripper pool: its seed, size and block
POOL_SEED, POOL, BLOCK = 20240223, 1000, 32
STEPS = 200
# contour-shaped point sums of one Newton iteration
SUMS_PER_ITER = 1 + 8 + 14 + 3


def _scene_case(icons, grippers, block, solver):
    """Scene arrays of icon x gripper pairs (CPU) and one 128-pose block of
    the padded datagen grid."""
    pool = np.random.default_rng(POOL_SEED).choice(POOL, size=BLOCK,
                                                   replace=False)
    scenes = [engine2d.make_scene(*sample_gripper_2d(int(pool[g])),
                                  extract_contours(synthetic_icon(i)))
              for i in icons for g in grippers]
    calib = engine2d.Calib(**{
        k: float(np.float32(v)) for k, v in (
            engine2d.FITTED_2D_NEWTON if solver == "newton"
            else engine2d.FITTED_2D).items()})
    arrs = rollout2d.scene_arrays(datagen.stack_scenes(scenes), calib=calib,
                                  device="cpu")
    poses = datagen.pad_poses(engine2d.pose_grid())
    lane = rollout2d_ref.LANE
    return arrs, torch.from_numpy(poses[block * lane:(block + 1) * lane])


def _local(frame, func, name):
    """Local ``name`` of the nearest caller frame running ``func``."""
    while frame is not None:
        if frame.f_code.co_name == func:
            return frame.f_locals[name]
        frame = frame.f_back
    return None


def _compacted64(x, act, group):
    """Lane-ordered float64 sum of float32 ``x`` over dim 2 with the points
    whose ``act`` is 0 skipped: lane r adds its points in contact, in
    increasing p, onto +0.0; then the xor butterfly of ``point_sum64``."""
    x, act = torch.broadcast_tensors(x, act)
    x, on = x.movedim(2, 0).double(), act.movedim(2, 0) != 0
    acc = torch.zeros((group,) + tuple(x.shape[1:]), dtype=torch.float64)
    for start in range(0, x.shape[0], group):
        chunk, keep = x[start:start + group], on[start:start + group]
        n = chunk.shape[0]
        acc[:n] = torch.where(keep, acc[:n] + chunk, acc[:n])
    half = group // 2
    while half >= 1:
        acc = acc[:half] + acc[half:2 * half]
        half //= 2
    return acc[0]


def _bits(t):
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("icon", [0, 5])
def test_newton_contour_sums_skip_points_out_of_contact(monkeypatch, icon):
    arrs, poses = _scene_case([icon], [0], 17, "newton")
    p = arrs[1].shape[1]
    assert p % G != 0            # the upper lanes hold one point fewer
    real = rollout2d_ref.point_sum
    seen = {"sums": 0, "solves": 0, "neg_zero": 0, "in_contact": 0,
            "mixed_lanes": 0}
    last = [None]

    def spy(x, dim, group=0):
        act = _local(sys._getframe(1), "full_solve", "act")
        if act is not None and x.shape[dim] == p:
            assert dim == 2
            if act is not last[0]:
                last[0] = act
                seen["solves"] += 1
                on = act != 0
                seen["in_contact"] += int(on.sum())
                lanes = on.any(dim=2) & ~on.all(dim=2)
                seen["mixed_lanes"] += int(lanes.sum())
            xx, aa = torch.broadcast_tensors(x, act)
            off = xx[aa == 0]
            # a point out of contact adds +0 or -0 to the sum
            assert bool((off == 0).all())
            seen["neg_zero"] += int(torch.signbit(off).sum())
            full = point_sum64(x, dim, G)
            assert torch.equal(_bits(full), _bits(_compacted64(x, act, G)))
            seen["sums"] += 1
        return real(x, dim, group)

    monkeypatch.setattr(rollout2d_ref, "point_sum", spy)
    out = rollout2d_ref.profile_batch_ref(*arrs, poses, steps=STEPS,
                                          sum_group=G, solver="newton")
    full_steps = int(out[6][0, 0])
    assert full_steps > 0 and seen["solves"] == full_steps
    # 26 sums an iteration, and the solve's count of its points in
    # contact (plane 8's term)
    assert seen["sums"] == (SUMS_PER_ITER * engine2d.NEWTON_ITERS + 1) \
        * full_steps
    # the compaction is not vacuous: points in contact, lanes with points
    # both in and out of contact, and -0.0 terms among those skipped
    assert seen["in_contact"] > 0 and seen["mixed_lanes"] > 0
    assert seen["neg_zero"] > 0
    assert float(out[8].sum()) == seen["in_contact"]


@pytest.mark.parametrize("solver", ["newton", "jacobi"])
def test_contact_plane_counts_act_over_the_solves(monkeypatch, solver):
    """Plane 8 against the ``act`` of each solve the plain version took,
    counted where the block did not travel and (Newton) took the full
    solve; 2 grippers, so that the pairs' blocks may branch apart."""
    monkeypatch.setattr(engine2d, "SOLVER", solver)
    arrs, poses = _scene_case([2], [0, 1], 40, solver)
    p = arrs[1].shape[1]
    real = rollout2d_ref.point_sum
    solve = "full_solve" if solver == "newton" else "jacobi_step"
    count = torch.zeros(2, 1, rollout2d_ref.LANE, dtype=torch.float64)
    last = [None]

    def spy(x, dim, group=0):
        frame = sys._getframe(1)
        act = _local(frame, solve, "act")
        if act is not None and act is not last[0] and x.shape[dim] == p:
            last[0] = act
            taken = ~_local(frame, "profile_batch_ref", "travel")
            if solver == "newton":
                taken = taken & _local(frame, "normal_step", "any_f")
            count.add_(act.double().sum(dim=2) * taken)
        return real(x, dim, group)

    monkeypatch.setattr(rollout2d_ref, "point_sum", spy)
    out = rollout2d_ref.profile_batch_ref(*arrs, poses, steps=STEPS,
                                          sum_group=G, solver=solver)
    assert len(out) == 9
    assert float(count.sum()) > 0
    assert torch.equal(out[8], count.reshape(2, -1).float())
    if solver == "newton":
        # each in-contact count is at most every point of every full solve
        assert bool((out[8] <= p * out[6]).all())
