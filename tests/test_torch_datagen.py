"""The port's datagen (dgdm_tpu_torch/sim/datagen.py, datagen3d.py,
pipeline.py) on the CPU, where the rollouts are the kernels' plain versions:

- generate_2d: the non-rollout fields equal JAX's ``_curve_points``,
  ``ctrlpts_2d`` and ``pose_grid`` (1e-7); the rollout fields equal
  ``rollout2d.profile_batch`` of the same scenes bit for bit (which
  test_torch_rollout2d.py holds to the Pallas kernel), after 200 steps in
  which the objects moved (max |dtheta| > 1e-2); its shards load in JAX's
  DynamicsData with the port's rows;
- pipeline_2d writes the same records and shards as generate_2d;
- generate_3d / pipeline_3d: the non-rollout fields equal JAX's
  ``ctrlpts_3d`` and ``surface_points_3d`` (1e-7), the rollout fields
  ``rollout3d.profile_batch`` bit for bit, the pipeline's records and
  shards the one-shot path's, and a pair with any tipped rollout maps to
  None and writes no shard (the give-up);
- throughput_workload runs and counts its rollouts, through the kernel's
  route and through the pure engine's (``use_pallas=False``).

The 3D cases run 40 steps, not the 800 a parity test needs: they compare
two compositions of the same rollout function on the same arrays (record
assembly, padding, give-up, npz), not physics, so nothing has to move; K2
itself is held to the Pallas kernel at 800 steps in test_torch_rollout3d.py.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from dgdm_tpu.geom.fingers import ctrlpts_2d as j_ctrlpts_2d
from dgdm_tpu.geom.fingers import ctrlpts_3d as j_ctrlpts_3d
from dgdm_tpu.sim import datagen as jdatagen
from dgdm_tpu.sim import datagen3d as jdatagen3d
from dgdm_tpu.sim.engine2d import pose_grid as j_pose_grid
from dgdm_tpu.train import data as jdata
from dgdm_tpu_torch.geom import mesh3d
from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
from dgdm_tpu_torch.geom.fingers import sample_gripper_2d, sample_gripper_3d
from dgdm_tpu_torch.sim import datagen, datagen3d, engine2d, pipeline
from dgdm_tpu_torch.sim import rollout2d, rollout3d
from dgdm_tpu_torch.train import data as tdata
from tests import torch_parity  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUG = os.path.join(ROOT, "tests", "fixtures", "scanned_objects", "mug_small",
                   "model.obj")
GRIPS = [0, 1]
GRID = dict(grid_size=128, num_pos=1)      # 128 poses: one pose group


def _npz(path):
    return np.load(path, allow_pickle=True)["arr_0"].item()


def _same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        if ra is None or rb is None:
            assert ra is None and rb is None
            continue
        assert ra.keys() == rb.keys()
        for k in ra:
            if k == "object_name":
                assert ra[k] == rb[k]
            else:
                assert ra[k].dtype == rb[k].dtype == np.float32, k
                assert np.array_equal(ra[k], rb[k]), k


@pytest.fixture(scope="module")
def runs_2d(tmp_path_factory):
    """generate_2d and pipeline_2d over 2 synthetic icons x 2 grippers."""
    root = tmp_path_factory.mktemp("dg2d")
    objects = [(oi, extract_contours(synthetic_icon(oi))) for oi in (0, 1)]
    one_shot = {oi: datagen.generate_2d(oi, c, GRIPS, str(root / "gen"),
                                        device="cpu", **GRID)
                for oi, c in objects}
    piped = {}
    summary = pipeline.pipeline_2d(
        objects, GRIPS, str(root / "pipe"), device="cpu",
        on_records=lambda oi, recs: piped.__setitem__(oi, recs), **GRID)
    return root, objects, one_shot, piped, summary


def test_generate_2d_fields(runs_2d):
    _, objects, one_shot, _, _ = runs_2d
    oi, contour = objects[0]
    poses = j_pose_grid(**GRID)
    # rollout fields: the same scenes through the rollout wrapper
    scenes = datagen.stack_scenes([engine2d.make_scene(
        *sample_gripper_2d(g), contour) for g in GRIPS])
    arrs = rollout2d.scene_arrays(scenes, device="cpu")
    dth, dpos, _, _ = rollout2d.profile_batch(*arrs, torch.from_numpy(poses))
    assert float(dth.abs().max()) > 1e-2, "the rollouts did not move"
    for b, (g, rec) in enumerate(zip(GRIPS, one_shot[oi])):
        yl, yr = sample_gripper_2d(g)
        np.testing.assert_allclose(rec["ctrlpts"], j_ctrlpts_2d(yl, yr),
                                   atol=1e-7)
        np.testing.assert_allclose(rec["allpts"],
                                   jdatagen._curve_points(yl, yr), atol=1e-7)
        np.testing.assert_allclose(rec["obj_theta"], poses[:, 2], atol=1e-7)
        np.testing.assert_allclose(rec["obj_pos"][:, :2], poses[:, :2],
                                   atol=1e-7)
        assert (rec["obj_pos"][:, 2] == 0).all()
        np.testing.assert_allclose(rec["object_vertices"], contour, atol=1e-7)
        assert np.array_equal(rec["delta_theta"], dth[b].numpy())
        assert np.array_equal(rec["delta_pos"][:, :2], dpos[b].numpy())
        assert (rec["delta_pos"][:, 2] == 0).all()


def test_pipeline_2d_matches_generate_2d(runs_2d):
    root, objects, one_shot, piped, summary = runs_2d
    assert summary["pairs"] == summary["pairs_valid"] == 4
    assert summary["waves"] == 2 and summary["rollouts"] == 4 * 128
    assert summary["kernel_s"] > 0 and summary["bake_s"] > 0
    # on the CPU each launch has finished when it returns, and the time
    # between two launches is the host's
    assert summary["drains_under_kernel"] == 0 and summary["gap_s"] > 0
    for oi, _ in objects:
        _same_records(piped[oi], one_shot[oi])
        for g in GRIPS:
            name = f"{oi}_{g}.npz"
            _same_records([_npz(root / "pipe" / name)],
                          [_npz(root / "gen" / name)])


def test_port_shards_load_in_jax(runs_2d):
    root = runs_2d[0]
    for mirror in (False, True):
        a = jdata.DynamicsData(str(root / "gen"), mirror_augment=mirror)
        b = tdata.DynamicsData(str(root / "gen"), mirror_augment=mirror)
        assert len(a) == len(b) == 4
        for ra, rb in zip(a.batches(2, np.random.RandomState(1)),
                          b.batches(2, np.random.RandomState(1))):
            for k in ra:
                assert np.array_equal(ra[k], rb[k]), k


def test_generate_and_pipeline_3d(tmp_path):
    verts, faces = mesh3d.load_obj(MUG)
    grid = dict(grid_size=8, num_pos=1, steps=40)
    orig = rollout3d.profile_batch
    calls = []

    def tip_pair_1(*args, **kw):
        """The real rollouts, then pair 1 tips over in one rollout."""
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        valid = out[3].clone()
        valid[1, 3] = False
        return out[:3] + (valid,) + out[4:]

    with mock.patch.object(rollout3d, "profile_batch", tip_pair_1):
        one_shot = datagen3d.generate_3d(0, "mug_small", verts, faces, GRIPS,
                                         str(tmp_path / "gen"), device="cpu",
                                         **grid)
        piped = {}
        summary = pipeline.pipeline_3d(
            [(0, "mug_small", verts, faces)], GRIPS, str(tmp_path / "pipe"),
            device="cpu",
            on_records=lambda oi, recs: piped.__setitem__(oi, recs), **grid)
    assert one_shot[1] is None and piped[0][1] is None
    assert summary["pairs"] == 2 and summary["pairs_valid"] == 1
    _same_records(piped[0], one_shot)
    assert sorted(os.listdir(tmp_path / "gen")) == ["0_0.npz"]
    assert sorted(os.listdir(tmp_path / "pipe")) == ["0_0.npz"]
    _same_records([_npz(tmp_path / "pipe" / "0_0.npz")],
                  [_npz(tmp_path / "gen" / "0_0.npz")])
    # K2 ran on one object_properties_3d per object: 256 contact points
    (args, kw, out), _ = calls
    assert args[1].shape == (2, 256, 4) and kw["steps"] == 40
    rec = one_shot[0]
    poses = j_pose_grid(8, 1)
    n = poses.shape[0]
    assert np.array_equal(rec["delta_theta"], out[0][0, :n].numpy())
    assert np.array_equal(rec["delta_pos"][:, :2], out[1][0, :n].numpy())
    yl, yr = sample_gripper_3d(0)
    np.testing.assert_allclose(rec["ctrlpts"], j_ctrlpts_3d(yl, yr), atol=1e-7)
    np.testing.assert_allclose(rec["allpts"],
                               jdatagen3d.surface_points_3d(yl, yr),
                               atol=1e-7)
    np.testing.assert_allclose(rec["obj_theta"], poses[:, 2], atol=1e-7)
    assert rec["object_name"] == "mug_small"


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel", "pure_engine"])
def test_throughput_workload(use_pallas):
    """Both routes count their rollouts; ``use_pallas=False`` runs the pure
    engine in chunks of 5 poses (the last one short) and never the
    kernel's wrapper."""
    run, total = datagen.throughput_workload(num_pairs=2, grid_size=8,
                                             num_pos=1, chunk=5,
                                             use_pallas=use_pallas,
                                             device="cpu")
    if use_pallas:
        out = run()
    else:
        with mock.patch.object(datagen.rollout2d, "profile_batch",
                               side_effect=AssertionError("kernel route")):
            out = run()
    assert total == 16 and out["delta_theta"].shape == (2, 8)
    assert out["delta_pos"].shape == (2, 8, 2)
    assert np.isfinite(out["delta_pos"]).all()
    assert np.abs(out["delta_theta"]).max() > 1e-2
