"""The port's data pipeline, metric sink and step timer against the JAX
package: normalize_record_2d / _3d, mirror_rows_2d (with its padding-prefix
rule) and procedural_grippers bit for bit; DynamicsData / DynamicsData3D
yield the same shard order and the same rows for a seed; npz shards move
between the two packages (the port writes, JAX's DynamicsData reads, and the
reverse); MetricSink writes the JAX records; StepTimer keeps the JAX EWMA;
TraceWindow is inert without a directory and writes a torch.profiler trace
with one."""

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from dgdm_tpu.core import profiling as jprof
from dgdm_tpu.sim import pipeline as jpipeline
from dgdm_tpu.train import data as jdata
from dgdm_tpu.train.logging import MetricSink as JSink
from dgdm_tpu_torch.core import profiling as tprof
from dgdm_tpu_torch.sim import datagen as tdatagen
from dgdm_tpu_torch.train import data as tdata
from dgdm_tpu_torch.train.logging import MetricSink as TSink
from tests import torch_parity  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECTS = os.path.join(ROOT, "tests", "fixtures", "scanned_objects")


def _record(seed, n=16, nv=37, name=None):
    """A shard-shaped record (random values) in the reference layout."""
    rs = np.random.RandomState(seed)
    f = np.float32
    rec = {
        "ctrlpts": rs.uniform(-0.05, 0.05, (42, 3) if name else (14, 2))
        .astype(f),
        "allpts": rs.uniform(-0.05, 0.05, (1250, 3) if name else (400, 2))
        .astype(f),
        "obj_pos": np.concatenate([rs.uniform(-0.03, 0.03, (n, 2)),
                                   np.zeros((n, 1))], 1).astype(f),
        "obj_theta": rs.uniform(0, 2 * np.pi, n).astype(f),
        "delta_theta": rs.randn(n).astype(f) * 0.1,
        "delta_pos": np.concatenate([rs.randn(n, 2) * 0.01,
                                     np.zeros((n, 1))], 1).astype(f),
    }
    if name:
        rec["object_name"] = name
    else:
        ang = np.sort(rs.uniform(0, 2 * np.pi, nv))
        rec["object_vertices"] = (0.04 * np.stack([np.cos(ang), np.sin(ang)],
                                                  -1)).astype(f)
    return rec


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("nv", [37, 100, 120])
def test_normalize_and_mirror_2d_bitwise(nv):
    rec = _record(0, nv=nv)
    rows = tdata.normalize_record_2d(rec)
    _equal(rows, jdata.normalize_record_2d(rec))
    # the contour's zero padding stays at the tail after the mirror
    _equal(tdata.mirror_rows_2d(rows), jdata.mirror_rows_2d(rows))
    if nv < 100:
        m = tdata.mirror_rows_2d(rows)["obj"].reshape(len(rows["obj"]), -1, 2)
        assert (m[:, nv:] == 0).all() and (m[:, :nv] != 0).any(-1).all()


def test_normalize_record_3d_bitwise():
    rec = _record(1, name="mug_small")
    pts = np.random.RandomState(2).uniform(-0.05, 0.05, (64, 3))
    _equal(tdata.normalize_record_3d(rec, pts),
           jdata.normalize_record_3d(rec, pts))


@pytest.mark.parametrize("fingers_3d", [False, True])
def test_procedural_grippers_bitwise(fingers_3d):
    out = tdata.procedural_grippers(50, fingers_3d)
    ref = jdata.procedural_grippers(50, fingers_3d)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert out[0].shape == (45, 42 if fingers_3d else 14, 1)


def _shards(tmp_path, n=7, name=None):
    d = tmp_path / "shards"
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        np.savez_compressed(str(d / f"{i}_{i % 3}.npz"),
                            _record(10 + i, name=name))
    return str(d)


@pytest.mark.parametrize("mirror", [False, True])
def test_dynamics_data_batches_match_jax(tmp_path, mirror):
    d = _shards(tmp_path)
    tds = tdata.DynamicsData(d, mirror_augment=mirror)
    jds = jdata.DynamicsData(d, mirror_augment=mirror)
    assert tds.files == jds.files and len(tds) == 7
    for shuffle in (True, False):
        t_rng, j_rng = np.random.RandomState(3), np.random.RandomState(3)
        for epoch in range(2):
            tb = list(tds.batches(3, t_rng, shuffle=shuffle))
            jb = list(jds.batches(3, j_rng, shuffle=shuffle))
            assert len(tb) == len(jb) == 3
            for a, b in zip(tb, jb):
                _equal(a, b)


def test_dynamics_data_3d_matches_jax(tmp_path):
    d = _shards(tmp_path, n=3, name="mug_small")
    tds = tdata.DynamicsData3D(d, OBJECTS, num_points=128)
    jds = jdata.DynamicsData3D(d, OBJECTS, num_points=128)
    for a, b in zip(tds.batches(2, np.random.RandomState(0)),
                    jds.batches(2, np.random.RandomState(0))):
        _equal(a, b)
        assert a["obj"].shape[1:] == (128, 3)


def test_npz_shards_move_between_packages(tmp_path):
    """Shards written by the port's writer load in JAX's DynamicsData, and
    shards written by JAX's pipeline writer in the port's, with equal rows
    (sim/datagen.make_record is the record both write)."""
    poses = tdatagen.pad_poses(np.zeros((5, 3), np.float32), 8)
    obj_pos, theta0 = tdatagen.pose_fields(poses)
    rs = np.random.RandomState(4)
    rec = tdatagen.make_record(
        _record(0)["ctrlpts"], _record(0)["allpts"],
        {"object_vertices": _record(0)["object_vertices"]}, obj_pos, theta0,
        rs.randn(8).astype(np.float32), rs.randn(8, 2).astype(np.float32))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    os.makedirs(port_dir)
    os.makedirs(jax_dir)
    np.savez_compressed(tdatagen.shard_path(str(port_dir), 0, 1), rec)
    jpipeline._write_npz(str(jax_dir / "0_1.npz"), rec)
    for d in (port_dir, jax_dir):
        a = jdata.DynamicsData(str(d)).load(0)
        b = tdata.DynamicsData(str(d)).load(0)
        _equal(a, b)
        assert a["ctrl"].shape == (8, 14)


def test_metric_sink_writes_jax_records(tmp_path):
    metrics = {"train/loss": torch.tensor(0.25), "train/acc_ori": 0.5,
               "perf/rows_per_second": np.float32(1e5), "note": "x"}
    for cls, sub in ((TSink, "t"), (JSink, "j")):
        sink = cls(str(tmp_path / sub), use_wandb=False)
        sink.log(metrics if cls is TSink else
                 {k: (float(v) if torch.is_tensor(v) else v)
                  for k, v in metrics.items()}, step=20)
        sink.close()
    recs = []
    for sub in ("t", "j"):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            (line,) = f.read().splitlines()
        rec = json.loads(line)
        rec.pop("ts")
        recs.append(rec)
    assert recs[0] == recs[1]
    assert recs[0]["train/loss"] == 0.25 and recs[0]["step"] == 20


def test_step_timer_matches_jax():
    t_timer, j_timer = tprof.StepTimer(device="cpu"), jprof.StepTimer()
    for timer, mod in ((t_timer, tprof), (j_timer, jprof)):
        times = list(np.cumsum([0.0, 0.5, 0.25, 1.0, 0.125, 2.0]))
        with mock.patch.object(mod.time, "perf_counter",
                               lambda: times.pop(0)):
            for items in (10, 20, 30, 40, 50, 60):
                timer.tick(items)
    assert t_timer.rate() == j_timer.rate() > 0
    assert t_timer.ewma == j_timer.ewma
    assert t_timer.metrics(7.0) == j_timer.metrics(7.0)


def test_trace_window(tmp_path):
    inert = tprof.TraceWindow("")
    for i in range(10):
        inert.step(i)
    inert.close()
    log_dir = str(tmp_path / "trace")
    tw = tprof.TraceWindow(log_dir, start=1, stop=3)
    x = torch.ones(64, 64)
    for i in range(5):
        tw.step(i)
        with torch.profiler.record_function("matmul"):
            x = x @ x / 64
    tw.close()
    assert any(f.endswith(".json") for f in os.listdir(log_dir))
