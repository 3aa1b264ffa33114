"""The port's visualization module (dgdm_tpu_torch/eval/viz.py) against the
JAX package's (dgdm_tpu/eval/viz.py).

The five smoke cases of tests/test_viz.py at their sizes, on the port's
engines; then parity on the same inputs:

- object silhouettes and the 2D video's frames bitwise equal (the frames as
  each package hands them to imageio, captured by a stub writer patched in
  for both);
- the finger curves within 1e-7;
- the 3D scene's scatter points within 1e-6 m (captured by patching
  ``Axes3D.scatter`` for both packages' ``render_scene_3d``);
- the module, and its pure parts, run with matplotlib and imageio blocked.
"""

import importlib
import os
import sys
from unittest import mock

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.eval import viz as jviz
from dgdm_tpu.geom.contour import extract_contours
from dgdm_tpu.geom.fingers import sample_gripper_2d as jsample_gripper_2d
from dgdm_tpu.geom.fingers import sample_gripper_3d as jsample_gripper_3d
from dgdm_tpu.geom.mesh3d import box_mesh as jbox_mesh
from dgdm_tpu.sim import engine2d as J2
from dgdm_tpu.sim import engine3d as J3
from dgdm_tpu_torch.eval import viz
from dgdm_tpu_torch.geom.fingers import (
    ctrlpts_2d,
    sample_gripper_2d,
    sample_gripper_3d,
)
from dgdm_tpu_torch.geom.mesh3d import box_mesh
from dgdm_tpu_torch.sim import engine2d, engine3d
from tests import torch_parity  # noqa: F401  (one torch thread)
from tests.util_icons import make_icon


def _contour():
    ang = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    return np.stack([0.03 * np.cos(ang), 0.04 * np.sin(ang)], -1)


def _star_contour():
    ang = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    rad = 0.035 * (1 + 0.2 * np.sin(3 * ang))
    return np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)


def _exists(path):
    return os.path.exists(path) and os.path.getsize(path) > 0


# ---- the cases of tests/test_viz.py ---------------------------------------


def test_render_object_silhouette_rotates():
    c = _contour()
    m0 = viz.render_object_silhouette(c, 0.0)
    m90 = viz.render_object_silhouette(c, np.pi / 2)
    assert m0.shape == (128, 128)
    assert 0.05 < m0.mean() < 0.95
    assert abs(m0.sum() - m90.sum()) / m0.sum() < 0.1
    assert (m0 != m90).any()


def test_plots_write_files(tmp_path):
    yl, yr = sample_gripper_2d(0)
    p1 = str(tmp_path / "profile.png")
    viz.visualize_profile(np.random.RandomState(0).randint(-1, 2, 36), p1)
    p2 = str(tmp_path / "ctrl.png")
    viz.visualize_ctrlpts(ctrlpts_2d(yl, yr), p2)
    p3 = str(tmp_path / "finals.png")
    viz.visualize_finals(np.linspace(0, 360, 36), p3)
    p4 = str(tmp_path / "denoise.png")
    viz.visualize_denoise_steps(
        np.random.RandomState(1).randn(4, 2, 14, 1), p4)
    img = viz.render_gripper_2d(yl, yr)
    assert img.ndim == 3 and img.shape[2] == 3
    assert all(_exists(p) for p in (p1, p2, p3, p4))


def test_rollout_video(tmp_path):
    yl, yr = sample_gripper_2d(0)
    traj = [(0.0, 0.0, 0.1 * i, 0.0005 * i, -0.0005 * i) for i in range(40)]
    path = viz.rollout_video_2d(
        _contour(), yl, yr, traj, str(tmp_path / "roll.mp4"), stride=5
    )
    # no mp4 backend: the GIF beside it
    assert path in (str(tmp_path / "roll.mp4"), str(tmp_path / "roll.gif"))
    assert _exists(path)


def test_rollout_trace_feeds_video(tmp_path):
    contour = _star_contour()
    yl, yr = sample_gripper_2d(0)
    scene = engine2d.make_scene(yl, yr, contour)
    tr = engine2d.rollout_trace(scene, torch.tensor([0.0, 0.0, 1.0]),
                                steps=40, every=10).numpy()
    assert tr.shape == (4, 5)
    assert np.isfinite(tr).all()
    out = viz.rollout_video_2d(contour, yl, yr, tr,
                               str(tmp_path / "roll.mp4"))
    assert _exists(out)


def test_render_scene_3d_and_video(tmp_path):
    verts, faces = box_mesh()
    yl, yr = sample_gripper_3d(0)
    scene = engine3d.make_scene(yl, yr, verts, faces, num_points=128)
    tr = engine3d.rollout_trace3d(scene, torch.tensor([0.0, 0.0, 0.5]),
                                  steps=40, every=20).numpy()
    assert tr.shape == (2, 9)
    p = viz.render_scene_3d(scene.points.numpy(), scene.com.numpy(), yl, yr,
                            tr[-1], str(tmp_path / "scene3d.png"))
    assert p.endswith(".png") and _exists(p)
    out = viz.rollout_video_3d(scene.points.numpy(), scene.com.numpy(), yl,
                               yr, tr, str(tmp_path / "roll3d.mp4"))
    assert out in (str(tmp_path / "roll3d.mp4"),
                   str(tmp_path / "roll3d_final.png"))
    assert _exists(out)


# ---- parity with the JAX package ------------------------------------------


def test_silhouettes_equal_jax():
    for contour in (_contour(), _star_contour()):
        for th in np.linspace(-1.0, 1.0, 12) * np.pi + np.pi:
            np.testing.assert_array_equal(
                viz.render_object_silhouette(contour, float(th)),
                jviz.render_object_silhouette(contour, float(th)))


class _StubWriter:
    """Stands in for imageio's writer: keeps the frames it is handed."""

    def __init__(self, sink):
        self.sink = sink

    def append_data(self, frame):
        self.sink.append(np.array(frame))

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _captured_frames(video_fn, *args, **kw):
    frames = []
    with mock.patch("imageio.get_writer",
                    lambda *a, **k: _StubWriter(frames)):
        video_fn(*args, **kw)
    return np.stack(frames)


def test_rollout_frames_equal_jax(tmp_path):
    """A JAX trace with regrasp (gripper 3 x icon 3 from pose (0, 0,
    7 pi / 4), 400 steps, every 4, regrasp at 200; the object turns by
    0.46 rad) through both packages' rollout_video_2d: the frames handed to
    imageio bitwise equal, and equal to rollout_frames_2d's."""
    contour = extract_contours(make_icon(3))
    yl, yr = jsample_gripper_2d(3)
    th0 = 7 * np.pi / 4
    tr = np.asarray(J2.rollout_trace(
        J2.make_scene(yl, yr, contour), jnp.array([0.0, 0.0, th0]),
        steps=400, every=4, regrasp_every=200))
    assert np.abs(tr[:, 2] - np.float32(th0)).max() > 1e-2
    path = str(tmp_path / "roll.mp4")
    ref = _captured_frames(jviz.rollout_video_2d, contour, yl, yr, tr, path,
                           stride=3)
    out = _captured_frames(viz.rollout_video_2d, contour, yl, yr, tr, path,
                           stride=3)
    assert out.shape == ref.shape == (34, 128, 128, 3)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        viz.rollout_frames_2d(contour, yl, yr, tr, stride=3), ref)
    # a trace of python floats (test_viz's) as well
    traj = [(0.001 * i, 0.0, 0.1 * i, 0.0005 * i, -0.0005 * i)
            for i in range(20)]
    np.testing.assert_array_equal(
        _captured_frames(viz.rollout_video_2d, _contour(), yl, yr, traj,
                         path, stride=1),
        _captured_frames(jviz.rollout_video_2d, _contour(), yl, yr, traj,
                         path, stride=1))


def test_finger_curves_match_jax():
    for i in range(4):
        yl, yr = jsample_gripper_2d(i)
        for num in (64, 200):
            for a, b in zip(viz._finger_curves(yl, yr, num),
                            jviz._finger_curves(yl, yr, num)):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def _captured_scatter(render_fn, *args):
    from mpl_toolkits.mplot3d import Axes3D

    sets = []

    def scatter(self, xs, ys, zs=0, *a, **k):
        sets.append(np.stack([np.asarray(xs), np.asarray(ys),
                              np.asarray(zs)], -1))

    with mock.patch.object(Axes3D, "scatter", scatter):
        render_fn(*args)
    return sets


def test_scene_3d_points_match_jax(tmp_path):
    """The object and both fingers' points as each package's
    render_scene_3d scatters them, at the last row of a JAX trace: within
    1e-6 m (the finger sheet is a float32 B-spline in both), and equal to
    scene_points_3d's."""
    verts, faces = jbox_mesh()
    yl, yr = jsample_gripper_3d(1)
    scene = J3.make_scene(yl, yr, verts, faces, num_points=128)
    tr = np.asarray(J3.rollout_trace3d(scene, jnp.array([0.0, 0.0, 0.5]),
                                       steps=40, every=20))
    pts, com = np.asarray(scene.points), np.asarray(scene.com)
    path = str(tmp_path / "s.png")
    ref = _captured_scatter(jviz.render_scene_3d, pts, com, yl, yr, tr[-1],
                            path)
    out = _captured_scatter(viz.render_scene_3d, pts, com, yl, yr, tr[-1],
                            path)
    assert [a.shape for a in out] == [a.shape for a in ref] == [
        (128, 3), (625, 3), (625, 3)]
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(viz.scene_points_3d(pts, com, yl, yr, tr[-1]), out):
        np.testing.assert_array_equal(a, b)


def test_imports_without_writers():
    """With matplotlib and imageio blocked, the module imports and its pure
    parts run; a writer raises ImportError."""
    blocked = {"matplotlib": None, "matplotlib.pyplot": None,
               "imageio": None, "imageio.v2": None}
    with mock.patch.dict(sys.modules, blocked):
        sys.modules.pop("dgdm_tpu_torch.eval.viz", None)
        mod = importlib.import_module("dgdm_tpu_torch.eval.viz")
        yl, yr = sample_gripper_2d(0)
        frames = mod.rollout_frames_2d(
            _contour(), yl, yr, [(0.0, 0.0, 0.3, 0.0, 0.0)] * 3, stride=1)
        assert frames.shape == (3, 128, 128, 3)
        y3l, y3r = sample_gripper_3d(0)
        row = np.array([0, 0, 0.05, 1, 0, 0, 0, 0.01, -0.01], np.float32)
        sets = mod.scene_points_3d(np.zeros((5, 3)), np.zeros(3), y3l, y3r,
                                   row)
        assert [s.shape for s in sets] == [(5, 3), (625, 3), (625, 3)]
        with pytest.raises(ImportError):
            mod.write_video(frames, "unused.mp4")
        with pytest.raises(ImportError):
            mod.visualize_finals(np.zeros(3), "unused.png")
    sys.modules["dgdm_tpu_torch.eval.viz"] = viz
