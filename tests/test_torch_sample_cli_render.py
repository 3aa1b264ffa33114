"""``dgdm_tpu_torch.cli.sample --render_video`` on the CPU, 2D and
``--fingers_3d``, at the sizes of tests/test_torch_sample_cli.py
(``--eval_steps 60``).

- The JAX CLI's file set (dgdm_tpu/cli/sample.py:199-212, 274-350):
  ``denoise_steps.npy`` / ``.png``; per (objective, object) pair, 2D
  ``_gripper.png``, ``_profile.png``, ``_final.png``, ``_silhouettes.npy``
  and ``_rollout.mp4`` or, without an mp4 backend, ``_rollout.gif``; 3D
  ``_scene.png``, ``_profile.png`` and ``_rollout.mp4`` or
  ``_rollout_final.png``.
- ``guided_report.json`` equal with and without the flag (but for its
  seconds), and the last row of ``denoise_steps.npy`` equal, bitwise, to
  the unguided samples (``generator.sample`` on the same weights and noise).
- ``render_inputs``' batched traces against each pair traced alone
  (2D: 400 steps, every 20, regrasp every 200; 3D: 800 steps, every 20),
  within theta (or quaternion) 1e-4 and positions and finger slides 1e-5 m,
  after the non-zero guard. The bars come from ``JAX_PLATFORMS=cpu python
  scripts/probe_trace_chaos.py``: a 1-ulp change of the initial orientation
  moves these traces by at most 1.19e-6 rad and 3.5e-7 m (2D) and 9e-8
  (3D); batched and alone agree bitwise on the CPU.
- With matplotlib or imageio blocked the flag raises ImportError naming the
  package before any weights are loaded or samples drawn.
"""

import json
import math
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.cli import sample as sample_cli
from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
from dgdm_tpu_torch.geom import mesh3d
from dgdm_tpu_torch.geom.fingers import sample_gripper_2d, sample_gripper_3d
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.models.profile3d import ProfileForward3D
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
from dgdm_tpu_torch.sim import engine2d, engine3d
from dgdm_tpu_torch.eval.viz import FRAME_COLORS
from dgdm_tpu_torch.train import generator
from tests import torch_parity  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECTS = os.path.join(ROOT, "tests", "fixtures", "scanned_objects")
ANGLE_BAR, POS_BAR = 1e-4, 1e-5


def _checkpoints(tmp_path, fingers_3d):
    torch.manual_seed(0)
    unet = ConditionalUnet1D(input_dim=1)
    gpath = str(tmp_path / "unet.npz")
    convert.save_npz(gpath, unet.state_dict(), {"down_dims": [128, 256]})
    dpath = str(tmp_path / "dyn.npz")
    if fingers_3d:
        convert.save_npz(dpath, ProfileForward3D(width=32).state_dict(),
                         {"width": 32, "params_ch": 42})
    else:
        cls = ProfileForward2D(params_ch=14, object_ch=200)
        with torch.no_grad():
            for bn in cls.trunk_bns:
                bn.running_mean.normal_(0.0, 0.1)
                bn.running_var.uniform_(0.8, 1.2)
        convert.save_npz(dpath, cls.state_dict(),
                         {"width": 256, "num_trunk": 8, "object_ch": 200})
    return gpath, dpath


def _argv(gpath, dpath, save_dir, fingers_3d):
    argv = ["--diffusion_checkpoint_path", gpath, "--checkpoint_path", dpath,
            "--save_dir", save_dir, "--batch_size", "2", "--grid_size", "8",
            "--num_pos", "1", "--sub_bs", "8", "--eval_steps", "60",
            "--device", "cpu"]
    if fingers_3d:
        return argv + ["--fingers_3d", "--ctrlpts_dim", "42",
                       "--objectives", "convergence,shift_up",
                       "--object_dir", OBJECTS,
                       "--object_max_num_vertices", "100"]
    return argv + ["--objectives", "convergence,rotate",
                   "--num_test_objects", "1"]


def _without_seconds(report):
    out = json.loads(json.dumps(report, default=str))
    for k in ("design_sweep", "verification"):
        out[k].pop("seconds")
    return out


def _run_both(tmp_path, fingers_3d):
    gpath, dpath = _checkpoints(tmp_path, fingers_3d)
    plain_dir, render_dir = str(tmp_path / "plain"), str(tmp_path / "render")
    plain = sample_cli.main(_argv(gpath, dpath, plain_dir, fingers_3d))
    render = sample_cli.main(_argv(gpath, dpath, render_dir, fingers_3d)
                             + ["--render_video"])
    assert _without_seconds(render) == _without_seconds(plain)
    with open(os.path.join(render_dir, "guided_report.json")) as f:
        assert _without_seconds(json.load(f)) == _without_seconds(plain)
    # the denoise trajectory: noise first, the unguided samples last
    traj = np.load(os.path.join(render_dir, "denoise_steps.npy"))
    ctrl = 42 if fingers_3d else 14
    noise = np.random.RandomState(0).randn(2, ctrl, 1).astype(np.float32)
    unet = convert.load_model(gpath, "unet", input_dim=1)
    # the CLI's defaults: 15 train timesteps, 5 DDIM steps
    unguided = generator.sample(unet, torch.from_numpy(noise), 15, 5).numpy()
    assert traj.shape == (6, 2, ctrl, 1)
    np.testing.assert_array_equal(traj[0], noise)
    np.testing.assert_array_equal(traj[-1], unguided)
    return sorted(os.listdir(plain_dir)), sorted(os.listdir(render_dir)), \
        render_dir


def _exists(path):
    return os.path.exists(path) and os.path.getsize(path) > 0


def test_render_video_2d(tmp_path):
    plain, files, out = _run_both(tmp_path, fingers_3d=False)
    stems = [f"{o}_10000" for o in ("convergence", "rotate")]
    want = {"denoise_steps.npy", "denoise_steps.png"}
    for stem in stems:
        want |= {stem + s for s in ("_gripper.png", "_profile.png",
                                    "_final.png", "_silhouettes.npy")}
        video = [f for f in files if f.startswith(stem + "_rollout.")]
        assert video in ([stem + "_rollout.mp4"], [stem + "_rollout.gif"])
        want.add(video[0])
        sil = np.load(os.path.join(out, stem + "_silhouettes.npy"))
        assert sil.shape == (8, 128, 128) and sil.any()
    assert set(files) == set(plain) | want
    assert all(_exists(os.path.join(out, f)) for f in want)


def test_render_video_3d(tmp_path):
    plain, files, out = _run_both(tmp_path, fingers_3d=True)
    want = {"denoise_steps.npy", "denoise_steps.png"}
    for stem in ("convergence_mug_small", "shift_up_mug_small"):
        want |= {stem + "_scene.png", stem + "_profile.png"}
        video = [f for f in files if f.startswith(stem + "_rollout")]
        assert video in ([stem + "_rollout.mp4"],
                         [stem + "_rollout_final.png"])
        want.add(video[0])
    assert set(files) == set(plain) | want
    assert all(_exists(os.path.join(out, f)) for f in want)


def _close(batched, alone, angle_cols, pos_cols):
    err = np.abs(batched - alone).reshape(-1, batched.shape[-1]).max(0)
    assert err[angle_cols].max() <= ANGLE_BAR, err
    assert err[pos_cols].max() <= POS_BAR, err


def test_render_inputs_2d_batched_matches_alone():
    """4 pairs (grippers 0-3 x synthetic icons 0/1) through render_inputs:
    the trace of each against the pair traced alone, and its frames."""
    contours = [extract_contours(synthetic_icon(i)) for i in (0, 1)]
    pairs = [{"y": np.concatenate(sample_gripper_2d(i)),
              "object": contours[i % 2]} for i in range(4)]
    items, timing = sample_cli.render_inputs(
        pairs, False, "cpu", steps=400, every=20, regrasp_every=200,
        grid_size=36)
    batched = np.stack([it["trace"] for it in items])
    assert batched.shape == (4, 20, 5) and np.isfinite(batched).all()
    assert np.abs(batched[..., 2] - np.float32(math.pi)).max() > 1e-2
    pose = torch.tensor([0.0, 0.0, math.pi])
    alone = np.stack([engine2d.rollout_trace(
        engine2d.make_scene(p["y"][:7], p["y"][7:], p["object"]), pose,
        steps=400, every=20, regrasp_every=200).numpy() for p in pairs])
    _close(batched, alone, [2], [0, 1, 3, 4])
    assert timing["trace_s"] > 0
    for it in items:
        fr = it["frames"]
        assert fr.shape == (20, 128, 128, 3) and fr.dtype == np.uint8
        colours = np.unique(fr.reshape(-1, 3), axis=0)
        assert {tuple(c) for c in colours} <= {tuple(c) for c in FRAME_COLORS}
        # frame 0 shows the object and both fingers
        first = {tuple(c) for c in np.unique(fr[0].reshape(-1, 3), axis=0)}
        assert first == {tuple(c) for c in FRAME_COLORS}
        assert it["silhouettes"].shape == (12, 128, 128)


def test_render_inputs_3d_batched_matches_alone():
    """2 pairs (grippers 0-1 x mug_small): each 800-step trace (every 20)
    against the pair traced alone; unit quaternions."""
    verts, faces = mesh3d.load_obj(os.path.join(OBJECTS, "mug_small",
                                                "model.obj"))
    pairs = [{"y": np.concatenate(sample_gripper_3d(i)),
              "object": (verts, faces)} for i in range(2)]
    steps, every, regrasp = sample_cli.render_schedule(True)
    assert (steps, every, regrasp) == (800, 20, 0)
    items, _ = sample_cli.render_inputs(pairs, True, "cpu", steps, every,
                                        regrasp)
    batched = np.stack([it["trace"] for it in items])
    assert batched.shape == (2, 40, 9) and np.isfinite(batched).all()
    assert np.abs(np.linalg.norm(batched[..., 3:7], axis=-1) - 1).max() < 1e-4
    assert np.abs(batched[:, -1, 7:] - batched[:, 0, 7:]).max() > 1e-2
    pose = torch.tensor([0.0, 0.0, 0.7])
    alone = np.stack([engine3d.rollout_trace3d(
        engine3d.make_scene(p["y"][:21], p["y"][21:], verts, faces), pose,
        steps=800, every=20).numpy() for p in pairs])
    _close(batched, alone, [3, 4, 5, 6], [0, 1, 2, 7, 8])
    assert items[0]["points"].shape == (192, 3)


@pytest.mark.parametrize("package", ["matplotlib", "imageio"])
def test_render_video_needs_writers(tmp_path, package):
    calls = []
    with mock.patch.dict(sys.modules, {package: None}), \
            mock.patch.object(sample_cli.convert, "load_model",
                              side_effect=lambda *a, **k: calls.append(a)), \
            mock.patch.object(sample_cli.generator, "sample_trajectory",
                              side_effect=lambda *a, **k: calls.append(a)):
        with pytest.raises(ImportError, match=package):
            sample_cli.main(["--render_video", "--save_dir",
                             str(tmp_path / "out"), "--device", "cpu"])
    assert not calls
    assert not os.path.exists(tmp_path / "out")
