"""Visualization — port of ``dgdm_tpu/eval/viz.py`` (the reference's
plotting and rendering).

- ``visualize_profile`` / ``visualize_ctrlpts`` / ``visualize_denoise_steps``
  / ``visualize_finals``: the matplotlib plots of ``dynamics/utils.py:20-80``
  and the per-step denoise dumps of ``generator/diffusion.py:258-292``.
- ``render_gripper_2d`` / ``render_object_silhouette``: the analytic
  rasterization that replaces the MuJoCo offscreen renderer
  (``sim/render_mesh.py:23-65``).
- ``rollout_video_2d`` / ``rollout_video_3d`` / ``render_scene_3d``: squeeze
  videos and scene renders fed by ``engine2d.rollout_trace`` and
  ``engine3d.rollout_trace3d``.

The pure parts are split out from the writers so that a host without
matplotlib or imageio can run them: ``rollout_frames_2d`` returns the uint8
frames that ``rollout_video_2d`` hands to imageio, and ``scene_points_3d``
the world-frame point sets that ``render_scene_3d`` scatters. matplotlib
(Agg) and imageio are imported only inside the writers.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np

from dgdm_tpu_torch.core.config import GRIPPER_2D, GRIPPER_3D
from dgdm_tpu_torch.geom.envelope3d import _surface_grid
from dgdm_tpu_torch.geom.spline import cubic_basis_matrix

# background, object, left finger, right finger (indexed by the segment id)
FRAME_COLORS = np.array(
    [[255, 247, 212], [155, 184, 205], [238, 199, 89], [177, 195, 129]],
    dtype=np.uint8,
)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def visualize_profile(profile: np.ndarray, save_path: str,
                      ori_range=(-1.0, 1.0)) -> None:
    """Polar quiver of a signed 3-class profile (dynamics/utils.py:29-44)."""
    plt = _pyplot()
    signs = np.sign(profile)
    thetas = np.linspace(
        ori_range[0] * np.pi + np.pi, ori_range[1] * np.pi + np.pi, len(profile)
    )
    theta, r = np.meshgrid(thetas, np.array([1]))
    u = -2 * np.pi / len(profile) * np.sin(theta) * signs
    v = 2 * np.pi / len(profile) * np.cos(theta) * signs
    f = plt.figure(figsize=(8, 8))
    ax = f.add_subplot(polar=True)
    ax.quiver(theta, r, u, v, profile, scale=1, width=0.005, cmap="bwr")
    plt.savefig(save_path)
    plt.close(f)


def visualize_ctrlpts(ctrlpts: np.ndarray, save_path: str) -> None:
    """Two-panel control-point scatter (dynamics/utils.py:70-80)."""
    plt = _pyplot()
    n = ctrlpts.shape[0] // 2
    f = plt.figure()
    for i, sl in enumerate((slice(0, n), slice(n, 2 * n))):
        ax = f.add_subplot(2, 1, i + 1)
        ax.set(xlim=(-0.12, 0.12), ylim=(-0.045, 0.015))
        ax.scatter(ctrlpts[sl, 0], ctrlpts[sl, 1])
    plt.savefig(save_path)
    plt.close(f)


def visualize_denoise_steps(traj: np.ndarray, save_path: str) -> None:
    """One panel per DDIM step: scatter of every sample's normalized control
    values vs control index (generator/diffusion.py:258-292). ``traj`` is
    (S+1, B, N) or (S+1, B, N, 1) from ``train/generator.sample_trajectory``
    (index 0 = pure noise)."""
    plt = _pyplot()
    traj = np.asarray(traj)
    if traj.ndim == 4:
        traj = traj[..., 0]
    s, b, n = traj.shape
    f, axes = plt.subplots(1, s, figsize=(2.2 * s, 2.6), sharey=True)
    if s == 1:
        axes = [axes]
    x = np.arange(n)
    for si, ax in enumerate(axes):
        for bi in range(b):
            ax.scatter(x, traj[si, bi], s=4, alpha=0.5)
        ax.set_ylim(-1.6, 1.6)
        ax.set_title("noise" if si == 0 else f"step {si}", fontsize=8)
    f.tight_layout()
    f.savefig(save_path, dpi=90)
    plt.close(f)


def visualize_finals(finals: np.ndarray, save_path: str) -> None:
    plt = _pyplot()
    f = plt.figure(figsize=(10, 6))
    ax = f.add_subplot(111)
    ax.set(ylim=(0, 2 * np.pi))
    ax.scatter(np.arange(len(finals)), np.asarray(finals) * np.pi / 180.0, s=2)
    plt.savefig(save_path)
    plt.close(f)


def _grid_in_polygon(xs: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """``points_in_polygon`` over the square pixel grid of centres ``xs``
    (row i at y = xs[i], column j at x = xs[j]), bit for bit: every pixel of
    a row shares its crossing abscissae, which are computed once a row with
    the same expression, so that a frame compares instead of dividing at
    each of its pixels."""
    y = xs[:, None]                                       # (S, 1)
    vx, vy = poly[None, :, 0], poly[None, :, 1]           # (1, N)
    vx1, vy1 = np.roll(poly[:, 0], -1)[None], np.roll(poly[:, 1], -1)[None]
    cond = (vy > y) != (vy1 > y)                          # (S, N)
    denom = np.where(vy1 - vy == 0.0, 1.0, vy1 - vy)
    xint = vx + (y - vy) / denom * (vx1 - vx)
    crossings = np.sum(
        cond[:, None, :] & (xs[None, :, None] < xint[:, None, :]), axis=2)
    return (crossings % 2) == 1


def _raster_polygon(poly: np.ndarray, size: int = 128,
                    extent: float = 0.2) -> np.ndarray:
    """Rasterize a polygon to a boolean (size, size) mask over
    [-extent/2, extent/2]^2 (world meters, y up)."""
    xs = (np.arange(size) + 0.5) / size * extent - extent / 2
    return _grid_in_polygon(xs, poly)


def render_object_silhouette(
    contour: np.ndarray, theta: float, size: int = 128, extent: float = 0.2
) -> np.ndarray:
    """Segmentation-style object mask at orientation theta — the analytic
    version of sim/render_mesh.py:39-65."""
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    return _raster_polygon(contour @ rot.T, size, extent)


def _finger_curves(yl: np.ndarray, yr: np.ndarray, num: int = 200):
    g = GRIPPER_2D
    xq = np.linspace(g.ctrl_x_min, g.ctrl_x_max, num)
    basis = np.asarray(
        cubic_basis_matrix(g.num_ctrl, g.ctrl_x_min, g.ctrl_x_max, xq)
    )
    return xq, basis @ np.asarray(yl), basis @ np.asarray(yr)


def render_gripper_2d(
    yl: np.ndarray, yr: np.ndarray, save_path: Optional[str] = None,
    size: int = 256,
):
    """Gripper portrait (replaces sim/render_mesh.py:23-37): both finger
    strips drawn at their jaw offsets. Returns ``save_path``, or the (H, W,
    3) uint8 image when no path is given."""
    plt = _pyplot()
    g = GRIPPER_2D
    xq, cl, cr = _finger_curves(yl, yr)
    f = plt.figure(figsize=(size / 100, size / 100), dpi=100)
    ax = f.add_subplot(111)
    ax.fill_between(xq, cl - g.jaw_offset, cl - g.jaw_offset + g.width,
                    color="#EEC759")
    ax.fill_between(xq, cr + g.jaw_offset, cr + g.jaw_offset + g.width,
                    color="#B1C381")
    ax.set(xlim=(-0.15, 0.15), ylim=(-0.25, 0.25))
    ax.set_aspect("equal")
    ax.axis("off")
    if save_path:
        plt.savefig(save_path, bbox_inches="tight")
        plt.close(f)
        return save_path
    f.canvas.draw()
    img = np.asarray(f.canvas.buffer_rgba())[..., :3].copy()
    plt.close(f)
    return img


def rollout_frames_2d(
    contour: np.ndarray,
    yl: np.ndarray,
    yr: np.ndarray,
    traj: Sequence,  # iterable of (obj_x, obj_y, theta, ql, qr)
    size: int = 128,
    extent: float = 0.5,
    stride: int = 10,
) -> np.ndarray:
    """The squeeze's frames, (F, size, size, 3) uint8, F = ceil(len(traj) /
    stride): object polygon and both finger bands rasterized over
    [-extent/2, extent/2]^2 in ``FRAME_COLORS``, y flipped to image rows."""
    g = GRIPPER_2D
    xq, cl, cr = _finger_curves(yl, yr, 64)
    xs = (np.arange(size) + 0.5) / size * extent - extent / 2
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    in_x = (gx >= g.ctrl_x_min) & (gx <= g.ctrl_x_max)
    frames = []
    for frame in list(traj)[::stride]:
        ox, oy, th, ql, qr = frame
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, -s], [s, c]])
        poly = contour @ rot.T + [ox, oy]
        seg = np.zeros((size, size), dtype=np.int64)
        seg[_grid_in_polygon(xs, poly)] = 1
        # finger bands
        yl_low = np.interp(gx, xq, cl) - g.jaw_offset + ql
        yr_low = np.interp(gx, xq, cr) + g.jaw_offset + qr
        seg[(gy >= yl_low) & (gy <= yl_low + g.width) & in_x] = 2
        seg[(gy >= yr_low) & (gy <= yr_low + g.width) & in_x] = 3
        frames.append(FRAME_COLORS[seg[::-1]])  # flip y for image coords
    return np.stack(frames) if frames else np.zeros((0, size, size, 3),
                                                    np.uint8)


def write_video(frames: np.ndarray, save_path: str, fps: int = 20) -> str:
    """Write uint8 frames with imageio; without an mp4 backend the video
    goes to a GIF beside ``save_path``. Returns the path written."""
    import imageio

    try:
        writer = imageio.get_writer(save_path, fps=fps)
    except ValueError:
        # no mp4 backend in this environment: fall back to GIF
        save_path = save_path.rsplit(".", 1)[0] + ".gif"
        writer = imageio.get_writer(save_path, fps=fps)
    with writer as w:
        for frame in frames:
            w.append_data(frame)
    return save_path


def rollout_video_2d(
    contour: np.ndarray,
    yl: np.ndarray,
    yr: np.ndarray,
    traj: Sequence,  # iterable of (obj_x, obj_y, theta, ql, qr)
    save_path: str,
    size: int = 128,
    extent: float = 0.5,
    fps: int = 20,
    stride: int = 10,
) -> str:
    """Squeeze video (replaces the segmentation-render mp4 path of
    dynamics/sim_test_mj.py:219-233); GIF without an mp4 backend."""
    return write_video(
        rollout_frames_2d(contour, yl, yr, traj, size, extent, stride),
        save_path, fps)


def _finger_surface_grid(y_ctrl: np.ndarray, n: int = 25) -> np.ndarray:
    """(n*n, 3) points on one finger's B-spline surface (body frame)."""
    return _surface_grid(np.asarray(y_ctrl).reshape(-1), n).reshape(-1, 3)


def scene_points_3d(obj_points: np.ndarray, com: np.ndarray, yl: np.ndarray,
                    yr: np.ndarray, state_row: np.ndarray):
    """World-frame point sets of one 3D state ``state_row`` (9,) = pos (3),
    quat wxyz (4), q (2): (object (P, 3), left finger (625, 3), right finger
    (625, 3)), the sets ``render_scene_3d`` scatters."""
    g = GRIPPER_3D
    pos, quat, q = state_row[:3], state_row[3:7], state_row[7:9]
    w, x, y, z = quat
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    obj_w = pos + (np.asarray(obj_points) - np.asarray(com)) @ rot.T
    fl_w = _finger_surface_grid(yl) + [0.0, -g.jaw_offset + g.width + q[0],
                                       0.0]
    fr_w = _finger_surface_grid(yr) + [0.0, g.jaw_offset + q[1], 0.0]
    return obj_w, fl_w, fr_w


def render_scene_3d(
    obj_points: np.ndarray,      # (P, 3) object surface points, body frame
    com: np.ndarray,             # (3,) body COM
    yl: np.ndarray,
    yr: np.ndarray,
    state_row: np.ndarray,       # (9,): pos(3), quat wxyz(4), q(2)
    save_path: str,
    elev: float = 25.0,
    azim: float = -60.0,
) -> str:
    """Matplotlib-3D point-splat of the gripper + object at one state — the
    analytic replacement for the reference's offscreen MuJoCo RGB render
    (sim/render_mesh.py:23-65, dynamics/sim_test_mj_3d.py render path)."""
    obj_w, fl_w, fr_w = scene_points_3d(obj_points, com, yl, yr, state_row)
    plt = _pyplot()
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(*obj_w.T, s=4, c="tab:orange", label="object")
    ax.scatter(*fl_w.T, s=2, c="tab:blue", alpha=0.6)
    ax.scatter(*fr_w.T, s=2, c="tab:green", alpha=0.6)
    ax.set_xlim(-0.15, 0.15)
    ax.set_ylim(-0.25, 0.25)
    ax.set_zlim(-0.02, 0.2)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((0.3, 0.5, 0.22))
    fig.savefig(save_path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return save_path


def rollout_video_3d(
    obj_points: np.ndarray,
    com: np.ndarray,
    yl: np.ndarray,
    yr: np.ndarray,
    traj: np.ndarray,            # (T, 9) from engine3d.rollout_trace3d
    save_path: str,
    fps: int = 10,
) -> str:
    """Frame sequence of a 3D squeeze: an mp4 when imageio has an mp4
    backend, else the final frame as ``<stem>_final.png``. Only a missing
    imageio or mp4 backend takes the still; any other fault raises."""
    frames = []
    with tempfile.TemporaryDirectory() as td:
        for i, row in enumerate(np.asarray(traj)):
            p = os.path.join(td, f"f{i:03d}.png")
            render_scene_3d(obj_points, com, yl, yr, row, p)
            frames.append(p)
        try:
            import imageio.v2 as imageio

            writer = imageio.get_writer(save_path, fps=fps)
        except (ImportError, ValueError):
            # fallback: keep the final frame as a still
            still = save_path.rsplit(".", 1)[0] + "_final.png"
            shutil.copy(frames[-1], still)
            return still
        with writer as w:
            for f in frames:
                w.append_data(imageio.imread(f))
        return save_path
