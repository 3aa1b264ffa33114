"""Single source of truth for every constant the reference scatters across files.

The reference duplicates normalization bounds, std/threshold tables and
guidance scales across at least three modules (see reference
``dynamics/dataloader.py:10-15``, ``generator/diffusion.py:30-33,116-117``,
``dynamics/sim_test_mj.py:27,261``, ``generator/train.py:59-66,94-124``).
Here they live in typed, frozen dataclasses consumed by every subsystem.

PyTorch port: a value-for-value copy of ``dgdm_tpu/core/config.py`` (the
port imports nothing of ``dgdm_tpu``; tests/test_torch_geom.py holds every
field equal).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


# ---------------------------------------------------------------------------
# Gripper geometry (reference: sim/sim_2d.py:74-77, sim/sim_3d.py:73-75,
# assets/finger_sampler.py, assets/finger_3d.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Gripper2DSpec:
    """Planar finger: cubic spline through 7 (x, y) control points, extruded."""

    num_ctrl: int = 7                  # control points per finger
    ctrl_x_min: float = -0.12
    ctrl_x_max: float = 0.12
    ctrl_y_min: float = -0.045        # sampling range for y (sim/sim_2d.py:76)
    ctrl_y_max: float = 0.015
    num_curve_points: int = 200        # dense samples per finger curve
    width: float = 0.03                # extrusion along +y
    height: float = 0.02               # extrusion along +z
    jaw_offset: float = 0.15           # |y| of jaw bodies (finger_sampler.py:126,135)
    ctrl_clamped: float = 0.1          # actuator ctrlrange magnitude
    kp: float = 10.0                   # position actuator gain
    joint_damping: float = 1.0

    @property
    def ctrlpts_dim(self) -> int:      # 2 fingers x 7 points
        return 2 * self.num_ctrl


@dataclasses.dataclass(frozen=True)
class Gripper3DSpec:
    """3D finger: B-spline surface (deg 3x2) over a 7x3 control grid, extruded.

    Reference: assets/finger_3d.py:13-98, sim/sim_3d.py:72-97.
    """

    nu: int = 7                        # ctrl grid size along x (u)
    nv: int = 3                        # ctrl grid size along z (v)
    degree_u: int = 3
    degree_v: int = 2
    ctrl_x_min: float = -0.12
    ctrl_x_max: float = 0.12
    ctrl_y_min: float = -0.1           # sampling range (sim/sim_3d.py:74-75)
    ctrl_y_max: float = 0.0
    ctrl_z_min: float = 0.0
    ctrl_z_max: float = 0.12
    sample_size: int = 25              # surface eval grid per axis
    width: float = 0.1                 # extrusion along +y (sim/sim_3d.py:81)
    jaw_offset: float = 0.23           # assets/finger_3d.py:126,135
    ctrl_clamped: float = 0.1
    kp: float = 10.0
    joint_damping: float = 1.0

    @property
    def num_ctrl(self) -> int:
        return self.nu * self.nv       # 21 per finger

    @property
    def ctrlpts_dim(self) -> int:
        return 2 * self.num_ctrl       # 42


# ---------------------------------------------------------------------------
# Object geometry (reference: assets/icon_process.py, assets/scan_object_process.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Object2DSpec:
    num_contour_points: int = 100      # resampled icon contour length
    extent: float = 0.05               # contour rescaled to [-0.05, 0.05]
    height: float = 0.02               # prism extrusion
    image_size: int = 128
    threshold: int = 240               # binarization threshold


@dataclasses.dataclass(frozen=True)
class Object3DSpec:
    num_surface_points: int = 512      # points sampled from mesh surface
    bbox_xy: float = 0.1               # filter: |x|,|y| < 0.1 (scan_object_process.py:42-56)
    bbox_z: float = 0.12


# ---------------------------------------------------------------------------
# Simulation (reference scene XML: assets/finger_sampler.py:154-177 and
# MuJoCo defaults for unset options)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimSpec:
    dt: float = 0.002                  # MuJoCo default timestep
    gravity: float = 9.81
    density: float = 1000.0            # MuJoCo default geom density
    # MuJoCo counts BOTH the visual mesh and the (overlapping) collision
    # decomposition toward body mass/inertia; the reference's bodies therefore
    # weigh ~2x the nominal solid. Calibrated against the mujoco oracle.
    mass_factor: float = 2.0
    friction_slide: float = 1.0        # condim=4 friction="1.0 0.005 0.0001"
    friction_torsion: float = 0.005
    plane_z: float = -0.01             # plane body pos (scene xml)
    # soft-constraint gains derived from MuJoCo default solref=(0.02, 1),
    # solimp=(0.9, 0.95, 0.001): k = d/(dmax^2 tc^2 dr^2), b = 2/(dmax tc)
    solref_timeconst: float = 0.02
    solimp_dmax: float = 0.95
    # datagen pose grid (sim/sim_2d.py:139-143)
    grid_size: int = 360               # z rotations over [0, 2pi)
    num_pos: int = 5                   # x and y offsets
    pos_extent: float = 0.03           # offsets in [-0.03, 0.03]
    steps_2d: int = 200                # rollout length (sim_2d.py:164)
    steps_3d: int = 800                # (sim_3d.py:151)
    ctrl_2d: float = 0.2               # requested ctrl, clamped to 0.1
    ctrl_3d: float = 0.5
    # evaluation re-grasp schedule (dynamics/sim_test_mj.py:161-171)
    eval_steps_2d: int = 8000
    eval_regrasp_2d: int = 200
    eval_steps_3d: int = 32000
    eval_regrasp_3d: int = 800
    tipover_atol: float = 1e-2         # sim_3d.py:159-161

    @property
    def contact_k(self) -> float:
        d = self.solimp_dmax
        return d / (d * d * self.solref_timeconst ** 2)

    @property
    def contact_b(self) -> float:
        return 2.0 / (self.solimp_dmax * self.solref_timeconst)


# ---------------------------------------------------------------------------
# Normalization / metric tables (dynamics/dataloader.py:10-15,
# generator/diffusion.py:116-117, dynamics/sim_test_mj.py:27)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NormSpec:
    # per-axis std of (delta_theta, delta_x, delta_y) used to whiten scores
    std_2d: Tuple[float, float, float] = (0.0565, 0.0026, 0.0047)
    std_3d: Tuple[float, float, float] = (0.0312, 0.0016, 0.0026)
    # 3-class thresholds in raw units (rad / m)
    threshold_2d: Tuple[float, float, float] = (0.03, 0.002, 0.003)
    threshold_3d: Tuple[float, float, float] = (0.02, 0.001, 0.001)
    # object point normalization bounds
    object_extent_2d: float = 0.05     # x,y in [-0.05, 0.05]
    object_extent_3d_xy: float = 0.1   # x,y in [-0.1, 0.1]
    object_z_min_3d: float = 0.0
    object_z_max_3d: float = 0.12
    # pose normalization: ori -> theta/pi - 1, pos -> pos/0.03
    pos_scale: float = 0.03

    def threshold_std(self, fingers_3d: bool) -> Tuple[float, float, float]:
        t = self.threshold_3d if fingers_3d else self.threshold_2d
        s = self.std_3d if fingers_3d else self.std_2d
        return tuple(ti / si for ti, si in zip(t, s))


# ---------------------------------------------------------------------------
# Diffusion / guidance (generator/train.py:80-83, generator/diffusion.py:30-33)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiffusionSpec:
    num_train_timesteps: int = 15
    num_inference_steps: int = 5
    beta_schedule: str = "squaredcos_cap_v2"
    clip_sample: bool = True
    prediction_type: str = "epsilon"
    down_dims: Tuple[int, ...] = (128, 256)
    diffusion_step_embed_dim: int = 32
    kernel_size: int = 5
    n_groups: int = 8
    ema_power: float = 0.85            # train scripts use 0.85
    ema_update_after_step: int = 0
    learning_rate: float = 1e-4


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    scale_2d: float = 0.001
    scale_2d_convergence: float = 10.0
    scale_3d: float = 0.5
    scale_3d_convergence: float = 0.8
    grid_size_2d: int = 360
    grid_size_3d: int = 45             # guided_sample_3d.sh
    num_pos: int = 5
    batch_size: int = 16

    def scale(self, fingers_3d: bool, objective: str) -> float:
        if objective == "convergence":
            return self.scale_3d_convergence if fingers_3d else self.scale_2d_convergence
        return self.scale_3d if fingers_3d else self.scale_2d


# The 12 objectives swept by guided sampling (generator/diffusion.py:307)
GUIDED_OBJECTIVES = (
    "convergence",
    "shift_up", "shift_down", "shift_left", "shift_right",
    "rotate_clockwise", "rotate_counterclockwise", "rotate",
    "clockwise_up", "clockwise_left",
    "counterclockwise_up", "counterclockwise_left",
)

# All objectives metric2objective supports (dynamics/metrics.py:67-234)
ALL_OBJECTIVES = GUIDED_OBJECTIVES + (
    "clockwise_down", "clockwise_right",
    "counterclockwise_down", "counterclockwise_right",
)

# Test-set object ids (generator/train.py:36)
ICON_TEST_OBJECT_IDS = (10000, 2009, 2114, 2082, 1041, 2048, 1045, 1019)


GRIPPER_2D = Gripper2DSpec()
GRIPPER_3D = Gripper3DSpec()
OBJECT_2D = Object2DSpec()
OBJECT_3D = Object3DSpec()
SIM = SimSpec()
NORM = NormSpec()
DIFFUSION = DiffusionSpec()
GUIDANCE = GuidanceSpec()


