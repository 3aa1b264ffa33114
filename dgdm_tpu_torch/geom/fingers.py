"""Procedural 2D gripper sampling — 2D parts of ``dgdm_tpu/geom/fingers.py``.

The reference regenerates its diffusion training set from
``np.random.RandomState(idx)`` seeds (``generator/train.py:42-58``) and uses
the same seeds during datagen (``sim/sim_2d.py:74-77``): the seed IS the
dataset, so ``sample_gripper_2d`` stays bit-exact numpy MT19937.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dgdm_tpu_torch.core.config import GRIPPER_2D, GRIPPER_3D


def ctrl_x_2d() -> np.ndarray:
    g = GRIPPER_2D
    return np.linspace(g.ctrl_x_min, g.ctrl_x_max, g.num_ctrl)


def sample_gripper_2d(idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """(yl, yr) each (7,) — parity with sim/sim_2d.py:74-77."""
    g = GRIPPER_2D
    rs = np.random.RandomState(idx)
    yl = rs.uniform(g.ctrl_y_min, g.ctrl_y_max, size=(g.num_ctrl,))
    yr = rs.uniform(g.ctrl_y_min, g.ctrl_y_max, size=(g.num_ctrl,))
    return yl, yr


def ctrlpts_2d(yl: np.ndarray, yr: np.ndarray) -> np.ndarray:
    """(14, 2) control point array matching assets/finger_sampler.py:38-50."""
    x = ctrl_x_2d()
    return np.concatenate(
        [np.stack([x, yl], -1), np.stack([x, yr], -1)], axis=0
    )


# -- normalization (dynamics/dataloader.py:46-49, generator/dataloader.py:17-19)
# Plain arithmetic: works on numpy arrays and torch tensors alike.


def normalize_y(y, fingers_3d: bool = False):
    g = GRIPPER_3D if fingers_3d else GRIPPER_2D
    return (y - g.ctrl_y_min) / (g.ctrl_y_max - g.ctrl_y_min) * 2.0 - 1.0


def denormalize_y(y, fingers_3d: bool = False):
    g = GRIPPER_3D if fingers_3d else GRIPPER_2D
    return (y + 1.0) / 2.0 * (g.ctrl_y_max - g.ctrl_y_min) + g.ctrl_y_min
