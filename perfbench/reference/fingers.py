"""Procedural gripper sampling — port of ``dgdm_tpu/geom/fingers.py``.

The reference regenerates its diffusion training set from
``np.random.RandomState(idx)`` seeds (``generator/train.py:42-58``) and uses
the same seeds during datagen (``sim/sim_2d.py:74-77``,
``sim/sim_3d.py:73-75``): the seed IS the dataset, so ``sample_gripper_2d``
and ``sample_gripper_3d`` stay bit-exact numpy MT19937. ``fast_sample_y``
draws on the device from a ``torch.Generator`` for throughput workloads;
its stream is torch's, not JAX's PRNG nor MT19937.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from perfbench.reference.config import GRIPPER_2D, GRIPPER_3D


def sample_gripper_2d(idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """(yl, yr) each (7,) — parity with sim/sim_2d.py:74-77."""
    g = GRIPPER_2D
    rs = np.random.RandomState(idx)
    yl = rs.uniform(g.ctrl_y_min, g.ctrl_y_max, size=(g.num_ctrl,))
    yr = rs.uniform(g.ctrl_y_min, g.ctrl_y_max, size=(g.num_ctrl,))
    return yl, yr


def sample_gripper_3d(idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """(yl, yr) each (21,) — parity with sim/sim_3d.py:73-75."""
    g = GRIPPER_3D
    rs = np.random.RandomState(idx)
    yl = rs.uniform(g.ctrl_y_min, g.ctrl_y_max, size=(g.num_ctrl,))
    yr = rs.uniform(g.ctrl_y_min, g.ctrl_y_max, size=(g.num_ctrl,))
    return yl, yr


def fast_sample_y(generator: torch.Generator, count: int,
                  fingers_3d: bool = False, device="cuda") -> torch.Tensor:
    """On-device batch sampler: (count, 2, n_ctrl) float32 uniform in the
    ctrl-y range, from ``generator`` (which lives on ``device``)."""
    g = GRIPPER_3D if fingers_3d else GRIPPER_2D
    u = torch.rand((count, 2, g.num_ctrl), generator=generator,
                   dtype=torch.float32, device=device)
    return g.ctrl_y_min + u * (g.ctrl_y_max - g.ctrl_y_min)


# -- normalization (dynamics/dataloader.py:46-49, generator/dataloader.py:17-19)
# Plain arithmetic: works on numpy arrays and torch tensors alike.


def denormalize_y(y, fingers_3d: bool = False):
    g = GRIPPER_3D if fingers_3d else GRIPPER_2D
    return (y + 1.0) / 2.0 * (g.ctrl_y_max - g.ctrl_y_min) + g.ctrl_y_min
