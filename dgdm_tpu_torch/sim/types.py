"""Scene containers — port of ``dgdm_tpu/sim/types.py`` (2D part).

One ``Scene2D`` holds everything static about an object x gripper pair as
dense tensors; a batch of pairs is the same dataclass with a leading
dimension (``datagen.stack_scenes``). A plain dataclass of tensors takes the
place of the JAX package's ``flax.struct`` pytree.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Scene2D:
    """Static description of one object x 2D-gripper pair."""

    coef_l: torch.Tensor        # (6, 4) cubic segment coefs, left finger curve
    coef_r: torch.Tensor        # (6, 4) right finger curve
    contour: torch.Tensor       # (P, 2) object boundary, body frame, CCW
    com: torch.Tensor           # (2,) object centroid in body frame
    mass: torch.Tensor          # () object mass (incl. MuJoCo double-count)
    inertia: torch.Tensor       # () polar inertia about the COM
    support_pts: torch.Tensor   # (S, 2) plane-contact support points, body frame
    support_w: torch.Tensor     # (S,) weights, sum to 1 over the interior
    finger_mass: torch.Tensor   # (2,) per-jaw mass (left, right)
    anchor: torch.Tensor        # (P,) or (1,) per-vertex crack-fan anchor
                                # weights; (1,) of 1.0 = uniform
