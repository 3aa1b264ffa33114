"""Scene and state containers — port of ``dgdm_tpu/sim/types.py``
(``Scene2D``, ``State2D``, ``Scene3D``, ``State3D``).

One scene holds everything static about an object x gripper pair as dense
tensors; a batch of pairs is the same dataclass with a leading dimension
(``datagen.stack_scenes``). A plain dataclass of tensors takes the place of
the JAX package's ``flax.struct`` pytree; ``State2D`` and ``State3D``
likewise carry any leading batch shape (pairs x poses in the pure engines)
in front of the per-rollout shapes noted beside their fields.

``Scene3D.hgrid`` is the fingers' baked height grid, which only the pure 3D
engine reads: ``engine3d.make_scene`` leaves it ``None`` (the rollout
kernel's paths never pay for the bake) and the pure engine's entry points
fill it from a per-gripper LRU on first use (``engine3d.with_hgrid``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def to_device(obj, device):
    """A scene or state dataclass with every tensor moved to ``device``
    (fields that are None stay None)."""
    return type(obj)(**{
        f.name: None if getattr(obj, f.name) is None
        else getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)})


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


@dataclasses.dataclass
class State2D:
    """State of one planar rollout (fields carry a leading batch shape)."""

    com: torch.Tensor           # (2,) object COM, world frame
    theta: torch.Tensor         # () orientation (continuous, unwrapped)
    vel: torch.Tensor           # (2,) COM velocity
    om: torch.Tensor            # () angular velocity
    zb: torch.Tensor            # () object bottom-face height
    vz: torch.Tensor            # () vertical velocity
    q: torch.Tensor             # (2,) finger slide positions (left, right)
    qd: torch.Tensor            # (2,) finger velocities


@dataclasses.dataclass
class Scene3D:
    """Static description of one object x 3D-gripper pair."""

    yl: torch.Tensor            # (7, 3) left finger surface ctrl y values
    yr: torch.Tensor            # (7, 3) right finger
    points: torch.Tensor        # (P, 3) object surface samples, body frame
    com: torch.Tensor           # (3,) centre of mass, body frame
    mass: torch.Tensor          # () object mass (incl. MuJoCo double-count)
    inertia: torch.Tensor       # (3, 3) inertia about the COM
    inv_inertia: torch.Tensor   # (3, 3)
    bottom_pts: torch.Tensor    # (S, 3) base support points (unused: the
                                # plane contact uses all surface points)
    bottom_w: torch.Tensor      # (P,) footprint-corner plane support weights
    finger_mass: torch.Tensor   # (2,) per-jaw mass (left, right)
    hgrid: Optional[torch.Tensor] = None
                                # (2, H, W, 3): [height, dh/dx, dh/dz] per
                                # finger on the (x, z) lattice, or None


@dataclasses.dataclass
class State3D:
    """State of one 3D rollout (fields carry a leading batch shape)."""

    pos: torch.Tensor           # (3,) COM position, world frame
    quat: torch.Tensor          # (4,) body -> world rotation (w, x, y, z)
    vel: torch.Tensor           # (3,) COM velocity
    om: torch.Tensor            # (3,) angular velocity, world frame
    q: torch.Tensor             # (2,) finger slide positions (left, right)
    qd: torch.Tensor            # (2,) finger velocities
