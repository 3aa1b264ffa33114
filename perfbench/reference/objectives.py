"""Task objectives for guided sampling — port of
``dgdm_tpu/design/objectives.py`` (``SIMPLE_OBJECTIVES``,
``deltas_to_objective``, ``convergence_centers``).

Sign conventions (``dynamics/metrics.py``): clockwise = negative
delta_theta; up = negative delta_x; left = negative delta_y. The objective
lambdas index the last axis, so they work on numpy arrays and tensors alike.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

SIMPLE_OBJECTIVES = {
    "rotate": lambda d: d[..., 0] ** 2,
    "rotate_clockwise": lambda d: -d[..., 0],
    "rotate_counterclockwise": lambda d: d[..., 0],
    "shift_up": lambda d: -d[..., 1],
    "shift_down": lambda d: d[..., 1],
    "shift_left": lambda d: -d[..., 2],
    "shift_right": lambda d: d[..., 2],
    "clockwise_up": lambda d: -d[..., 0] - d[..., 1],
    "clockwise_down": lambda d: -d[..., 0] + d[..., 1],
    "clockwise_left": lambda d: -d[..., 0] - d[..., 2],
    "clockwise_right": lambda d: -d[..., 0] + d[..., 2],
    "counterclockwise_up": lambda d: d[..., 0] - d[..., 1],
    "counterclockwise_down": lambda d: d[..., 0] + d[..., 1],
    "counterclockwise_left": lambda d: d[..., 0] - d[..., 2],
    "counterclockwise_right": lambda d: d[..., 0] + d[..., 2],
}


def deltas_to_objective(
    deltas: torch.Tensor,
    objective: str,
    grid_size: Optional[int] = None,
    centers: Optional[Union[torch.Tensor, Sequence[int]]] = None,
    num_pos: int = 1,
) -> torch.Tensor:
    """deltas: (..., 3) predicted whitened profile entries -> the per-row
    objective, on the tensor's own device (``dgdm_tpu.design.objectives.
    deltas_to_objective``).

    For 'convergence', deltas must reshape to (B, grid_size, num_pos^2, 3)
    and ``centers`` (B,), a tensor or a sequence, gives each sample's
    convergence orientation index; component 0 is signed by the circular
    offset ``(idx - center + G//2) % G - G//2`` of each orientation: +1
    left of the center (offset < 0, should rotate ccw), -1 elsewhere, the
    center included. Returns (B, grid_size * num_pos^2). A missing
    ``centers`` or ``grid_size`` raises ``ValueError`` (the JAX function
    asserts; an assert vanishes under ``python -O``)."""
    if objective != "convergence":
        return SIMPLE_OBJECTIVES[objective](deltas)
    if centers is None or grid_size is None:
        raise ValueError("objective 'convergence' needs grid_size and "
                         "centers")
    b = deltas.shape[0]
    d = deltas.reshape(b, grid_size, -1, 3)[..., 0]                # (B, G, P)
    centers = torch.as_tensor(centers, device=deltas.device)
    idx = torch.arange(grid_size, device=deltas.device)[None, :]   # (1, G)
    off = (idx - centers[:, None] + grid_size // 2) % grid_size \
        - grid_size // 2
    sign = torch.where(off < 0, 1.0, -1.0).to(d.dtype)
    return (sign[..., None] * d).reshape(b, -1)


def convergence_centers(profile_cls: torch.Tensor,
                        grid_size: int) -> torch.Tensor:
    """Centers of the longest ccw->cw transition runs.

    profile_cls: (B, G) in {0 (cw), 1 (none), 2 (ccw)} over orientations.
    Each orientation c is scored by the number of orientations whose class
    sign agrees with "ccw left of c, cw right of c"; the argmax (first on
    ties) is the center."""
    g = grid_size
    dev = profile_cls.device
    signs = torch.where(
        profile_cls == 2, 1.0, torch.where(profile_cls == 0, -1.0, 0.0))
    idx = torch.arange(g, device=dev)
    cands = torch.arange(g, device=dev)
    off = (idx[None, :] - cands[:, None] + g // 2) % g - g // 2     # (C, G)
    want = torch.where(off < 0, 1.0, torch.where(off > 0, -1.0, 0.0))
    scores = ((signs[:, None, :] * want[None]) > 0).sum(-1)          # (B, C)
    return torch.argmax(scores, dim=-1)
