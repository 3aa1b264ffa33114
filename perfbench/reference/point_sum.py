"""The point sum of the rollout kernels' plain versions (no JAX counterpart:
the Pallas kernels sum in float32 on the TPU's vector unit).

Every sum over contour, support or surface points of ``rollout2d_ref`` and
``rollout3d_ref`` goes through ``point_sum``: accumulated in float64, rounded
once to float32. ``group`` selects the order of the additions:

- ``group == 0``: ``torch.sum`` in float64, in the library's own order;
- ``group == G >= 1``: the order of the CUDA kernels with G threads a
  rollout (``csrc/rollout_common.cuh``): lane r adds the points p = r, r + G,
  ... in increasing p onto 0.0, then the G partial sums are added by an xor
  butterfly with strides G/2, ..., 1. Floating-point addition commutes, so
  every lane of the butterfly ends with the value of the halving tree that
  is computed here. G = 1 is the plain sequential sum.

float32 terms summed in float64 are exact while their exponents span fewer
than ~29 bits, and then every order gives the same float32; the grouped
orders exist to reproduce the kernels bit for bit where that does not hold.
"""

from __future__ import annotations

import torch


# ``group`` of the benchmark's control: the sum accumulated in float32, the
# precision below the float64 that the configuration states for point sums
FLOAT32_SUM = -1


def point_sum(x: torch.Tensor, dim: int, group: int = 0) -> torch.Tensor:
    """Sum of float32 ``x`` over ``dim`` -> float32 without that dim
    (``group == FLOAT32_SUM``: accumulated in float32, the control)."""
    if group == FLOAT32_SUM:
        return torch.sum(x, dim=dim)
    return point_sum64(x, dim, group).to(torch.float32)


def point_sum64(x: torch.Tensor, dim: int, group: int = 0) -> torch.Tensor:
    """The float64 total of ``point_sum`` before its one rounding."""
    if group <= 0:
        return torch.sum(x, dim=dim, dtype=torch.float64)
    if group & (group - 1):
        raise ValueError(f"group must be a power of two, got {group}")
    x = x.movedim(dim, 0)
    p = x.shape[0]
    if group == 1 and x.device.type == "cpu":
        # the same sequential order in one call: on the CPU ``cumsum`` adds
        # along the dim one element after the other, onto the leading 0.0
        zero = torch.zeros((1,) + tuple(x.shape[1:]), dtype=torch.float64)
        return torch.cumsum(torch.cat([zero, x.double()]), dim=0)[-1]
    acc = torch.zeros((group,) + tuple(x.shape[1:]), dtype=torch.float64,
                      device=x.device)
    for start in range(0, p, group):
        # a last chunk shorter than the group leaves the upper lanes as
        # they are: those lanes have no point in this round
        chunk = x[start:start + group]
        acc[:chunk.shape[0]] += chunk
    half = group // 2
    while half >= 1:
        acc = acc[:half] + acc[half:2 * half]
        half //= 2
    return acc[0]
