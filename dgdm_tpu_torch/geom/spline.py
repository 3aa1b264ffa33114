"""Not-a-knot cubic spline as linear algebra — 2D parts of
``dgdm_tpu/geom/spline.py``.

The finger curve (reference ``assets/finger_sampler.py:7-50``, scipy
``CubicSpline`` with not-a-knot ends) is linear in its control values, so
dense sampling is a basis matrix and per-query evaluation is a segment
lookup + Horner polynomial. Operators are built once in float64 numpy;
``CubicSpline1D`` evaluates them with torch. The 3D B-spline surface waits
for the 3D slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_moment_operator(n: int) -> np.ndarray:
    """Return M (n, n) mapping values y -> second derivatives at the knots for
    a not-a-knot cubic spline on a uniform grid with unit spacing."""
    a = np.zeros((n, n))
    b = np.zeros((n, n))
    # interior continuity of first derivative:
    #   m[i-1] + 4 m[i] + m[i+1] = 6 (y[i-1] - 2 y[i] + y[i+1])
    for i in range(1, n - 1):
        a[i, i - 1 : i + 2] = (1.0, 4.0, 1.0)
        b[i, i - 1 : i + 2] = (6.0, -12.0, 6.0)
    # not-a-knot: third derivative continuous across the 2nd and (n-1)th knot
    a[0, 0:3] = (1.0, -2.0, 1.0)
    a[-1, -3:] = (1.0, -2.0, 1.0)
    return np.linalg.solve(a, b)


def cubic_coef_operator(n: int, x0: float, x1: float) -> np.ndarray:
    """Operator C of shape (n-1, 4, n): per-segment cubic coefficients
    (value, d1, d2, d3 in the local variable t = x - x_seg) as a linear map of
    the n knot values. ``poly(t) = c0 + c1 t + c2 t^2 + c3 t^3``."""
    h = (x1 - x0) / (n - 1)
    m = _cubic_moment_operator(n) / h**2          # moments per unit y
    eye = np.eye(n)
    c = np.zeros((n - 1, 4, n))
    for i in range(n - 1):
        yi, yi1 = eye[i], eye[i + 1]
        mi, mi1 = m[i], m[i + 1]
        c[i, 0] = yi
        c[i, 1] = (yi1 - yi) / h - h * (2.0 * mi + mi1) / 6.0
        c[i, 2] = mi / 2.0
        c[i, 3] = (mi1 - mi) / (6.0 * h)
    return c


def cubic_basis_matrix(n: int, x0: float, x1: float, xq: np.ndarray) -> np.ndarray:
    """Dense basis B (len(xq), n) with curve(xq) = B @ y."""
    c = cubic_coef_operator(n, x0, x1)            # (n-1, 4, n)
    h = (x1 - x0) / (n - 1)
    seg = np.clip(((xq - x0) / h).astype(np.int64), 0, n - 2)
    t = xq - (x0 + seg * h)
    powers = np.stack([np.ones_like(t), t, t * t, t**3], axis=-1)  # (q, 4)
    return np.einsum("qk,qkn->qn", powers, c[seg])


class CubicSpline1D:
    """Not-a-knot cubic spline on a fixed uniform grid, evaluated in torch.

    Control values may carry arbitrary leading batch dims: ``coefs`` maps
    ``y (..., n) -> (..., n-1, 4)``.
    """

    def __init__(self, n: int, x0: float, x1: float):
        self.n, self.x0, self.x1 = n, x0, x1
        self.h = (x1 - x0) / (n - 1)
        self._coef_op = torch.as_tensor(
            cubic_coef_operator(n, x0, x1), dtype=torch.float32
        )  # (n-1, 4, n)

    def coefs(self, y: torch.Tensor) -> torch.Tensor:
        op = self._coef_op.to(y.device)
        return torch.einsum("skn,...n->...sk", op, y)

    def _local(self, coefs: torch.Tensor, x: torch.Tensor):
        """Per-query segment coefficients. coefs: B + (n-1, 4); x: B + (Q,)."""
        scalar = x.ndim == coefs.ndim - 2
        if scalar:
            x = x[..., None]
        seg = torch.clamp(((x - self.x0) / self.h).to(torch.int32), 0,
                          self.n - 2)
        t = x - (self.x0 + seg.to(x.dtype) * self.h)
        idx = seg.long()[..., None].expand(*seg.shape, 4)
        c = torch.gather(coefs, -2, idx)                  # B + (Q, 4)
        return c, t, scalar

    def evaluate(self, coefs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """coefs: B + (n-1, 4); x: B + (Q,) (or B-shaped scalar) -> values."""
        c, t, scalar = self._local(coefs, x)
        out = ((c[..., 3] * t + c[..., 2]) * t + c[..., 1]) * t + c[..., 0]
        return out[..., 0] if scalar else out

    def evaluate_with_derivative(self, coefs: torch.Tensor, x: torch.Tensor):
        """(value, derivative) sharing one coefficient selection."""
        c, t, scalar = self._local(coefs, x)
        val = ((c[..., 3] * t + c[..., 2]) * t + c[..., 1]) * t + c[..., 0]
        der = (3.0 * c[..., 3] * t + 2.0 * c[..., 2]) * t + c[..., 1]
        if scalar:
            return val[..., 0], der[..., 0]
        return val, der

    def basis(self, xq: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(
            cubic_basis_matrix(self.n, self.x0, self.x1, np.asarray(xq)),
            dtype=torch.float32,
        )


@functools.lru_cache(maxsize=None)
def gripper2d_spline() -> CubicSpline1D:
    from dgdm_tpu_torch.core.config import GRIPPER_2D as g

    return CubicSpline1D(g.num_ctrl, g.ctrl_x_min, g.ctrl_x_max)
