"""Spline evaluation as linear algebra — port of ``dgdm_tpu/geom/spline.py``.

The finger curve (reference ``assets/finger_sampler.py:7-50``, scipy
``CubicSpline`` with not-a-knot ends) and the 3D finger surface (reference
``assets/finger_3d.py:13-67``, a geomdl B-spline surface of degree (3, 2)
with clamped uniform knots) are linear in their control values, so dense
sampling is a basis matrix and per-query evaluation is a segment lookup +
Horner polynomial. Operators are built once in float64 numpy;
``CubicSpline1D`` and ``BSplineSurfaceY`` evaluate them with torch in
float32, in the JAX package's order of operations.
"""

from __future__ import annotations

import functools
from typing import Tuple

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


# ---------------------------------------------------------------------------
# Clamped uniform B-spline basis (matches geomdl generate_knot_vector)
# ---------------------------------------------------------------------------


def clamped_knot_vector(degree: int, num_ctrl: int) -> np.ndarray:
    """Clamped, internally-uniform knot vector on [0, 1]."""
    interior = num_ctrl - degree - 1
    mids = (np.arange(1, interior + 1)) / (interior + 1)
    return np.concatenate(
        [np.zeros(degree + 1), mids, np.ones(degree + 1)]
    )


def bspline_basis(degree: int, knots: np.ndarray, num_ctrl: int,
                  u: np.ndarray) -> np.ndarray:
    """Cox-de Boor evaluation of all basis functions: (len(u), num_ctrl)."""
    u = np.asarray(u, dtype=np.float64)
    n = np.zeros((len(u), len(knots) - 1))
    for i in range(len(knots) - 1):
        n[:, i] = np.where((u >= knots[i]) & (u < knots[i + 1]), 1.0, 0.0)
    # right-end closure
    last = np.max(np.where(knots < knots[-1])[0])
    n[u >= knots[-1], last] = 1.0
    for d in range(1, degree + 1):
        new = np.zeros((len(u), len(knots) - 1 - d))
        for i in range(len(knots) - 1 - d):
            den1 = knots[i + d] - knots[i]
            den2 = knots[i + d + 1] - knots[i + 1]
            t1 = np.where(den1 > 0, (u - knots[i])
                          / np.where(den1 > 0, den1, 1.0), 0.0)
            t2 = np.where(den2 > 0, (knots[i + d + 1] - u)
                          / np.where(den2 > 0, den2, 1.0), 0.0)
            new[:, i] = t1 * n[:, i] + t2 * n[:, i + 1]
        n = new
    return n[:, :num_ctrl]


def _piecewise_poly_from_basis(
    degree: int, knots: np.ndarray, num_ctrl: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exactly convert the B-spline basis to per-segment polynomials.

    Returns (breaks (s+1,), P (s, degree+1, num_ctrl)) with
    ``N_i(u) = sum_k P[seg, k, i] * (u - breaks[seg])**k``.
    """
    breaks = np.unique(knots)
    segs = len(breaks) - 1
    p = np.zeros((segs, degree + 1, num_ctrl))
    for s in range(segs):
        lo, hi = breaks[s], breaks[s + 1]
        # degree+1 points strictly inside the segment determine the
        # degree-d polynomial exactly
        ts = lo + (hi - lo) * (np.arange(degree + 1) + 0.5) / (degree + 1)
        vals = bspline_basis(degree, knots, num_ctrl, ts)   # (d+1, n)
        vander = np.vander(ts - lo, degree + 1, increasing=True)
        p[s] = np.linalg.solve(vander, vals)
    return breaks, p


class BSplineSurfaceY:
    """B-spline surface y(u, v) over a fixed (x, z) control lattice.

    The 3D finger surface has control x = linspace(x0, x1, nu) and
    z = linspace(z0, z1, nv) fixed; only the nu * nv y values vary.

    - ``grid_basis``: (S*S, nu*nv) operator reproducing geomdl's evalpts grid,
    - ``height(y_ctrl, x, z)``: surface y at arbitrary (x, z) via
      precomputed u(x), v(z) inverse lookup tables,
    - ``slopes``: (dy/dx, dy/dz) for contact normals.
    """

    LUT_SIZE = 1024

    def __init__(self, nu: int, nv: int, degree_u: int, degree_v: int,
                 x0: float, x1: float, z0: float, z1: float):
        self.nu, self.nv = nu, nv
        self.x0, self.x1, self.z0, self.z1 = x0, x1, z0, z1
        ku = clamped_knot_vector(degree_u, nu)
        kv = clamped_knot_vector(degree_v, nv)
        self._breaks_u, pu = _piecewise_poly_from_basis(degree_u, ku, nu)
        self._breaks_v, pv = _piecewise_poly_from_basis(degree_v, kv, nv)
        f32 = functools.partial(torch.as_tensor, dtype=torch.float32)
        self._pu = f32(pu)                               # (su, du+1, nu)
        self._pv = f32(pv)                               # (sv, dv+1, nv)
        self._br_u = f32(self._breaks_u[:-1])
        self._br_v = f32(self._breaks_v[:-1])
        self.du, self.dv = degree_u, degree_v
        self._ku, self._kv = ku, kv

        # u(x), v(z) inverse LUTs. x(u) = sum_i N_i(u) * x_i is monotone.
        xs = np.linspace(x0, x1, nu)
        zs = np.linspace(z0, z1, nv)
        uu = np.linspace(0.0, 1.0, 200001)
        x_of_u = bspline_basis(degree_u, ku, nu, uu) @ xs
        z_of_v = bspline_basis(degree_v, kv, nv, uu) @ zs
        x_grid = np.linspace(x0, x1, self.LUT_SIZE)
        z_grid = np.linspace(z0, z1, self.LUT_SIZE)
        self._u_lut = f32(np.interp(x_grid, x_of_u, uu))
        self._v_lut = f32(np.interp(z_grid, z_of_v, uu))

    # -- host-side dense operators ------------------------------------------

    def grid_basis(self, sample_size: int) -> torch.Tensor:
        """(S*S, nu*nv) operator: surface y values on geomdl's uniform
        (u, v) grid, ordered u-major like geomdl evalpts."""
        uu = np.linspace(0.0, 1.0, sample_size)
        bu = bspline_basis(self.du, self._ku, self.nu, uu)   # (S, nu)
        bv = bspline_basis(self.dv, self._kv, self.nv, uu)   # (S, nv)
        full = np.einsum("ai,bj->abij", bu, bv).reshape(
            sample_size * sample_size, self.nu * self.nv
        )
        return torch.as_tensor(full, dtype=torch.float32)

    # -- float32 evaluation ----------------------------------------------------

    def _param_of(self, lut: torch.Tensor, lo: float, hi: float,
                  q: torch.Tensor) -> torch.Tensor:
        lut = lut.to(q.device)
        f = (q - lo) / (hi - lo) * (self.LUT_SIZE - 1)
        f = torch.clamp(f, 0.0, self.LUT_SIZE - 1.0)
        i0 = torch.clamp(f.to(torch.int32), 0, self.LUT_SIZE - 2).long()
        w = f - i0.to(torch.float32)
        return lut[i0] * (1.0 - w) + lut[i0 + 1] * w

    @staticmethod
    def _basis_1d(p: torch.Tensor, br: torch.Tensor, t: torch.Tensor,
                  deriv: bool) -> torch.Tensor:
        """All basis functions (or derivatives) at parameter t (...,)."""
        p, br = p.to(t.device), br.to(t.device)
        seg = torch.clamp(torch.searchsorted(br, t.contiguous(), right=True)
                          - 1, 0, br.shape[0] - 1)
        tt = (t - br[seg])[..., None]
        coef = p[seg]                                   # (..., d+1, n)
        deg = coef.shape[-2] - 1
        if deriv:
            out = coef[..., deg, :] * deg
            for k in range(deg - 1, 0, -1):
                out = out * tt + coef[..., k, :] * k
        else:
            out = coef[..., deg, :]
            for k in range(deg - 1, -1, -1):
                out = out * tt + coef[..., k, :]
        return out                                      # (..., n)

    @staticmethod
    def _contract(bu: torch.Tensor, y_ctrl: torch.Tensor,
                  bv: torch.Tensor) -> torch.Tensor:
        """sum_ij bu_i y_ij bv_j in float32, contracting i first (XLA's
        order for the JAX package's einsum), each sum in index order."""
        tmp = [None] * y_ctrl.shape[-1]
        for j in range(y_ctrl.shape[-1]):
            acc = bu[..., 0] * y_ctrl[..., 0:1, j]
            for i in range(1, y_ctrl.shape[-2]):
                acc = acc + bu[..., i] * y_ctrl[..., i:i + 1, j]
            tmp[j] = acc
        out = tmp[0] * bv[..., 0]
        for j in range(1, len(tmp)):
            out = out + tmp[j] * bv[..., j]
        return out

    def height(self, y_ctrl: torch.Tensor, x: torch.Tensor, z: torch.Tensor):
        """y_ctrl (..., nu, nv); x, z (..., Q) -> surface y (..., Q)."""
        u = self._param_of(self._u_lut, self.x0, self.x1, x)
        v = self._param_of(self._v_lut, self.z0, self.z1, z)
        bu = self._basis_1d(self._pu, self._br_u, u, False)   # (..., Q, nu)
        bv = self._basis_1d(self._pv, self._br_v, v, False)   # (..., Q, nv)
        return self._contract(bu, y_ctrl, bv)

    def slopes(self, y_ctrl: torch.Tensor, x: torch.Tensor, z: torch.Tensor):
        """Approximate (dy/dx, dy/dz) using d(param)/d(coord) from the LUT
        grids (the param maps are near-affine)."""
        u = self._param_of(self._u_lut, self.x0, self.x1, x)
        v = self._param_of(self._v_lut, self.z0, self.z1, z)
        bu = self._basis_1d(self._pu, self._br_u, u, False)
        bv = self._basis_1d(self._pv, self._br_v, v, False)
        dbu = self._basis_1d(self._pu, self._br_u, u, True)
        dbv = self._basis_1d(self._pv, self._br_v, v, True)
        dy_du = self._contract(dbu, y_ctrl, bv)
        dy_dv = self._contract(bu, y_ctrl, dbv)
        # chain rule through the (monotone) param maps, finite-diff the LUTs
        eps_x = (self.x1 - self.x0) / (self.LUT_SIZE - 1)
        eps_z = (self.z1 - self.z0) / (self.LUT_SIZE - 1)
        du_dx = (
            self._param_of(self._u_lut, self.x0, self.x1, x + eps_x)
            - self._param_of(self._u_lut, self.x0, self.x1, x - eps_x)
        ) / (2 * eps_x)
        dv_dz = (
            self._param_of(self._v_lut, self.z0, self.z1, z + eps_z)
            - self._param_of(self._v_lut, self.z0, self.z1, z - eps_z)
        ) / (2 * eps_z)
        return dy_du * du_dx, dy_dv * dv_dz


@functools.lru_cache(maxsize=None)
def gripper3d_surface() -> BSplineSurfaceY:
    from perfbench.reference.config import GRIPPER_3D as g

    return BSplineSurfaceY(
        g.nu, g.nv, g.degree_u, g.degree_v,
        g.ctrl_x_min, g.ctrl_x_max, g.ctrl_z_min, g.ctrl_z_max,
    )
