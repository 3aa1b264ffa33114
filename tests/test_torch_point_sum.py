"""The point sum of the port's plain rollout versions
(dgdm_tpu_torch/sim/point_sum.py) against an independent numpy emulation of
the CUDA kernels' order: lane r of G adds the points r, r + G, ... in
increasing p onto 0.0 in float64, an xor butterfly with strides G/2, ..., 1
adds the G partial sums on every lane, and the total rounds once to float32.
Bitwise equality is asserted (tolerance 0), on the float64 total before the
rounding and on the float32 result: the helper exists to reproduce that
order exactly. The inputs span ~60 binary exponents, so that float64
addition is inexact and the orders really differ in float64 (after the
rounding to float32 they almost never do, which is the point of summing in
float64). No JAX counterpart: the
Pallas kernels sum in float32."""

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.sim.point_sum import point_sum, point_sum64


def _terms(p, rest=(3, 5), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p,) + rest) * 2.0 ** rng.integers(
        -30, 30, (p,) + rest)
    return x.astype(np.float32)


def _kernel_order(x, g):
    """x (P, ...) float32 -> float64 total in the kernel's order, and whether
    all G lanes of the butterfly ended with the same float64 value."""
    p = x.shape[0]
    lanes = np.zeros((g,) + x.shape[1:], np.float64)
    for r in range(g):
        for q in range(r, p, g):
            lanes[r] = lanes[r] + x[q].astype(np.float64)
    m = g // 2
    idx = np.arange(g)
    while m >= 1:
        lanes = lanes + lanes[idx ^ m]
        m //= 2
    same = all(np.array_equal(lanes[0], lanes[r]) for r in range(g))
    return lanes[0], same


@pytest.mark.parametrize("group", [1, 8, 16, 32])
@pytest.mark.parametrize("p", [256, 100, 64, 7])
def test_grouped_order_matches_kernel_emulation(group, p):
    """P = 100 is K1's contour length (no multiple of 8 or 32) and P = 7 is
    fewer points than lanes: the upper lanes then stay one point short."""
    x = _terms(p)
    want, lanes_agree = _kernel_order(x, group)
    assert lanes_agree
    got64 = point_sum64(torch.from_numpy(x), 0, group)
    np.testing.assert_array_equal(got64.numpy(), want)
    got = point_sum(torch.from_numpy(x), 0, group)
    assert got.dtype == torch.float32 and got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    # the reduced dim may sit anywhere
    got_mid = point_sum64(torch.from_numpy(np.moveaxis(x, 0, 1).copy()), 1,
                          group)
    np.testing.assert_array_equal(got_mid.numpy(), want)


def test_orders_differ_on_wide_terms_and_agree_on_narrow_ones():
    """With ~60 exponents of spread the orders differ in float64 (so the
    test above can tell them apart) and stay within one float32 ulp of each
    other after the rounding; with float32 terms of like magnitude float64
    addition is exact and every order gives the same."""
    wide = torch.from_numpy(_terms(256, (64, 64), seed=1))
    s64 = [point_sum64(wide, 0, g) for g in (1, 8, 32)]
    assert not torch.equal(s64[0], s64[1]) and not torch.equal(s64[1], s64[2])
    base = point_sum(wide, 0, 0)
    for g in (1, 8, 32):
        torch.testing.assert_close(point_sum(wide, 0, g), base, rtol=2e-7,
                                   atol=0.0)
    narrow = torch.from_numpy(
        np.random.default_rng(2).uniform(0.5, 1.0, (256, 64)).astype(
            np.float32))
    base = point_sum(narrow, 0, 0)
    for g in (1, 8, 32):
        assert torch.equal(point_sum(narrow, 0, g), base)


def test_sequential_fast_path_equals_the_loop():
    """group = 1 on the CPU takes one cumsum call; it must add in the same
    order as the chunk loop that the other devices and groups take."""
    x = torch.from_numpy(_terms(100, (4, 3), seed=3))
    acc = torch.zeros((4, 3), dtype=torch.float64)
    for q in range(100):
        acc = acc + x[q]
    assert torch.equal(point_sum64(x, 0, 1), acc)
    # all-negative-zero terms: 0.0 + -0.0 is +0.0 in both
    z = point_sum(torch.full((5, 2), -0.0), 0, 1)
    assert not torch.signbit(z).any()


def test_rejects_a_group_that_is_no_power_of_two():
    with pytest.raises(ValueError):
        point_sum(torch.zeros(4, 2), 0, 12)
