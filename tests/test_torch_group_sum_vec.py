"""The vector point sums of the CUDA kernels (``group_sum_vec``,
``group_sum_park`` and ``group_sum_wide`` in
dgdm_tpu_torch/csrc/rollout_common.cuh, used by K2's Newton and Jacobi
passes and K1's Newton and Jacobi passes) against the order of the plain
rollout versions (dgdm_tpu_torch/sim/point_sum.py).

A numpy emulation of the helpers over the G lanes of a rollout (G = 32 for
K2, 16 for K1): lane r adds the points r, r + G, ... in increasing p onto
0.0 in float64; then, at each xor stride G/2, ..., 2, 1, a lane holding
C > 1 values keeps the first
ceil(C / 2) of them (its stride bit clear) or the rest, padded with one
value where C is odd (bit set), and adds its partner's partial of what it
keeps; a lane holding one value adds its partner's, as ``group_sum``'s
butterfly does. Each total rounds once to float32 on the lane where it
ended: ``group_sum_vec`` broadcasts it, ``group_sum_park`` has the owner
lane (``detail::vec_owner``, found by its inverse ``detail::vec_slot``)
store it; with more values than lanes a lane ends with several
(``detail::vec_held``), and ``group_sum_wide`` broadcasts total q from its
owner's value ``detail::vec_index``. Bitwise equality with
``point_sum64(..., group=G)`` is asserted
(tolerance 0) on float32 terms spanning 1e-8 to 1e8 with cancelling signs,
where float64 addition is inexact and the order decides the bits: at G = 32
for 6, 8 and 10 values (K2 Jacobi's plane sweep, finger sweep and pass A)
and 25, 26 and 27 (K2 Newton's passes C, A and B, and the cheap solve's
iteration); at G = 16 for 3, 5 and 6 (K1 Jacobi's planar sweep, contour
sweep and passes A and C; K1 Newton's cheap-solve energies and line
search), 7 and 8 (K1 Newton's cheap-solve and full-solve support sums) and
23 (K1 Newton's contour pass, ``group_sum_wide``). No JAX counterpart: the
Pallas kernels sum in float32."""

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.sim.point_sum import point_sum64

G = 32


def _terms(p, n, seed):
    """(P, N) float32 terms: magnitudes 10^U(-8, 8) with random signs, and
    every third point the negation of an earlier one scaled by 1 + 2^-20."""
    rng = np.random.default_rng(seed)
    x = rng.choice([-1.0, 1.0], (p, n)) * 10.0 ** rng.uniform(-8, 8, (p, n))
    for q in range(3, p, 3):
        x[q] = -x[rng.integers(0, q)] * (1.0 + 2.0 ** -20)
    return x.astype(np.float32)


def _lane_partials(x, g=G):
    """The kernel's per-lane float64 partials, (g, N)."""
    acc = np.zeros((g, x.shape[1]), np.float64)
    for r in range(g):
        for q in range(r, x.shape[0], g):
            acc[r] = acc[r] + x[q].astype(np.float64)
    return acc


def _vec_owner(m, c, q):
    """``detail::vec_owner<M, C>(q)``: the lane on which value q ends."""
    if m == 0:
        return 0
    if c == 1:
        return _vec_owner(m // 2, 1, q)
    h = (c + 1) // 2
    return (_vec_owner(m // 2, h, q) if q < h
            else m + _vec_owner(m // 2, h, q - h))


def _vec_held(m, c):
    """``detail::vec_held<M, C>()``: the values a lane holds at the end."""
    if m == 0 or c == 1:
        return c
    return _vec_held(m // 2, (c + 1) // 2)


def _vec_index(m, c, q):
    """``detail::vec_index<M, C>(q)``: the index of value q among them."""
    if m == 0:
        return q
    if c == 1:
        return 0
    h = (c + 1) // 2
    return _vec_index(m // 2, h, q if q < h else q - h)


def _vec_slot(m, c, r, lane):
    """``detail::vec_slot<M, C, R>(lane)``: the value whose owner is
    ``lane``, or -1."""
    if r <= 0:
        return -1
    if m == 0:
        return 0
    if c == 1:
        return -1 if lane & m else _vec_slot(m // 2, 1, r, lane)
    h = (c + 1) // 2
    if lane & m:
        s = _vec_slot(m // 2, h, r - h, lane)
        return -1 if s < 0 else h + s
    return _vec_slot(m // 2, h, min(r, h), lane)


def _group_sum_vec(partials, g=G, final=None):
    """-> (per-value float64 total as held by its owner lane, float32 value
    every lane receives, float64 exchanges per lane); with ``final`` a
    list, it receives each lane's float64 values after the last stride."""
    n = partials.shape[1]
    held = [[np.float64(v) for v in partials[r]] for r in range(g)]
    c, m, exchanges = n, g // 2, 0
    owners = [0] * n           # lane bits so far, by value
    local = list(range(n))     # index of each value in its owner's list
    while m >= 1:
        if c == 1:
            held = [[held[r][0] + held[r ^ m][0]] for r in range(g)]
            exchanges += 1
        else:
            h = (c + 1) // 2

            def hi(r, j):
                return held[r][h + j] if h + j < c else np.float64(0.0)

            new = []
            for r in range(g):
                up, partner = bool(r & m), r ^ m
                row = []
                for j in range(h):
                    mine = hi(r, j) if up else held[r][j]
                    recv = held[partner][j] if partner & m else hi(partner, j)
                    row.append(mine + recv)
                new.append(row)
            held = new
            exchanges += h
            for q in range(n):
                if local[q] >= h:
                    owners[q] += m
                    local[q] -= h
            c = h
        m //= 2
    assert all(len(h) == _vec_held(g // 2, n) for h in held)
    assert local == [_vec_index(g // 2, n, q) for q in range(n)]
    assert owners == [_vec_owner(g // 2, n, q) for q in range(n)]
    if final is not None:
        final.extend(held)
    tot64 = np.array([held[owners[q]][local[q]] for q in range(n)])
    # every lane receives the owner's rounding (a float32 broadcast)
    recv = np.array([np.float32(held[owners[q]][local[q]])
                     for q in range(n)])
    return tot64, recv, exchanges


@pytest.mark.parametrize("p", [256, 200, 17])
@pytest.mark.parametrize("n,exchanges", [(6, 8), (8, 9), (10, 12)])
def test_group_sum_vec_matches_point_sum64(n, exchanges, p):
    """P = 256 is the 3D contact-point count, 200 no multiple of 32, 17
    fewer points than lanes (the upper lanes hold 0.0)."""
    x = _terms(p, n, seed=100 * n + p)
    tot64, recv, used = _group_sum_vec(_lane_partials(x))
    want = point_sum64(torch.from_numpy(x), 0, G).numpy()
    np.testing.assert_array_equal(tot64, want)
    np.testing.assert_array_equal(recv, want.astype(np.float32))
    assert used == exchanges
    # the terms make the order matter: a sequential float64 sum of the same
    # terms differs from the tree in some value of the case
    seq = point_sum64(torch.from_numpy(x), 0, 1).numpy()
    assert not np.array_equal(seq, want)


@pytest.mark.parametrize("g,n,p,exchanges", [
    (32, 6, 256, 8), (32, 6, 200, 8), (32, 6, 17, 8),
    (32, 25, 256, 27), (32, 25, 200, 27), (32, 25, 17, 27),
    (32, 26, 256, 27), (32, 26, 200, 27), (32, 26, 17, 27),
    (32, 27, 256, 28), (32, 27, 200, 28), (32, 27, 17, 28),
    (16, 3, 100, 5), (16, 3, 272, 5), (16, 3, 17, 5),
    (16, 5, 100, 7), (16, 5, 272, 7), (16, 5, 17, 7),
    (16, 6, 100, 7), (16, 6, 272, 7), (16, 6, 17, 7),
    (16, 23, 100, 23), (16, 23, 384, 23), (16, 23, 17, 23),
    (16, 8, 64, 8), (16, 8, 7, 8), (16, 8, 17, 8),
    (16, 7, 64, 8), (16, 7, 7, 8), (16, 7, 17, 8),
])
def test_group_sum_vec_and_park_match_point_sum64(g, n, p, exchanges):
    """The helpers at the kernels' vector widths and point counts (K2:
    256, 200 and 17 points; K1: 100, 272 (Jacobi's limit at 64 supports),
    384 (Newton's) and 17 contour points, 64, 7 and 17 supports): every
    total bitwise ``point_sum64(..., group=g)``'s, on every lane
    (``group_sum_vec``; ``group_sum_wide`` where n > g) and, where n <= g,
    parked by exactly one lane, the one that ``vec_owner`` names
    (``group_sum_park``), in the float64 exchanges a lane makes (27 for K2
    Newton's 26 sums, where 26 butterflies take 130; at G = 16, 7 for K1
    Jacobi's 5 contour-sweep sums, where 5 take 20, and 23 for K1 Newton's
    23 contour-pass sums, where 23 take 92)."""
    x = _terms(p, n, seed=1000 * g + 10 * n + p)
    final = []
    tot64, recv, used = _group_sum_vec(_lane_partials(x, g), g, final)
    want = point_sum64(torch.from_numpy(x), 0, g).numpy()
    np.testing.assert_array_equal(tot64, want)
    np.testing.assert_array_equal(recv, want.astype(np.float32))
    assert used == exchanges
    # each total ends in one (lane, index) of its own
    ends = {(_vec_owner(g // 2, n, q), _vec_index(g // 2, n, q))
            for q in range(n)}
    assert len(ends) == n
    assert (_vec_held(g // 2, n) > 1) == (n > g)
    if n <= g:
        # group_sum_park: lane r stores its rounded value to
        # dst[vec_slot(r)]
        dst = np.full(n, np.nan, np.float32)
        slots = [_vec_slot(g // 2, n, n, r) for r in range(g)]
        for r, q in enumerate(slots):
            if q >= 0:
                assert np.isnan(dst[q]), f"value {q} stored twice"
                assert r == _vec_owner(g // 2, n, q)
                dst[q] = np.float32(final[r][0])
        assert sorted(q for q in slots if q >= 0) == list(range(n))
        np.testing.assert_array_equal(dst, want.astype(np.float32))
    seq = point_sum64(torch.from_numpy(x), 0, 1).numpy()
    assert not np.array_equal(seq, want)
