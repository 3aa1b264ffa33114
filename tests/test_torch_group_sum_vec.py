"""The vector point sum of the CUDA kernels (``group_sum_vec`` in
dgdm_tpu_torch/csrc/rollout_common.cuh, used by K2's Jacobi passes) against
the order of the plain rollout versions (dgdm_tpu_torch/sim/point_sum.py).

A numpy emulation of the helper over the 32 lanes of a rollout: lane r adds
the points r, r + 32, ... in increasing p onto 0.0 in float64; then, at each
xor stride 16, 8, 4, 2, 1, a lane holding C > 1 values keeps the first
ceil(C / 2) of them (its stride bit clear) or the rest, padded with one
value where C is odd (bit set), and adds its partner's partial of what it
keeps; a lane holding one value adds its partner's, as ``group_sum``'s
butterfly does. Each total rounds once to float32 on the lane where it
ended. Bitwise equality with ``point_sum64(..., group=32)`` is asserted
(tolerance 0) for 6, 8 and 10 values (the plane sweep's, the finger
sweep's and pass A's sums) on float32 terms spanning 1e-8 to 1e8 with
cancelling signs, where float64 addition is inexact and the order decides
the bits. No JAX counterpart: the Pallas kernels sum in float32."""

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


def _lane_partials(x):
    """The kernel's per-lane float64 partials, (G, N)."""
    acc = np.zeros((G, x.shape[1]), np.float64)
    for r in range(G):
        for q in range(r, x.shape[0], G):
            acc[r] = acc[r] + x[q].astype(np.float64)
    return acc


def _group_sum_vec(partials):
    """-> (per-value float64 total as held by its owner lane, float32 value
    every lane receives, float64 exchanges per lane)."""
    n = partials.shape[1]
    held = [[np.float64(v) for v in partials[r]] for r in range(G)]
    c, m, exchanges = n, G // 2, 0
    owners = [0] * n           # lane bits so far, by value
    local = list(range(n))     # index of each value in its owner's list
    while m >= 1:
        if c == 1:
            held = [[held[r][0] + held[r ^ m][0]] for r in range(G)]
            exchanges += 1
        else:
            h = (c + 1) // 2

            def hi(r, j):
                return held[r][h + j] if h + j < c else np.float64(0.0)

            new = []
            for r in range(G):
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
    assert all(i == 0 for i in local)
    tot64 = np.array([held[owners[q]][0] for q in range(n)])
    # every lane receives the owner's rounding (a float32 broadcast)
    recv = np.array([np.float32(held[owners[q]][0]) for q in range(n)])
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
