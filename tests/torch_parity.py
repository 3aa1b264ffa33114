"""Parity helpers of the port's rollout tests (kernel K1), free of JAX so
that the card's kernel tests can import them on a host without it."""

import os

import numpy as np
import torch

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "rollout2d_golden.npz")
NAMES = ("dth", "dpx", "dpy", "fth", "fpx", "fpy", "cfull", "ccheap")


def assert_k1_parity(out, ref, lane=128):
    """out/ref: dicts of (B, N) arrays keyed by NAMES (counters optional).
    Bars: the reference moved (max |dtheta| > 1e-2); >= 99% of lanes within
    1e-3 and corr >= 0.999 for dtheta and dpos; counters equal per block.
    Prints the measured figures (shown with ``pytest -s``)."""
    assert np.abs(ref["dth"]).max() > 1e-2, "reference rollout did not move"
    for k in ("dth", "dpx", "dpy"):
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert np.isfinite(a).all(), k
        frac = float(np.mean(np.abs(a - b) < 1e-3))
        corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
        print(f"{k}: {frac:.4f} of lanes within 1e-3, corr {corr:.6f}, "
              f"max err {np.abs(a - b).max():.3g}")
        assert frac >= 0.99, (k, frac)
        assert corr >= 0.999, (k, corr)
    for k in ("cfull", "ccheap"):
        if k in ref:
            np.testing.assert_array_equal(np.asarray(out[k])[:, ::lane],
                                          np.asarray(ref[k])[:, ::lane])


def golden():
    """The fixture, its four scene arrays and its poses as CPU tensors."""
    z = np.load(GOLDEN)
    arrs = [torch.from_numpy(z[k]) for k in ("coefs", "contour", "support",
                                             "scalars")]
    return z, arrs, torch.from_numpy(z["poses"])
