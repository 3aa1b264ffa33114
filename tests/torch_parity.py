"""Parity helpers of the port's rollout tests (kernels K1 and K2), free of
JAX so that the card's kernel tests can import them on a host without it."""

import os

import numpy as np
import torch

# The tests run in several pytest-xdist processes that share the cores.
# With torch's default of one intra-op thread per core in each, the plain
# rollouts' many small ops wait on descheduled threads and run over ten
# times slower; one thread per process keeps them bound by compute alone.
# The OpenBLAS pools of numpy and scipy spin between calls in the same way
# and take the cores from the other processes (the 3D engine tests ran three
# times slower beside one other process): one thread each too, for the
# libraries loaded later by the environment variable, for those loaded now
# by threadpoolctl where it is installed.
torch.set_num_threads(1)
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
try:
    import scipy.linalg  # noqa: F401  (loads scipy's own OpenBLAS)
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(limits=1, user_api="blas")

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "rollout2d_golden.npz")
# the same scenes and poses through K1's Jacobi branch, with its calibration
GOLDEN_JACOBI = os.path.join(os.path.dirname(__file__), "fixtures",
                             "rollout2d_jacobi_golden.npz")
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


def golden(path=GOLDEN):
    """The fixture, its four scene arrays and its poses as CPU tensors."""
    z = np.load(path)
    arrs = [torch.from_numpy(z[k]) for k in ("coefs", "contour", "support",
                                             "scalars")]
    return z, arrs, torch.from_numpy(z["poses"])


# ---- kernel K2 (3D rollout) -------------------------------------------------

GOLDEN3 = os.path.join(os.path.dirname(__file__), "fixtures",
                       "rollout3d_golden.npz")
NAMES3 = ("qw", "qz", "dpx", "dpy", "valid", "sqw", "sqz", "sdx", "sdy",
          "cfull", "ccheap", "citer")


def k2_profile(raw, poses):
    """Raw K2 outputs (dict of (B, N) arrays keyed by NAMES3) -> snapshot
    dtheta, dpx, dpy, final theta and dpos, validity, as numpy arrays."""
    from dgdm_tpu_torch.sim.rollout3d_ref import readout

    t = [torch.as_tensor(np.asarray(raw[k])) for k in NAMES3[:9]]
    dth, sdpos, fth, valid, fpos = readout(*t, torch.as_tensor(
        np.asarray(poses)))
    out = {"dth": dth, "dpx": sdpos[..., 0], "dpy": sdpos[..., 1],
           "fth": fth, "fpx": fpos[..., 0], "fpy": fpos[..., 1],
           "valid": valid}
    out = {k: v.numpy() for k, v in out.items()}
    for k in ("cfull", "ccheap", "citer"):
        if k in raw:
            out[k] = np.asarray(raw[k])
    return out


def assert_k2_parity(out, ref, poses, lane=128):
    """out/ref: dicts of raw (B, N) K2 outputs keyed by NAMES3; read out
    and held to the bars of ``assert_k2_profiles``."""
    return assert_k2_profiles(k2_profile(out, poses), k2_profile(ref, poses),
                              lane)


def assert_k2_profiles(a, b, lane=128):
    """a/b: read-out K2 profiles (dth, dpx, dpy, valid and optionally the
    counters, (B, N) each). Bars: the reference moved (max |dtheta| >
    1e-2); >= 99% of lanes within 1e-3 and corr >= 0.999 for the snapshot
    dtheta and dpos; validity equal; full/cheap/iteration counters equal per
    block. Prints the measured figures (shown with ``pytest -s``) and
    returns them."""
    assert np.abs(b["dth"]).max() > 1e-2, "reference rollout did not move"
    stats = {}
    for k in ("dth", "dpx", "dpy"):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert np.isfinite(x).all(), k
        frac = float(np.mean(np.abs(x - y) < 1e-3))
        corr = float(np.corrcoef(x.ravel(), y.ravel())[0, 1])
        stats[k] = {"frac_1e-3": frac, "corr": corr,
                    "max_abs_err": float(np.abs(x - y).max()),
                    "bitwise": float(np.mean(x == y))}
        print(f"{k}: {frac:.4f} of lanes within 1e-3, corr {corr:.6f}, "
              f"max err {np.abs(x - y).max():.3g}")
        assert frac >= 0.99, (k, frac)
        assert corr >= 0.999, (k, corr)
    np.testing.assert_array_equal(np.asarray(a["valid"]),
                                  np.asarray(b["valid"]))
    for k in ("cfull", "ccheap", "citer"):
        if k in b:
            np.testing.assert_array_equal(np.asarray(a[k])[:, ::lane],
                                          np.asarray(b[k])[:, ::lane])
    return stats


def golden3d():
    """The K2 fixture, its three scene arrays and its poses (CPU tensors)."""
    z = np.load(GOLDEN3)
    arrs = [torch.from_numpy(z[k]) for k in ("coefs", "points", "scalars")]
    return z, arrs, torch.from_numpy(z["poses"])
