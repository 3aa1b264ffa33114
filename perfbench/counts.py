"""The yardstick's arithmetic: the published peaks of the card, and the
float32 operations and bytes that the work of a run needs, computed from
the configuration's shapes and the step counters that the rollouts report.

The rollout counts are copies of ``chip_smoke.k1_flops``, ``k1_bytes``,
``k2_flops`` and ``k2_bytes``, counted by hand from the formulas of the
plain rollouts (``reference/k1.py``, ``reference/k2.py``). They count the
work that these inputs need, not what a kernel does to get it, so a kernel
that does the same work another way leaves them alone.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM (data sheet; dense, at the full 700 W power limit):
# float32 outside the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes at peak."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def k1_flops(p: int, s: int, steps: int, cfull, ccheap) -> float:
    """Float32 operations of 2D rollouts: per lane, a full-solve step costs
    the contact geometry once per point plus 3 Newton iterations
    (gradient, Hessian and 3 line-search energies over points and supports,
    a 5x5 Cholesky); a cheap step 2 iterations over the supports; a travel
    step the servo update; every step the gate. ``cfull``/``ccheap`` are
    the per-lane step counts of the run (data dependent)."""
    full = p * 123 + 3 * (p * 221 + s * 92 + 130) + s * 13 + 50
    cheap = s * 13 + 2 * (s * 88 + 60)
    cf, cc = np.asarray(cfull, np.float64), np.asarray(ccheap, np.float64)
    travel = steps - cf - cc
    return float(np.sum(cf * full + cc * cheap + travel * 15 + steps * 20))


def k1_bytes(b: int, p: int, s: int, n: int) -> int:
    """Bytes of a 2D rollout call: each input read once, the 8 output
    planes written once."""
    return 4 * (b * (2 * 6 * 4 + 2 * p + 4 * s + 16) + 3 * n + 8 * b * n)


def k2_flops(p: int, steps: int, cfull, ccheap, citer) -> float:
    """Operations of 3D rollouts, per lane: a normal step first spans the
    points' wy (5 per point); a full-solve step costs the contact geometry
    once per point (~39 plane, ~200 finger) and per Newton iteration ~760
    per point plus an 8x8 Cholesky solve (~400); a cheap step the plane
    rows (~39 per point) and 3 iterations of ~175 per point plus a 6x6
    solve (~200); a travel step 15; every step the gates (25).
    ``cfull``/``ccheap``/``citer`` are the per-lane counts of the run."""
    cf, cc, ci = (np.asarray(x, np.float64) for x in (cfull, ccheap, citer))
    travel = steps - cf - cc
    return float(np.sum(cf * (p * (5 + 239) + 100) + ci * (p * 760 + 400)
                        + cc * (p * (5 + 39 + 3 * 175) + 3 * 200 + 100)
                        + travel * 15 + steps * 25))


def k2_bytes(b: int, p: int, n: int) -> int:
    """Bytes of a 3D rollout call: inputs read once, 12 planes written."""
    return 4 * (b * (2 * 24 * 12 + 4 * p + 32) + 3 * n + 12 * b * n)


def _linear(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def classifier_row_flops(cfg: dict) -> tuple:
    """(forward, input-gradient backward) float32 operations of one row of
    the 2D classifier's trunk (``ProfileForward2D.trunk``): the gripper
    encoder, the time MLP, the trunk layers and the head. The backward pass
    runs the matrix products of every layer on the path from the gripper's
    control values to the output, for the input's gradient only (the
    weights are frozen). Elementwise work is left out."""
    w, pc = cfg["width"], cfg["params_ch"]
    trunk_in = 3 * w + (1 + 2) * (1 + 2 * cfg["multires"])
    grip = _linear(pc, w) + _linear(w, w)
    time_mlp = _linear(w // 2, w) + _linear(w, w)
    trunk = _linear(trunk_in, w) + (cfg["num_trunk"] - 1) * _linear(w, w)
    head = _linear(w, cfg["output_ch"])
    return grip + time_mlp + trunk + head, grip + trunk + head


def unet_sample_flops(cfg: dict, length: int) -> int:
    """Float32 operations of one sample through the 1-D UNet
    (``ConditionalUnet1D``): every convolution's products over the
    sequence, the FiLM and step-embedding layers; elementwise work left
    out."""
    k, dsed = cfg["kernel_size"], cfg["diffusion_step_embed_dim"]
    dims = list(cfg["down_dims"])
    total = _linear(dsed, 4 * dsed) + _linear(4 * dsed, dsed)

    def res(c_in, c_out, n):
        f = 2 * c_in * c_out * k * n + 2 * c_out * c_out * k * n
        f += _linear(dsed, 2 * c_out)
        if c_in != c_out:
            f += 2 * c_in * c_out * n
        return f

    n, ch = length, cfg["input_dim"]
    for i, dim in enumerate(dims):
        total += res(ch, dim, n) + res(dim, dim, n)
        ch = dim
        if i < len(dims) - 1:
            n_out = (n + 1) // 2
            total += 2 * dim * dim * 3 * n_out
            n = n_out
    total += res(ch, dims[-1], n) + res(dims[-1], dims[-1], n)
    ch = dims[-1]
    skips = list(dims)
    for dim in reversed(dims[:-1]):
        skip = skips.pop()
        total += res(ch + skip, dim, n) + res(dim, dim, n)
        total += 2 * dim * dim * 4 * n
        n = 2 * n
        ch = dim
    total += 2 * ch * dims[0] * k * n + 2 * dims[0] * cfg["input_dim"] * n
    return total
