"""The yardstick's arithmetic for the 3D design path: the float32
operations of the 3D classifier (``ProfileForward3D``) and of its PointNet++
object encoder, computed from the configuration's shapes, in the
conventions of ``counts.py`` (matrix products counted, elementwise work left
out; the input-gradient backward pass runs the products of every layer on
the path from the control values to the output). K2's rollouts are counted
by ``counts.k2_flops`` and ``counts.k2_bytes``.
"""

from __future__ import annotations

from perfbench.counts import _linear


def classifier3d_row_flops(cfg: dict) -> tuple:
    """(forward, input-gradient backward) float32 operations of one row of
    the 3D classifier's trunk (``ProfileForward3D.trunk``): the gripper
    encoder over the control values, the trunk layers (``trunk_widths``:
    one of 2W, then 7 of W) and the head. The raw timestep embedding goes
    into the trunk without a layer of its own."""
    c = cfg["classifier"]
    w, pc = c["width"], c["params_ch"]
    trunk_in = 3 * w + (1 + 2) * (1 + 2 * c["multires"])
    grip = _linear(pc, w) + _linear(w, w)
    widths = cfg["trunk_widths"]
    trunk = sum(_linear(a, b) for a, b in zip([trunk_in] + widths[:-1],
                                              widths))
    head = _linear(widths[-1], c["output_ch"])
    return grip + trunk + head, grip + trunk + head


def pointnet2_flops(cfg: dict) -> int:
    """Float32 operations of one object encoding (``PointNet2``): per
    set-abstraction level the farthest-point sampling's distance updates
    (8 a point a step), the ball query's distance table (8 a pair), and the
    grouped MLP's products over every (centre, neighbour) pair; the global
    level's MLP over the last level's points."""
    pn = cfg["pointnet2"]
    n, ch = cfg["cloud_points"], 0
    total = 0
    for level in ("sa1", "sa2"):
        sa = pn[level]
        m, k = sa["npoint"], sa["nsample"]
        total += m * n * 8 + m * n * 8
        c_in = 3 + ch
        for c_out in sa["mlp"]:
            total += m * k * _linear(c_in, c_out)
            c_in = c_out
        n, ch = m, sa["mlp"][-1]
    c_in = 3 + ch
    for c_out in pn["sa3"]["mlp"]:
        total += n * _linear(c_in, c_out)
        c_in = c_out
    return total
