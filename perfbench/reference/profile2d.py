"""2D dynamics (interaction-profile) network — port of
``dgdm_tpu/models/profile2d.py`` (the reference ``ProfileForward2DModel``,
``dynamics/profile_forward_2d.py:78-156``): MLP encoders for the gripper
y-vector and the flattened object contour, NeRF embeddings of the pose, a
sinusoidal timestep embedding through a SiLU MLP, then a Linear + BatchNorm +
ReLU trunk and a linear head predicting the whitened (dtheta, dx, dy).

``encode_object``/``trunk`` are separate so guidance encodes each object
once. BatchNorm is ``BatchNorm``, which trains as flax's does. The head runs
outside any autocast region, as flax keeps it in float32 when the rest
computes in bfloat16. ``config`` holds the constructor arguments (what
``models/convert.py`` stores beside the weights).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.embeddings import (
    nerf_embed,
    nerf_embed_dim,
    timestep_embedding,
)


class BatchNorm(nn.BatchNorm1d):
    """``torch.nn.BatchNorm1d`` over the last axis of (rows, C), trained as
    ``flax.linen.BatchNorm`` is: the batch statistics are E[x] and the
    biased E[x^2] - E[x]^2 (clipped at 0), and both running statistics move
    toward them with flax's momentum 0.9 (torch's 0.1). torch's own train
    mode would move the running variance toward the unbiased variance,
    n/(n-1) times larger. The statistics come from ``torch.var_mean`` in
    float32 (centred, with an order of summation that keeps it within
    float32 rounding of the exact value: a plain float32 sum over the
    131,072 rows of a PointNet++ BatchNorm is off by up to ~1e-4). In eval
    mode it is torch's.

    With ``group`` set (``set_sync_group``: a data-parallel trainer's dp
    group), the statistics are those of the global batch, as flax's are
    under a sharded batch: the ranks' sums of x and x^2 are all-reduced by
    a differentiable collective, so the backward pass sees the global
    statistics too, and every rank's running statistics stay equal."""

    group = None

    def _stats(self, xf):
        if self.group is None:
            return torch.var_mean(xf, dim=0, unbiased=False)
        from torch.distributed.nn.functional import all_reduce

        n = torch.tensor([float(xf.shape[0])], device=xf.device)
        sums = all_reduce(torch.cat([xf.sum(0), (xf * xf).sum(0), n]),
                          group=self.group)
        c = xf.shape[1]
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        return var, mean

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        var, mean = self._stats(xf)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean
                                    + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var
                                   + self.momentum * var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def set_sync_group(model: nn.Module, group) -> None:
    """Train every ``BatchNorm`` of ``model`` on the statistics summed over
    ``group`` (None: this rank's batch alone)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class MLP2(nn.Module):
    def __init__(self, in_ch: int, width: int, act: str = "relu"):
        super().__init__()
        self.fc0 = nn.Linear(in_ch, width)
        self.fc1 = nn.Linear(width, width)
        self.act = act

    def forward(self, x):
        x = self.fc0(x)
        x = F.relu(x) if self.act == "relu" else F.silu(x)
        return self.fc1(x)


class ProfileForward2D(nn.Module):
    """Inputs (all normalized like dynamics/dataloader.py):
    ctrl (B, params_ch) finger y-vector in [-1, 1],
    ori (B, 1) = theta/pi - 1, pos (B, 2) = pos/0.03,
    t (B,) rescaled timestep in [0, 1],
    obj (B, object_ch) flattened contour in [-1, 1].
    """

    def __init__(self, width: int = 256, params_ch: int = 14,
                 object_ch: int = 200, output_ch: int = 3, multires: int = 4,
                 num_trunk: int = 8):
        super().__init__()
        self.config = dict(width=width, params_ch=params_ch,
                           object_ch=object_ch, output_ch=output_ch,
                           multires=multires, num_trunk=num_trunk)
        w = width
        self.width, self.multires = w, multires
        self.gripper_encoder = MLP2(params_ch, w, "relu")
        self.object_encoder = MLP2(object_ch, w, "relu")
        self.time_in = nn.Linear(w // 2, w)
        self.time_out = nn.Linear(w, w)
        trunk_in = 3 * w + nerf_embed_dim(1, multires) + nerf_embed_dim(
            2, multires)
        self.trunk_layers = nn.ModuleList(
            [nn.Linear(trunk_in if i == 0 else w, w) for i in range(num_trunk)])
        # flax BatchNorm(momentum=0.9) == torch momentum 0.1; eps 1e-5 both
        self.trunk_bns = nn.ModuleList(
            [BatchNorm(w, momentum=0.1, eps=1e-5) for _ in range(num_trunk)])
        self.head = nn.Linear(w, output_ch)

    def forward(self, ctrl, ori, pos, t, obj):
        return self.trunk(ctrl, ori, pos, t, self.encode_object(obj))

    def encode_object(self, obj):
        """Object geometry -> (..., W) feature."""
        return self.object_encoder(obj)

    def trunk(self, ctrl, ori, pos, t, obj_feat):
        x_ctrl = self.gripper_encoder(ctrl)
        x_ori = nerf_embed(ori, self.multires)
        x_pos = nerf_embed(pos, self.multires)
        t_emb = timestep_embedding(t, self.width // 2)
        t_emb = self.time_out(F.silu(self.time_in(t_emb)))
        if obj_feat.shape[:-1] != x_ctrl.shape[:-1]:
            obj_feat = obj_feat.expand(*x_ctrl.shape[:-1], obj_feat.shape[-1])
        x = torch.cat([obj_feat, x_ctrl, x_ori, x_pos, t_emb], dim=-1)
        for dense, bn in zip(self.trunk_layers, self.trunk_bns):
            x = F.relu(bn(dense(x)))
        return head_f32(self.head, x)


def head_f32(head: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The output layer in float32, outside any autocast region."""
    with torch.autocast(x.device.type, enabled=False):
        return head(x.float())
