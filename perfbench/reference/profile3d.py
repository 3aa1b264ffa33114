"""3D dynamics (interaction-profile) network of the benchmark's reference:
a frozen copy of ``dgdm_tpu_torch/models/profile3d.py``, itself a port of
``dgdm_tpu/models/profile3d.py`` (the paper's ``ProfileForward3DModel``,
``dynamics/profile_forward_3d.py:13-86``): PointNet++ object encoder, MLP
gripper encoder, NeRF pose embeddings, and a Linear + BatchNorm + ReLU trunk
(one layer at 2W, then 7 at W) with a linear head.

Two quirks of the reference are kept: the gripper encoder consumes only the
y-row of the control grid (``profile_forward_3d.py:78``), and the raw
sinusoidal timestep embedding goes straight into the trunk (a time encoder
exists in the reference but is never called, ``profile_forward_3d.py:83``).
``encode_object``/``trunk`` are separate so guidance encodes each object
once. Float32; the caller sets TF32 off.
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
from perfbench.reference.pointnet2 import PointNet2
from perfbench.reference.profile2d import MLP2, BatchNorm, head_f32


class ProfileForward3D(nn.Module):
    """Inputs:
    ctrl (B, params_ch) = the y-row of the control grid, normalized [-1, 1],
    ori (B, 1), pos (B, 2), t (B,) rescaled in [0, 1],
    obj (B, P, 3) normalized object surface points.
    """

    def __init__(self, width: int = 256, params_ch: int = 42,
                 output_ch: int = 3, multires: int = 4):
        super().__init__()
        self.config = dict(width=width, params_ch=params_ch,
                           output_ch=output_ch, multires=multires)
        w = width
        self.width, self.multires = w, multires
        self.gripper_encoder = MLP2(params_ch, w, "relu")
        self.object_encoder = PointNet2(w)
        trunk_in = 3 * w + nerf_embed_dim(1, multires) + nerf_embed_dim(
            2, multires)
        widths = [2 * w] + [w] * 7
        ins = [trunk_in] + widths[:-1]
        self.trunk_layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(ins, widths)])
        # flax BatchNorm(momentum=0.9) == torch momentum 0.1; eps 1e-5 both
        self.trunk_bns = nn.ModuleList(
            [BatchNorm(b, momentum=0.1, eps=1e-5) for b in widths])
        self.head = nn.Linear(w, output_ch)

    def forward(self, ctrl, ori, pos, t, obj):
        return self.trunk(ctrl, ori, pos, t, self.encode_object(obj))

    def encode_object(self, obj):
        """Object point cloud (B, P, 3) -> (B, W) feature."""
        return self.object_encoder(obj)

    def trunk(self, ctrl, ori, pos, t, obj_feat):
        x_ctrl = self.gripper_encoder(ctrl)
        x_ori = nerf_embed(ori, self.multires)
        x_pos = nerf_embed(pos, self.multires)
        t_emb = timestep_embedding(t, self.width)   # fed raw (reference quirk)
        if obj_feat.shape[:-1] != x_ctrl.shape[:-1]:
            obj_feat = obj_feat.expand(*x_ctrl.shape[:-1], obj_feat.shape[-1])
        x = torch.cat([obj_feat, x_ctrl, x_ori, x_pos, t_emb], dim=-1)
        for dense, bn in zip(self.trunk_layers, self.trunk_bns):
            x = F.relu(bn(dense(x)))
        return head_f32(self.head, x)
