"""PointNet++ set-abstraction encoder — port of
``dgdm_tpu/models/pointnet2.py`` (the reference's vendored torch encoder,
``dynamics/models/pointnet2.py:11-32``, ``pointnet2_utils.py``): three
set-abstraction levels SA(512, r=0.2, k=32, [64, 128]) -> SA(128, r=0.4,
k=64, [128, W]) -> global SA([W]). Farthest-point sampling starts at index 0
(deterministic, as in the JAX package); ball query groups the in-ball points
in index order and pads with the first, with a stable sort as ``jnp.argsort``
is. Per-group MLPs are Linear + BatchNorm over the channel axis + ReLU, then
a max over the group.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dgdm_tpu_torch.models.profile2d import BatchNorm


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., N, 3), b (..., M, 3) -> (..., N, M)."""
    an = torch.sum(a * a, -1, keepdim=True)
    bn = torch.sum(b * b, -1, keepdim=True)
    cross = torch.matmul(a, b.transpose(-1, -2))
    return an - 2.0 * cross + bn.transpose(-1, -2)


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> indices (B, npoint), starting at index 0. With
    N < npoint the distances tie at zero and argmax takes the first index,
    as ``jnp.argmax`` does."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    dist = torch.full((b, n), float("inf"), device=xyz.device,
                      dtype=xyz.dtype)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    idx = []
    for _ in range(npoint):
        idx.append(last)
        d = torch.sum((xyz - xyz[rows, last][:, None]) ** 2, -1)
        dist = torch.minimum(dist, d)
        last = torch.argmax(dist, -1)
    return torch.stack(idx, -1)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               centers: torch.Tensor) -> torch.Tensor:
    """Up to nsample point indices within radius of each center (in index
    order), padded with the first in-ball point (reference
    pointnet2_utils.py:95-115 semantics)."""
    d2 = pairwise_sqdist(centers, xyz)                       # (B, M, N)
    n = xyz.shape[-2]
    in_ball = d2 <= radius**2
    ar = torch.arange(n, device=xyz.device).expand_as(d2)
    order_key = torch.where(in_ball, ar, n + 1)
    key_sorted, idx = torch.sort(order_key, dim=-1, stable=True)
    idx, key_sorted = idx[..., :nsample], key_sorted[..., :nsample]
    return torch.where(key_sorted > n, idx[..., :1], idx)


class SetAbstraction(nn.Module):
    def __init__(self, npoint: Optional[int], radius: Optional[float],
                 nsample: Optional[int], in_ch: int, mlp: Sequence[int],
                 group_all: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        chans = [in_ch] + list(mlp)
        self.mlps = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(chans[:-1], chans[1:])])
        # flax BatchNorm(momentum=0.9) == torch momentum 0.1; eps 1e-5 both
        self.bns = nn.ModuleList(
            [BatchNorm(c, momentum=0.1, eps=1e-5) for c in mlp])

    def forward(self, xyz, feats):
        """xyz (B, N, 3); feats (B, N, C) or None -> (new_xyz, new_feats)."""
        if self.group_all:
            new_xyz = torch.zeros((xyz.shape[0], 1, 3), device=xyz.device,
                                  dtype=xyz.dtype)
            grouped = xyz[:, None]                            # (B, 1, N, 3)
            if feats is not None:
                grouped = torch.cat([grouped, feats[:, None]], dim=-1)
        else:
            fps_idx = farthest_point_sample(xyz, self.npoint)
            new_xyz = torch.gather(xyz, 1, fps_idx[..., None].expand(-1, -1, 3))
            group_idx = ball_query(self.radius, self.nsample, xyz, new_xyz)
            b, m, k = group_idx.shape
            flat = group_idx.reshape(b, m * k, 1)
            grouped_xyz = torch.gather(xyz, 1, flat.expand(-1, -1, 3)) \
                .reshape(b, m, k, 3)
            grouped = grouped_xyz - new_xyz[:, :, None, :]
            if feats is not None:
                c = feats.shape[-1]
                grouped_f = torch.gather(feats, 1, flat.expand(-1, -1, c)) \
                    .reshape(b, m, k, c)
                grouped = torch.cat([grouped, grouped_f], dim=-1)
        x = grouped
        for dense, bn in zip(self.mlps, self.bns):
            x = dense(x)
            x = bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)
            x = F.relu(x)
        return new_xyz, torch.amax(x, dim=-2)                 # pool over group


class PointNet2(nn.Module):
    """3-level encoder -> (B, width) global feature."""

    def __init__(self, width: int = 256):
        super().__init__()
        self.sa1 = SetAbstraction(512, 0.2, 32, 3, (64, 128))
        self.sa2 = SetAbstraction(128, 0.4, 64, 3 + 128, (128, width))
        self.sa3 = SetAbstraction(None, None, None, 3 + width, (width,),
                                  group_all=True)

    def forward(self, xyz):
        l1_xyz, l1 = self.sa1(xyz, None)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        _, l3 = self.sa3(l2_xyz, l2)
        return l3[:, 0]
