"""Conditional 1-D UNet noise-prediction network — port of
``dgdm_tpu/models/unet1d.py`` (the diffusion-policy ``ConditionalUnet1D``
of ``generator/diffusion_utils.py:123-285``): Conv1d + GroupNorm + Mish
blocks, FiLM-conditioned residual blocks, strided-conv down / transposed-conv
up path with skip concatenation, sinusoidal diffusion-step encoder.

The public layout stays the JAX package's (B, L, C) channels-last; inside,
convolutions run on torch's (B, C, L). Details that make the two agree:
GroupNorm eps is flax's 1e-6; flax ``ConvTranspose((4,), strides=2,
padding="SAME")`` is ``ConvTranspose1d(4, stride=2, padding=1)`` with the
kernel flipped (``models/convert.py`` flips it when carrying weights
across). Sub-module order follows flax's creation order so that
``convert.py`` maps ``FiLMResBlock_i`` to ``res_blocks[i]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from perfbench.reference.embeddings import mish, sinusoidal_pos_emb

GROUPNORM_EPS = 1e-6      # flax.linen.GroupNorm default


class Conv1dBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel_size: int = 5,
                 n_groups: int = 8):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, features, kernel_size,
                              padding=kernel_size // 2)
        self.norm = nn.GroupNorm(n_groups, features, eps=GROUPNORM_EPS)

    def forward(self, x):                                 # (B, C, L)
        return mish(self.norm(self.conv(x)))


class FiLMResBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, cond_dim: int,
                 kernel_size: int = 5, n_groups: int = 8):
        super().__init__()
        self.block0 = Conv1dBlock(in_ch, features, kernel_size, n_groups)
        self.film = nn.Linear(cond_dim, 2 * features)
        self.block1 = Conv1dBlock(features, features, kernel_size, n_groups)
        self.res_conv = (nn.Conv1d(in_ch, features, 1)
                         if in_ch != features else None)
        self.features = features

    def forward(self, x, cond):                           # x (B, C, L)
        out = self.block0(x)
        scale_bias = self.film(mish(cond))[:, :, None]    # (B, 2F, 1)
        scale, bias = scale_bias[:, : self.features], scale_bias[:, self.features:]
        out = scale * out + bias
        out = self.block1(out)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return out + x


class ConditionalUnet1D(nn.Module):
    def __init__(self, input_dim: int = 1, down_dims: Sequence[int] = (128, 256),
                 diffusion_step_embed_dim: int = 32, kernel_size: int = 5,
                 n_groups: int = 8):
        super().__init__()
        self.config = dict(input_dim=input_dim, down_dims=list(down_dims),
                           diffusion_step_embed_dim=diffusion_step_embed_dim,
                           kernel_size=kernel_size, n_groups=n_groups)
        dsed = diffusion_step_embed_dim
        self.dsed = dsed
        self.time_in = nn.Linear(dsed, dsed * 4)
        self.time_out = nn.Linear(dsed * 4, dsed)
        dims = list(down_dims)
        blocks, downs, ups = [], [], []
        ch = input_dim
        for i, dim in enumerate(dims):
            blocks += [FiLMResBlock(ch, dim, dsed, kernel_size, n_groups),
                       FiLMResBlock(dim, dim, dsed, kernel_size, n_groups)]
            ch = dim
            if i < len(dims) - 1:
                downs.append(nn.Conv1d(dim, dim, 3, stride=2, padding=1))
        blocks += [FiLMResBlock(ch, dims[-1], dsed, kernel_size, n_groups),
                   FiLMResBlock(dims[-1], dims[-1], dsed, kernel_size,
                                n_groups)]
        ch = dims[-1]
        skip_chs = list(dims)
        for dim in reversed(dims[:-1]):
            skip = skip_chs.pop()
            blocks += [FiLMResBlock(ch + skip, dim, dsed, kernel_size,
                                    n_groups),
                       FiLMResBlock(dim, dim, dsed, kernel_size, n_groups)]
            ups.append(nn.ConvTranspose1d(dim, dim, 4, stride=2, padding=1))
            ch = dim
        self.res_blocks = nn.ModuleList(blocks)
        self.downs = nn.ModuleList(downs)
        self.ups = nn.ModuleList(ups)
        self.final_block = Conv1dBlock(ch, dims[0], kernel_size, n_groups)
        self.final_conv = nn.Conv1d(dims[0], input_dim, 1)
        self.n_down = len(dims)

    def forward(self, sample: torch.Tensor, timestep: torch.Tensor):
        """sample (B, L, input_dim); timestep (B,) -> (B, L, input_dim)."""
        t = sinusoidal_pos_emb(timestep.to(torch.float32), self.dsed)
        cond = self.time_out(mish(self.time_in(t)))
        x = sample.transpose(1, 2)                        # (B, C, L)
        blocks = iter(self.res_blocks)
        skips = []
        for i in range(self.n_down):
            x = next(blocks)(x, cond)
            x = next(blocks)(x, cond)
            skips.append(x)
            if i < self.n_down - 1:
                x = self.downs[i](x)
        x = next(blocks)(x, cond)
        x = next(blocks)(x, cond)
        for up in self.ups:
            x = torch.cat([x, skips.pop()], dim=1)
            x = next(blocks)(x, cond)
            x = next(blocks)(x, cond)
            x = up(x)
        x = self.final_block(x)
        return self.final_conv(x).transpose(1, 2)
