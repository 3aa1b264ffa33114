"""Embedding functions shared by the dynamics and diffusion models — port of
``dgdm_tpu/models/embeddings.py``.

Two sinusoidal conventions of the reference are kept:

- ``timestep_embedding`` (dynamics nets): freqs = exp(-ln(10000) k / half),
  concat(cos, sin).
- ``sinusoidal_pos_emb`` (diffusion UNet): freqs = exp(-ln(10000) k /
  (half - 1)), concat(sin, cos).

``nerf_embed`` is the NeRF positional encoding of the pose inputs.
"""

from __future__ import annotations

import math

import torch


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """t (...,) -> (..., dim). cos-first layout like the reference."""
    half = dim // 2
    k = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * k / half)
    args = t[..., None].to(torch.float32) * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


def sinusoidal_pos_emb(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """t (...,) -> (..., dim). sin-first, /(half-1) layout (diffusion-policy)."""
    half = dim // 2
    k = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * k / (half - 1))
    args = t[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def nerf_embed(x: torch.Tensor, multires: int = 4) -> torch.Tensor:
    """x (..., d) -> (..., d * (1 + 2*multires)): [x, sin(2^k x), cos(2^k x)]."""
    out = [x]
    for k in range(multires):
        freq = float(2**k)
        out.append(torch.sin(x * freq))
        out.append(torch.cos(x * freq))
    return torch.cat(out, dim=-1)


def nerf_embed_dim(input_dim: int, multires: int = 4) -> int:
    return input_dim * (1 + 2 * multires)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(torch.log1p(torch.exp(x)))
