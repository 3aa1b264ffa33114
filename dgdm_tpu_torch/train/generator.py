"""Unguided DDIM sampling with the (EMA) denoiser — port of
``dgdm_tpu/train/generator.py:GeneratorTrainer.sample`` (reference
``generator/diffusion.py:246-292``). The trainer itself (epsilon-MSE, Adam,
EMA) waits for the training slice of the port.
"""

from __future__ import annotations

import torch

from dgdm_tpu_torch.core.config import DIFFUSION
from dgdm_tpu_torch.diffusion import ddim


@torch.no_grad()
def sample(
    unet: torch.nn.Module,
    noise: torch.Tensor,
    num_train_timesteps: int = DIFFUSION.num_train_timesteps,
    num_inference_steps: int = DIFFUSION.num_inference_steps,
) -> torch.Tensor:
    """noise (B, L, 1) -> samples (B, L, 1), on the device of ``noise``."""
    sched = ddim.make_schedule(num_train_timesteps)
    ts = ddim.inference_timesteps(num_train_timesteps, num_inference_steps)
    pts = ddim.prev_timesteps(num_train_timesteps, num_inference_steps)
    x = noise
    for t, pt in zip(ts.tolist(), pts.tolist()):
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        x = ddim.ddim_step(sched, unet(x, tb), t, pt, x)
    return x
