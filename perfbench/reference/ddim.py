"""DDIM scheduler as pure functions — port of ``dgdm_tpu/diffusion/ddim.py``.

Math parity with diffusers' ``DDIMScheduler`` as configured by the reference
(``generator/train.py:83``): ``num_train_timesteps=15,
beta_schedule='squaredcos_cap_v2', clip_sample=True,
prediction_type='epsilon'``, ``set_timesteps(5)`` with 'leading' spacing
and eta=0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class DDIMSchedule(NamedTuple):
    num_train_timesteps: int
    betas: torch.Tensor               # (T,) float32
    alphas_cumprod: torch.Tensor      # (T,) float32
    final_alpha_cumprod: float        # 1.0 (set_alpha_to_one default)
    clip_sample: bool


def squaredcos_cap_v2_betas(num_timesteps: int,
                            max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(t):
        return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

    betas = []
    for i in range(num_timesteps):
        t1 = i / num_timesteps
        t2 = (i + 1) / num_timesteps
        betas.append(min(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.asarray(betas, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def make_schedule(num_train_timesteps: int = 15,
                  clip_sample: bool = True) -> DDIMSchedule:
    betas = squaredcos_cap_v2_betas(num_train_timesteps)
    alphas_cumprod = np.cumprod(1.0 - betas)
    return DDIMSchedule(
        num_train_timesteps=num_train_timesteps,
        betas=torch.as_tensor(betas, dtype=torch.float32),
        alphas_cumprod=torch.as_tensor(alphas_cumprod, dtype=torch.float32),
        final_alpha_cumprod=1.0,
        clip_sample=clip_sample,
    )


def inference_timesteps(num_train_timesteps: int,
                        num_inference_steps: int) -> np.ndarray:
    """diffusers 'leading' spacing: e.g. 15 train / 5 inference -> [12,9,6,3,0]."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round().astype(np.int64)
    return ts[::-1].copy()


def prev_timesteps(num_train_timesteps: int,
                   num_inference_steps: int) -> np.ndarray:
    """prev_t for each inference timestep (diffusers: t - T // n)."""
    ts = inference_timesteps(num_train_timesteps, num_inference_steps)
    return ts - num_train_timesteps // num_inference_steps


def alpha_cumprod(sched: DDIMSchedule, t: int, device=None) -> torch.Tensor:
    """abar_t as a float32 scalar tensor (final_alpha_cumprod for t < 0)."""
    if t < 0:
        return torch.tensor(sched.final_alpha_cumprod, dtype=torch.float32,
                            device=device)
    return sched.alphas_cumprod[t].to(device)


def ddim_step(sched: DDIMSchedule, noise_pred: torch.Tensor, timestep: int,
              prev_timestep: int, sample: torch.Tensor) -> torch.Tensor:
    """One deterministic (eta=0) DDIM update, epsilon prediction, clip_sample.

    ``prev_timestep`` may be negative, selecting final_alpha_cumprod = 1."""
    abar_t = alpha_cumprod(sched, int(timestep), sample.device)
    abar_prev = alpha_cumprod(sched, int(prev_timestep), sample.device)
    x0 = (sample - torch.sqrt(1.0 - abar_t) * noise_pred) / torch.sqrt(abar_t)
    if sched.clip_sample:
        x0 = torch.clamp(x0, -1.0, 1.0)
    # diffusers 0.11.1 (the reference pin) uses the RAW model output for the
    # direction term even when x0 was clipped
    return torch.sqrt(abar_prev) * x0 + torch.sqrt(1.0 - abar_prev) * noise_pred
