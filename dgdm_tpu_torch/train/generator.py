"""Diffusion-generator training and sampling — port of
``dgdm_tpu/train/generator.py`` (reference Lightning module
``generator/diffusion.py:126-177, 711-728``).

Epsilon-prediction MSE at uniform random train timesteps, Adam (optax's
defaults: 0.9, 0.999, 1e-8) at 1e-4 with cosine annealing to 0, and an EMA
of the whole network stepped after every update with diffusers-0.11.1's
decay ``clamp(1 - (1 + step)^(-power), 0, 0.9999)``, power 0.85
(``generator/train_diffusion_2d.sh``), at the update count before the
increment. As in ``train/dynamics.py``, ``draw`` takes t and the noise from
the trainer's ``torch.Generator`` and ``step`` takes them as arguments.

With a dp ``mesh`` the UNet trains under ``DistributedDataParallel`` on
this rank's block of the global batch, every rank drawing the global
batch's t and noise and keeping its block (``train/dynamics.py``); the EMA
steps identically on every rank and the metrics are global-batch means.

``sample`` / ``sample_trajectory`` are unguided DDIM from noise with a given
denoiser (the trainer passes its EMA copy; ``cli/sample.py`` a loaded one).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from dgdm_tpu_torch.core.config import DIFFUSION
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.diffusion import ddim
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
from dgdm_tpu_torch.parallel.mesh import (
    global_draw,
    mean_over_dp,
    wrap_data_parallel,
)
from dgdm_tpu_torch.train.data import to_device
from dgdm_tpu_torch.train.schedule import adam, cosine_lr


def _denoise(unet, x, num_train_timesteps, num_inference_steps, on_step):
    sched = ddim.make_schedule(num_train_timesteps)
    ts = ddim.inference_timesteps(num_train_timesteps, num_inference_steps)
    pts = ddim.prev_timesteps(num_train_timesteps, num_inference_steps)
    for t, pt in zip(ts.tolist(), pts.tolist()):
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        eps = unet(x, tb)
        on_step(eps)
        x = ddim.ddim_step(sched, eps, t, pt, x)
        yield x


@TRACER.traced("generator.sample")
@torch.no_grad()
def sample(
    unet: torch.nn.Module,
    noise: torch.Tensor,
    num_train_timesteps: int = DIFFUSION.num_train_timesteps,
    num_inference_steps: int = DIFFUSION.num_inference_steps,
) -> torch.Tensor:
    """noise (B, L, 1) -> samples (B, L, 1), on the device of ``noise``."""
    x = noise
    for x in _denoise(unet, noise, num_train_timesteps, num_inference_steps,
                      lambda eps: None):
        pass
    return x


@torch.no_grad()
def sample_trajectory(
    unet: torch.nn.Module,
    noise: torch.Tensor,
    num_train_timesteps: int = DIFFUSION.num_train_timesteps,
    num_inference_steps: int = DIFFUSION.num_inference_steps,
):
    """As ``sample``, also returning the per-step samples (S+1, B, L, 1)
    including the initial noise (generator/diffusion.py:258-292)."""
    traj = [noise] + list(_denoise(unet, noise, num_train_timesteps,
                                   num_inference_steps, lambda eps: None))
    return traj[-1], torch.stack(traj)


def ema_decay(step: int, power: float = DIFFUSION.ema_power,
              max_value: float = 0.9999) -> torch.Tensor:
    """diffusers 0.11.1 EMAModel.get_decay with inv_gamma=1, min_value=0,
    in float32 as the JAX package computes it."""
    s = torch.tensor(float(step), dtype=torch.float32)
    value = 1.0 - (1.0 + s) ** (-power)
    return torch.clamp(value, 0.0, max_value)


class GeneratorTrainer:
    """Owns the UNet, its EMA copy, the optimizer and LR schedule, the
    update count and a generator."""

    def __init__(
        self,
        model: Optional[ConditionalUnet1D] = None,
        learning_rate: float = DIFFUSION.learning_rate,
        total_steps: int = 100_000,
        num_train_timesteps: int = DIFFUSION.num_train_timesteps,
        ema_power: float = DIFFUSION.ema_power,
        warmup_steps: int = 0,
        device="cuda",
        seed: int = 0,
        mesh=None,
    ):
        self.device = torch.device(device)
        self.model = (model or ConditionalUnet1D()).to(self.device)
        self.mesh = mesh
        # the module that trains: DDP over the dp group, or the model; the
        # EMA copies the parameters after DDP has broadcast rank 0's
        self.net = wrap_data_parallel(mesh, self.model, self.device)
        self.ema = copy.deepcopy(self.model).requires_grad_(False).eval()
        self.sched = ddim.make_schedule(num_train_timesteps)
        self.num_train_timesteps = num_train_timesteps
        self.ema_power = ema_power
        self.lr = cosine_lr(learning_rate, total_steps, warmup_steps)
        self.opt, self.lr_sched = adam(self.model.parameters(), learning_rate,
                                       self.lr)
        self.step_count = 0
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

    def draw(self, shape):
        """(t (B,) int64 in [0, T), noise of ``shape``) from the generator."""
        t = torch.randint(0, self.num_train_timesteps, (shape[0],),
                          generator=self.rng, device=self.device)
        noise = torch.randn(tuple(shape), generator=self.rng,
                            device=self.device)
        return t, noise

    def _draw_block(self, shape):
        """This rank's block of the global batch's draws (all of them
        without a dp mesh)."""
        return global_draw(self.mesh, shape[0],
                           lambda n: self.draw((n,) + tuple(shape[1:])))

    def _batch(self, batch) -> torch.Tensor:
        return batch if torch.is_tensor(batch) else to_device(batch,
                                                              self.device)

    def step(self, batch, t, noise) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (B, L, 1) normalized control-point y
        values (with a dp mesh, this rank's block) with the given timesteps
        and noise, then the EMA step."""
        batch = self._batch(batch)
        noisy = ddim.add_noise(self.sched, batch, noise, t)
        loss = torch.mean((self.net(noisy, t) - noise) ** 2)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.lr_sched.step()
        decay = ema_decay(self.step_count, self.ema_power)
        d = float(decay)   # the float32 value; no copy to the device
        with torch.no_grad():
            ema = list(self.ema.parameters())
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, torch._foreach_mul(
                list(self.model.parameters()), float(1.0 - decay)))
        self.step_count += 1
        return {**mean_over_dp(self.mesh, {"loss": loss.detach()}),
                "ema_decay": decay}

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        batch = self._batch(batch)
        return self.step(batch, *self._draw_block(batch.shape))

    @torch.no_grad()
    def eval_step(self, batch, t=None, noise=None) -> Dict[str, torch.Tensor]:
        batch = self._batch(batch)
        if t is None:
            t, noise = self._draw_block(batch.shape)
        noisy = ddim.add_noise(self.sched, batch, noise, t)
        return mean_over_dp(self.mesh, {
            "loss": torch.mean((self.model(noisy, t) - noise) ** 2)})

    @torch.no_grad()
    def recon_metrics(self, batch, noise=None,
                      num_inference_steps: int = DIFFUSION.num_inference_steps
                      ) -> Dict[str, torch.Tensor]:
        """Reconstruction check (reference validation_step,
        generator/diffusion.py:181-244): noise the clean batch, run the full
        inference denoise loop with the trained (not EMA) weights, and report
        the per-step noise-pred MSE, the final denoise MSE and the fraction
        of points reconstructed within 0.01.

        The reference (unintentionally) noises at train-timestep index
        ``num_inference_steps`` (=5 of 15) — a PARTIAL noising — and still
        denoises with the full schedule; kept, since the published
        validation numbers depend on it."""
        batch = self._batch(batch)
        if noise is None:
            noise, = global_draw(self.mesh, batch.shape[0], lambda n: (
                torch.randn((n,) + tuple(batch.shape[1:]), generator=self.rng,
                            device=self.device),))
        t_noise = torch.full((batch.shape[0],), num_inference_steps,
                             dtype=torch.int64, device=self.device)
        x = ddim.add_noise(self.sched, batch, noise, t_noise)
        step_mses = []
        for x in _denoise(self.model, x, self.num_train_timesteps,
                          num_inference_steps,
                          lambda eps: step_mses.append(
                              torch.mean((eps - noise) ** 2))):
            pass
        return mean_over_dp(self.mesh, {
            "noise_pred_loss": torch.stack(step_mses).mean(),
            "denoise_loss": torch.mean((x - batch) ** 2),
            "accuracy": torch.mean((torch.abs(x - batch) < 0.01)
                                   .to(torch.float32)),
        })

    def sample(self, noise,
               num_inference_steps: int = DIFFUSION.num_inference_steps):
        """Unguided DDIM from ``noise`` with the EMA weights."""
        return sample(self.ema, noise, self.num_train_timesteps,
                      num_inference_steps)

    def sample_trajectory(self, noise, num_inference_steps: int =
                          DIFFUSION.num_inference_steps):
        return sample_trajectory(self.ema, noise, self.num_train_timesteps,
                                 num_inference_steps)

    # -- checkpoint state -------------------------------------------------------

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "ema": self.ema.state_dict(),
                "optimizer": self.opt.state_dict(),
                "lr_schedule": self.lr_sched.state_dict(),
                "step": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.ema.load_state_dict(state["ema"])
        self.opt.load_state_dict(state["optimizer"])
        self.lr_sched.load_state_dict(state["lr_schedule"])
        self.step_count = int(state["step"])

    def inference_model(self) -> torch.nn.Module:
        """The EMA UNet: what a checkpoint's ``model.npz`` holds."""
        return self.ema
