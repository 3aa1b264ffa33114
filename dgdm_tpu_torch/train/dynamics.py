"""Dynamics-model training — port of ``dgdm_tpu/train/dynamics.py``
(reference ``dynamics/trainer.py:53-103``).

The control points are DDIM-noised at a random train timestep before the
forward pass (what makes the net usable as a guidance classifier on noisy
samples), the timestep is rescaled to [0, 1], the loss is MSE against the
whitened profile entry, the optimizer Adam(0.9, 0.95) with L2 weight decay
and cosine annealing to 1e-2 of the base LR. Accuracy metrics are the
reference's 3-class (negative / none / positive vs threshold/std).

The JAX step draws t and the noise from a PRNG key, which torch cannot
reproduce: here ``draw`` takes them from the trainer's ``torch.Generator``
and ``step`` takes them as arguments, so a test can hand it the JAX side's
draws. BatchNorm trains as flax's does (``models/profile2d.BatchNorm``).
With ``bf16`` the Linear layers compute in bfloat16 under autocast while
parameters, BatchNorm statistics and the head stay float32, as the flax
model's ``dtype=bfloat16`` does.

With a dp ``mesh`` (``parallel/mesh.py``) the model trains under
``DistributedDataParallel`` on this rank's block of the global batch, as
the JAX trainer's state is replicated and its batch sharded: every rank
draws the global batch's t and noise and keeps its block, BatchNorm takes
the global statistics, and the metrics are global-batch means. Adam and
the parameters stay equal on every rank; ``state_dict`` holds the inner
module's keys.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dgdm_tpu_torch.core.config import DIFFUSION, NORM
from dgdm_tpu_torch.diffusion import ddim
from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.parallel.mesh import (
    global_draw,
    mean_over_dp,
    wrap_data_parallel,
)
from dgdm_tpu_torch.train.data import to_device
from dgdm_tpu_torch.train.schedule import adam, cosine_lr

ROW_KEYS = ("ctrl", "ori", "pos", "obj", "score")


class DynamicsTrainer:
    """Owns the classifier (``ProfileForward2D`` or ``ProfileForward3D``),
    its optimizer and LR schedule, the update count and a generator."""

    def __init__(
        self,
        model: Optional[torch.nn.Module] = None,
        learning_rate: float = 1e-4,
        weight_decay: float = 0.0,
        total_steps: int = 100_000,
        num_train_timesteps: int = DIFFUSION.num_train_timesteps,
        fingers_3d: bool = False,
        warmup_steps: int = 0,
        bf16: bool = False,
        device="cuda",
        seed: int = 0,
        mesh=None,
    ):
        self.device = torch.device(device)
        self.model = (model or ProfileForward2D()).to(self.device)
        self.mesh = mesh
        # the module that trains: DDP over the dp group, or the model
        self.net = wrap_data_parallel(mesh, self.model, self.device)
        self.sched = ddim.make_schedule(num_train_timesteps)
        self.num_train_timesteps = num_train_timesteps
        self.fingers_3d = fingers_3d
        self.bf16 = bf16
        self.threshold_std = torch.tensor(NORM.threshold_std(fingers_3d),
                                          dtype=torch.float32,
                                          device=self.device)
        self.lr = cosine_lr(learning_rate, total_steps, warmup_steps,
                            end_value=0.01 * learning_rate)
        self.opt, self.lr_sched = adam(self.model.parameters(), learning_rate,
                                       self.lr, betas=(0.9, 0.95),
                                       weight_decay=weight_decay)
        self.step_count = 0
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

    # -- randomness and inputs ----------------------------------------------

    def draw(self, rows: int, ctrl_dim: int):
        """(t (rows,) int64 in [0, T), noise (rows, ctrl_dim)) from the
        trainer's generator."""
        t = torch.randint(0, self.num_train_timesteps, (rows,),
                          generator=self.rng, device=self.device)
        noise = torch.randn((rows, ctrl_dim), generator=self.rng,
                            device=self.device)
        return t, noise

    def _draw_block(self, rows: int, ctrl_dim: int):
        """This rank's block of the global batch's draws (all of them
        without a dp mesh)."""
        return global_draw(self.mesh, rows,
                           lambda n: self.draw(n, ctrl_dim))

    def _inputs(self, batch, t, noise):
        # ctrl is the y-vector of the control points in 2D and 3D alike, so
        # noising all of it is the reference's y-row-only noising
        noisy = ddim.add_noise(self.sched, batch["ctrl"], noise, t)
        t_rescaled = t.to(torch.float32) / self.num_train_timesteps
        return noisy, t_rescaled

    def _forward(self, batch, noisy, t_rescaled, net=None):
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
            return (net or self.model)(noisy, batch["ori"], batch["pos"], t_rescaled,
                              batch["obj"])

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        if torch.is_tensor(batch["ctrl"]):
            return batch
        return to_device({k: batch[k] for k in ROW_KEYS}, self.device)

    # -- steps ----------------------------------------------------------------

    def step(self, batch, t, noise) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (dict of row tensors; with a dp mesh,
        this rank's block) with the given timesteps and noise -> metrics
        (0-d tensors; global-batch means)."""
        batch = self._batch(batch)
        self.model.train()
        noisy, tr = self._inputs(batch, t, noise)
        pred = self._forward(batch, noisy, tr, self.net)
        loss = torch.mean((pred - batch["score"]) ** 2)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.lr_sched.step()
        self.step_count += 1
        pred = pred.detach()
        return mean_over_dp(self.mesh, {
            "loss": loss.detach(),
            **self.class_accuracy(pred, batch["score"])})

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        batch = self._batch(batch)
        return self.step(batch, *self._draw_block(*batch["ctrl"].shape))

    @torch.no_grad()
    def eval_step(self, batch, t=None, noise=None) -> Dict[str, torch.Tensor]:
        """Eval-mode loss and accuracies; t and noise drawn when not given."""
        batch = self._batch(batch)
        if t is None:
            t, noise = self._draw_block(*batch["ctrl"].shape)
        noisy, tr = self._inputs(batch, t, noise)
        was = self.model.training
        self.model.eval()
        pred = self._forward(batch, noisy, tr)
        self.model.train(was)
        loss = torch.mean((pred - batch["score"]) ** 2)
        return mean_over_dp(self.mesh, {
            "loss": loss, **self.class_accuracy(pred, batch["score"])})

    def class_accuracy(self, pred, score) -> Dict[str, torch.Tensor]:
        """3-class accuracy per axis (dynamics/main.py:151-153, vectorized)."""
        th = self.threshold_std

        def cls(x):
            return torch.where(x > th, 2, torch.where(x < -th, 0, 1))

        eq = (cls(pred) == cls(score)).to(torch.float32).mean(dim=0)
        return {"acc_ori": eq[0], "acc_x": eq[1], "acc_y": eq[2]}

    def apply_eval(self, ctrl, ori, pos, t, obj):
        """Frozen forward (the guidance classifier path): eval-mode batch
        statistics, nothing updated."""
        was = self.model.training
        self.model.eval()
        try:
            return self.model(ctrl, ori, pos, t, obj)
        finally:
            self.model.train(was)

    # -- checkpoint state -------------------------------------------------------

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.opt.state_dict(),
                "lr_schedule": self.lr_sched.state_dict(),
                "step": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.lr_sched.load_state_dict(state["lr_schedule"])
        self.step_count = int(state["step"])

    def inference_model(self) -> torch.nn.Module:
        """The module whose weights (with running statistics) a checkpoint's
        ``model.npz`` holds."""
        return self.model
