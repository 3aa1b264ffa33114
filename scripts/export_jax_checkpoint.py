"""Export an orbax checkpoint of a JAX trainer to the port's checkpoint
directory.

Reads a checkpoint that ``dgdm_tpu.train.checkpoints.save`` wrote for
either trainer (``DynTrainState`` of ``train/dynamics.py``, 2D or 3D, or
``GenTrainState`` of ``train/generator.py``) and writes the directory that
``dgdm_tpu_torch/train/checkpoints.py`` reads (``train_state.pt`` +
``model.npz``), so the port's training CLIs resume from it and its sample
CLI loads it:

- params, the EMA params and ``batch_stats`` go through the layout rules of
  ``dgdm_tpu_torch/models/convert.py``;
- Adam's ``mu`` / ``nu`` go through the same per-layer rules into the torch
  optimizer's ``exp_avg`` / ``exp_avg_sq``, and Adam's count into its
  ``step``;
- the trainer's ``step`` becomes the update count, and the LR schedule is
  set to that count.

The model's kind and widths are read off the parameter shapes. The LR
schedule is not stored by optax: pass the flags the JAX CLI ran with
(``--learning_rate``, ``--total_steps``, ``--weight_decay``,
``--lr_warmup_steps``, ``--ema_power``).

    JAX_PLATFORMS=cpu python scripts/export_jax_checkpoint.py \\
        --src runs/dyn2d/ckpt/best --dst runs/dyn2d_torch/best \\
        --learning_rate 1e-4 --total_steps 100000
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from dgdm_tpu_torch.models import convert  # noqa: E402
from dgdm_tpu_torch.train import checkpoints  # noqa: E402
from dgdm_tpu_torch.train.dynamics import DynamicsTrainer  # noqa: E402
from dgdm_tpu_torch.train.generator import GeneratorTrainer  # noqa: E402


def read_orbax(path: str) -> dict:
    """The saved tree as nested dicts / lists of numpy arrays."""
    raw = ocp.StandardCheckpointer().restore(os.path.abspath(path))

    def to_np(t):
        if isinstance(t, dict):
            return {k: to_np(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [to_np(v) for v in t]
        return None if t is None else np.asarray(t)

    return to_np(raw)


def model_kind(tree: dict) -> str:
    if "ema_params" in tree:
        return "unet"
    return "profile3d" if "sa1" in tree["params"]["object_encoder"] \
        else "profile2d"


def model_config(params: dict, kind: str, n_groups: int = 8) -> dict:
    """Constructor arguments of the port's module, read off the shapes."""
    if kind == "unet":
        n_down = 1 + sum(k.startswith("Downsample1d_") for k in params)
        dims = [int(params[f"FiLMResBlock_{2 * i}"]["Conv1dBlock_0"]
                    ["Conv_0"]["kernel"].shape[2]) for i in range(n_down)]
        return {"input_dim": int(params["Conv_0"]["kernel"].shape[2]),
                "down_dims": dims,
                "diffusion_step_embed_dim": int(
                    params["Dense_0"]["kernel"].shape[0]),
                "kernel_size": int(params["FiLMResBlock_0"]["Conv1dBlock_0"]
                                   ["Conv_0"]["kernel"].shape[0]),
                "n_groups": n_groups}
    head = params["head"]["kernel"]
    cfg = {"width": int(head.shape[0]), "output_ch": int(head.shape[1]),
           "params_ch": int(params["gripper_encoder"]["Dense_0"]["kernel"]
                            .shape[0])}
    if kind == "profile2d":
        cfg["object_ch"] = int(params["object_encoder"]["Dense_0"]["kernel"]
                               .shape[0])
        cfg["num_trunk"] = sum(k.startswith("trunk_") for k in params)
    return cfg


def _adam_state(opt_state) -> dict:
    (adam,) = [s for s in opt_state if isinstance(s, dict) and "mu" in s]
    return adam


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def export(src: str, dst: str, learning_rate: float = 1e-4,
           total_steps: int = 100_000, weight_decay: float = 0.0,
           warmup_steps: int = 0, ema_power: float = 0.85,
           n_groups: int = 8) -> str:
    """Convert the orbax checkpoint ``src`` into the port's directory
    ``dst``; returns the model kind."""
    tree = read_orbax(src)
    kind = model_kind(tree)
    cfg = model_config(tree["params"], kind, n_groups)
    model = convert.MODELS[kind](**cfg)
    if kind == "unet":
        trainer = GeneratorTrainer(model, learning_rate=learning_rate,
                                   total_steps=total_steps,
                                   ema_power=ema_power,
                                   warmup_steps=warmup_steps, device="cpu")
        trainer.model.load_state_dict(_tensors(
            convert.unet_state_dict(tree["params"])))
        trainer.ema.load_state_dict(_tensors(
            convert.unet_state_dict(tree["ema_params"])))
    else:
        trainer = DynamicsTrainer(
            model, learning_rate=learning_rate, weight_decay=weight_decay,
            total_steps=total_steps, fingers_3d=kind == "profile3d",
            warmup_steps=warmup_steps, device="cpu")
        to_sd = (convert.profile3d_state_dict if kind == "profile3d"
                 else convert.profile2d_state_dict)
        trainer.model.load_state_dict(_tensors(to_sd(
            {"params": tree["params"], "batch_stats": tree["batch_stats"]})))
    adam = _adam_state(tree["opt_state"])
    mu = convert.params_tree_to_torch(adam["mu"], kind)
    nu = convert.params_tree_to_torch(adam["nu"], kind)
    count = int(adam["count"])
    for name, p in trainer.model.named_parameters():
        trainer.opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(mu[name]).clone(),
            "exp_avg_sq": torch.from_numpy(nu[name]).clone()}
    step = int(tree["step"])
    trainer.step_count = step
    sched = trainer.lr_sched.state_dict()
    sched.update(last_epoch=step, _step_count=step + 1,
                 _last_lr=[trainer.lr(step)])
    trainer.lr_sched.load_state_dict(sched)
    for g in trainer.opt.param_groups:
        g["lr"] = trainer.lr(step)
    checkpoints.save(dst, trainer)
    return kind


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True, help="orbax checkpoint directory")
    p.add_argument("--dst", required=True,
                   help="the port's checkpoint directory to write")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--total_steps", type=int, default=100_000)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--ema_power", type=float, default=0.85)
    p.add_argument("--n_groups", type=int, default=8,
                   help="UNet GroupNorm groups (not visible in the shapes)")
    a = p.parse_args(argv)
    kind = export(a.src, a.dst, a.learning_rate, a.total_steps,
                  a.weight_decay, a.lr_warmup_steps, a.ema_power, a.n_groups)
    print(f"{a.src} -> {a.dst} ({kind})")


if __name__ == "__main__":
    main()
