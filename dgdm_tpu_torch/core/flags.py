"""Shared CLI flag parser — port of ``dgdm_tpu/core/flags.py``.

``build_parser`` and ``parse`` with the same names and defaults, plus
``--device`` (``cuda`` unless the caller asks for the CPU).
``--use_pallas``/``--no_pallas`` keep their names: in the port they are
accepted for command-line compatibility and the hand-written CUDA kernels
always run on a CUDA device.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--sub_bs", type=int, default=1024,
                   help="pose-axis chunk size (the principled sub-batch)")
    p.add_argument("--num_epochs", type=int, default=1000)
    p.add_argument("--num_fingers", type=int, default=1000)
    p.add_argument("--ctrlpts_dim", type=int, default=14)
    p.add_argument("--ctrlpts_x_dim", type=int, default=7)
    p.add_argument("--ctrlpts_z_dim", type=int, default=3)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--patience", type=int, default=500)
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="dynamics model: a checkpoint directory of "
                        "cli/train_dynamics (ckpt/best, ckpt/last, "
                        "ckpt/step_<n>) or a weights .npz from "
                        "models/convert.py (sample CLI)")
    p.add_argument("--save_dir", type=str, default="runs/out")
    p.add_argument("--wandb_id", type=str, default=None)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--test_data_dir", type=str, default="")
    p.add_argument("--object_dir", type=str, default="",
                   help="Icons-50.npy path (2D) or scanned-object dir (3D)")
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test", "validate"])
    p.add_argument("--grid_size", type=int, default=360)
    p.add_argument("--num_pos", type=int, default=5)
    p.add_argument("--save_ckpt_step", type=int, default=1000)
    p.add_argument("--val_step", type=int, default=1)
    p.add_argument("--num_train_timesteps", type=int, default=15)
    p.add_argument("--num_inference_steps", type=int, default=5)
    p.add_argument("--ema_power", type=float, default=0.85)
    p.add_argument("--object_max_num_vertices", type=int, default=100)
    p.add_argument("--diffusion_checkpoint_path", type=str, default=None,
                   help="diffusion UNet: a checkpoint directory of "
                        "cli/train_diffusion (ckpt/last, ckpt/best_e<n>, "
                        "ckpt/step_<n>) or an (EMA) weights .npz from "
                        "models/convert.py (sample CLI)")
    p.add_argument("--classifier_guidance", action="store_true")
    p.add_argument("--fingers_3d", action="store_true")
    p.add_argument("--render_video", action="store_true")
    p.add_argument("--objectives", type=str, default="",
                   help="comma-separated subset of the guided objectives "
                        "(default: all 12, generator/diffusion.py:307)")
    p.add_argument("--num_test_objects", type=int, default=0,
                   help="limit the test-object set (0 = all)")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="override sim-eval rollout length (0 = reference "
                        "schedule: 8k steps 2D / 32k 3D)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pairs_per_batch", type=int, default=32,
                   help="gripper x object pairs per device batch (datagen)")
    p.add_argument("--use_pallas", action="store_true", default=True)
    p.add_argument("--no_pallas", dest="use_pallas", action="store_false")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bfloat16 compute for NN training (params stay f32)")
    p.add_argument("--no_bf16", dest="bf16", action="store_false")
    p.add_argument("--mirror_augment", action="store_true",
                   help="2D dynamics: double the dataset with the exact "
                        "y-axis mirror symmetry")
    p.add_argument("--profile_dir", type=str, default="",
                   help="capture a torch.profiler trace of steady-state "
                        "train steps 3-8 into this directory; empty "
                        "disables")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run: 'cuda' (hand-written "
                        "kernels) or 'cpu' (their plain PyTorch versions)")
    return p


def parse(argv=None):
    return build_parser().parse_args(argv)
