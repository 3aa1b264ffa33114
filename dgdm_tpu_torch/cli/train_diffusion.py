"""Diffusion-generator training CLI — port of
``dgdm_tpu/cli/train_diffusion.py`` (counterpart of the reference
``generator/train.py`` + ``generator/train_diffusion_2d.sh``: 200k
procedural grippers, batch 2048, 1000 epochs, DDIM 15 train timesteps, EMA
power 0.85).

Example:
    python -m dgdm_tpu_torch.cli.train_diffusion --num_fingers 200000 \\
        --batch_size 2048 --num_epochs 1000 --save_dir runs/diff2d

Data parallel over N GPUs: start N processes with the environment contract
of ``parallel/distributed.py``; ``--batch_size`` is the global batch, each
rank keeping its block (``parallel/mesh.shard_global_batch``), and rank 0
writes the metrics and checkpoints.

The procedural training set lives on the device for the whole run (it is a
few MB); each epoch's batches follow ``RandomState(seed).permutation`` as in
the JAX CLI. Writes ``metrics.jsonl`` (``train/*``,
``perf/grippers_per_second``, ``val/*`` with the reconstruction metrics),
the ten best checkpoints by validation loss (``ckpt/best_e<epoch>``, stale
ones deleted), ``ckpt/step_<n>`` every 50 epochs and ``ckpt/last``
(``train/checkpoints.py``; ``cli/sample.py --diffusion_checkpoint_path``
reads them as they are). ``main`` returns a summary: grippers/s over the
training iterations (synchronised; validation and checkpoints left out),
the losses, and the seconds of building the set and of batch gathering.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from dgdm_tpu_torch.core.flags import build_parser
from dgdm_tpu_torch.core.profiling import StepTimer, TraceWindow
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
from dgdm_tpu_torch.parallel import mesh as meshlib
from dgdm_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    rank,
)
from dgdm_tpu_torch.train import checkpoints
from dgdm_tpu_torch.train.data import procedural_grippers, to_device
from dgdm_tpu_torch.train.generator import GeneratorTrainer
from dgdm_tpu_torch.train.logging import MetricSink


def main(argv=None):
    args = build_parser().parse_args(argv)
    maybe_initialize_distributed()
    device = torch.device(args.device)
    # float32 products in TF32 (cuBLAS, cuDNN): the JAX trainers' float32
    # products run at XLA's default precision (one bfloat16 pass on a TPU)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    t = time.perf_counter()
    train, val = procedural_grippers(args.num_fingers, args.fingers_3d)
    train_dev = to_device(train, device)
    setup_s = time.perf_counter() - t
    torch.manual_seed(args.seed)
    model = ConditionalUnet1D(input_dim=1)
    steps_per_epoch = max(1, len(train) // args.batch_size)
    mesh = meshlib.data_parallel_mesh()
    if mesh is not None and rank() == 0:
        print(f"data-parallel over {mesh.size('dp')} devices", flush=True)
    trainer = GeneratorTrainer(
        model,
        learning_rate=args.learning_rate,
        total_steps=args.num_epochs * steps_per_epoch,
        num_train_timesteps=args.num_train_timesteps,
        ema_power=args.ema_power,
        warmup_steps=args.lr_warmup_steps,
        device=device,
        seed=args.seed + 1,
        mesh=mesh,
    )
    if args.diffusion_checkpoint_path:
        checkpoints.restore(args.diffusion_checkpoint_path, trainer)

    sink = MetricSink(args.save_dir, project="gripper_diffusion",
                      run_name=args.wandb_id)
    rng = np.random.RandomState(args.seed)
    step = 0
    best: list = []  # (val_loss, path) top-k checkpoints
    losses = []
    data_s = loop_s = 0.0
    timer = StepTimer(device=device)
    tracer = TraceWindow(args.profile_dir)
    t0 = time.perf_counter()
    try:
        for epoch in range(args.num_epochs):
            order = rng.permutation(len(train))
            for lo in range(0, len(order) - args.batch_size + 1,
                            args.batch_size):
                t = time.perf_counter()
                idx = meshlib.shard_global_batch(
                    mesh, torch.from_numpy(order[lo: lo + args.batch_size]))
                batch = train_dev[idx.to(device)]
                data_s += time.perf_counter() - t
                tracer.step(step)
                metrics = trainer.train_step(batch)
                step += 1
                losses.append(float(metrics["loss"]))
                timer.tick(args.batch_size)
                loop_s += time.perf_counter() - t
                if step % 50 == 0:
                    sink.log({f"train/{m}": v for m, v in metrics.items()},
                             step)
                    sink.log({"perf/grippers_per_second": timer.rate()}, step)
            if epoch % args.val_step == 0 and len(val) >= args.batch_size:
                vbatch = to_device(meshlib.shard_global_batch(
                    mesh, val[: args.batch_size]), device)
                vm = trainer.eval_step(vbatch)
                vm.update(trainer.recon_metrics(
                    vbatch, num_inference_steps=args.num_inference_steps))
                sink.log({f"val/{m}": float(v) for m, v in vm.items()}, step)
                # top-k-by-val checkpointing (reference keeps top-10 by
                # epoch, generator/train.py:138-147)
                vloss = float(vm.get("loss", float("inf")))
                if len(best) < 10 or vloss < best[-1][0]:
                    path = os.path.join(args.save_dir, "ckpt",
                                        f"best_e{epoch}")
                    checkpoints.save(path, trainer)
                    best.append((vloss, path))
                    best.sort(key=lambda b: b[0])
                    for _, stale in best[10:]:
                        if rank() == 0:
                            shutil.rmtree(stale, ignore_errors=True)
                    best = best[:10]
            if (epoch + 1) % 50 == 0:
                checkpoints.save(
                    os.path.join(args.save_dir, "ckpt", f"step_{step}"),
                    trainer)
    finally:
        tracer.close()
    train_s = time.perf_counter() - t0
    checkpoints.save(os.path.join(args.save_dir, "ckpt", "last"), trainer)
    sink.close()
    return {"steps": step,
            "grippers_per_second": step * args.batch_size / max(loop_s, 1e-9),
            "grippers_per_second_ewma": timer.rate(),
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "best": [b[1] for b in best], "train_s": train_s,
            "loop_s": loop_s, "data_s": data_s, "setup_s": setup_s}


if __name__ == "__main__":
    main()
