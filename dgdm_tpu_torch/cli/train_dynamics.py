"""Dynamics-model training CLI — port of ``dgdm_tpu/cli/train_dynamics.py``
(counterpart of the reference ``dynamics/main.py`` +
``dynamics/train_dynamics_2d.sh``), on one device.

Example:
    python -m dgdm_tpu_torch.cli.train_dynamics --data_dir data/sim2d \\
        --test_data_dir data/sim2d_val --save_dir runs/dyn2d \\
        --num_epochs 100 --batch_size 4
(batch_size counts PAIRS; each pair expands to grid_size*num_pos^2 rows like
the reference's in-loop reshape, dynamics/main.py:143-147.)

Data parallel over N GPUs: start N processes with the environment contract
of ``parallel/distributed.py`` (one process a GPU). ``--batch_size`` is
then the global batch: every rank builds it from the same seed and keeps
its block of rows (``parallel/mesh.shard_global_batch``), the model trains
under DDP with BatchNorm on the global statistics, and rank 0 writes the
metrics and checkpoints.

Writes ``metrics.jsonl`` (``train/loss``, ``train/acc_*``,
``perf/rows_per_second``, ``val/*``) and checkpoint directories
``ckpt/step_<n>``, ``ckpt/best`` and ``ckpt/last`` (``train/checkpoints.py``;
``cli/sample.py --checkpoint_path`` reads them as they are). ``main``
returns a summary: steps, rows/s over the training iterations (batch
loading, upload and step, synchronised; validation and checkpoints left
out), the first and last losses and the host seconds spent loading
batches.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from dgdm_tpu_torch.core.flags import build_parser
from dgdm_tpu_torch.core.profiling import StepTimer, TraceWindow
from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.parallel import mesh as meshlib
from dgdm_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    rank,
)
from dgdm_tpu_torch.train import checkpoints
from dgdm_tpu_torch.train.data import DynamicsData, to_device
from dgdm_tpu_torch.train.dynamics import DynamicsTrainer
from dgdm_tpu_torch.train.logging import MetricSink


def main(argv=None):
    args = build_parser().parse_args(argv)
    maybe_initialize_distributed()
    device = torch.device(args.device)
    # float32 products in TF32 (cuBLAS, cuDNN): the JAX trainers' float32
    # products run at XLA's default precision (one bfloat16 pass on a TPU)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    train_data = DynamicsData(args.data_dir, args.object_max_num_vertices,
                              mirror_augment=args.mirror_augment)
    val_data = DynamicsData(args.test_data_dir, args.object_max_num_vertices)
    if len(train_data) == 0:
        raise ValueError(f"no npz shards under {args.data_dir!r}")

    torch.manual_seed(args.seed)
    model = ProfileForward2D(params_ch=args.ctrlpts_dim,
                             object_ch=2 * args.object_max_num_vertices)
    steps_per_epoch = max(1, len(train_data) // max(args.batch_size, 1))
    # data parallelism over every process (reference: dynamics/trainer.py
    # wraps every run in DataParallel)
    mesh = meshlib.data_parallel_mesh()
    if mesh is not None and rank() == 0:
        print(f"data-parallel over {mesh.size('dp')} devices", flush=True)
    trainer = DynamicsTrainer(
        model,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        total_steps=args.num_epochs * steps_per_epoch,
        num_train_timesteps=args.num_train_timesteps,
        warmup_steps=args.lr_warmup_steps,
        bf16=args.bf16,
        device=device,
        seed=args.seed + 1,
        mesh=mesh,
    )
    rng = np.random.RandomState(args.seed)
    # the JAX CLI initialises from this first batch; drawing it keeps the
    # shard order of every later epoch the same as there
    next(train_data.batches(args.batch_size, rng))
    if args.checkpoint_path:
        checkpoints.restore(args.checkpoint_path, trainer)

    sink = MetricSink(args.save_dir, project="dynamics_model",
                      run_name=args.wandb_id)

    def local(batch):
        """This rank's block of a global batch, on the device."""
        return to_device(meshlib.shard_global_batch(mesh, batch), device)

    def run_eval():
        ms = [trainer.eval_step(local(b))
              for b in val_data.batches(args.batch_size, rng, shuffle=False)]
        return {f"val/{m}": float(np.mean([float(x[m]) for x in ms]))
                for m in ms[0]} if ms else {}

    if args.mode == "validate":
        vm = run_eval()
        print(vm)
        sink.close()
        return vm

    def save(name):
        checkpoints.save(os.path.join(args.save_dir, "ckpt", name), trainer)

    best_val = float("inf")
    last_best = 0
    step = rows_seen = 0
    losses = []
    data_s = loop_s = 0.0
    timer = StepTimer(device=device)
    tracer = TraceWindow(args.profile_dir)
    t0 = time.perf_counter()
    try:
        for epoch in range(args.num_epochs):
            batches = train_data.batches(args.batch_size, rng)
            while True:
                t = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                rows = batch["ctrl"].shape[0]
                batch = local(batch)
                data_s += time.perf_counter() - t
                tracer.step(step)
                metrics = trainer.train_step(batch)
                step += 1
                rows_seen += rows
                losses.append(float(metrics["loss"]))
                timer.tick(rows)
                loop_s += time.perf_counter() - t
                if step % 20 == 0:
                    sink.log({f"train/{m}": v for m, v in metrics.items()},
                             step)
                    sink.log({"perf/rows_per_second": timer.rate()}, step)
                if step % args.save_ckpt_step == 0:
                    save(f"step_{step}")
            if epoch % args.val_step == 0 and len(val_data) > 0:
                vm = run_eval()
                sink.log(vm, step)
                if vm.get("val/loss", float("inf")) < best_val:
                    best_val = vm["val/loss"]
                    save("best")
                    last_best = epoch
                elif epoch - last_best >= args.patience:
                    print("early stopping")
                    break
    finally:
        tracer.close()
    train_s = time.perf_counter() - t0
    save("last")
    sink.close()
    return {"steps": step, "rows_per_second": rows_seen / max(loop_s, 1e-9),
            "rows_per_second_ewma": timer.rate(),
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "best_val_loss": best_val, "train_s": train_s, "loop_s": loop_s,
            "data_s": data_s}


if __name__ == "__main__":
    main()
