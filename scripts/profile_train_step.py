"""Where a training step of the port's two trainers spends its time on the
card.

Runs ``DynamicsTrainer`` (ProfileForward2D at full width: 256 wide, 8 trunk
layers, object_ch 200; 36,000 rows a step = 4 pairs of the 9,000-pose grid;
bf16 as ``cli.train_dynamics`` runs it) and ``GeneratorTrainer`` (UNet
down_dims (128, 256); 2,048 grippers a step) on random inputs that already
lie on the card, so no host data loading is in the step. For each it prints
the synchronised milliseconds a step with cuDNN/cuBLAS TF32 off (what
``chip_smoke.py`` sets) and on (torch's default for convolutions), then a
``torch.profiler`` window of 5 steps: the kernels with the most device time
and the share of the window's wall time in which the card ran a kernel.

    python scripts/profile_train_step.py [--out profile_train_step.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dgdm_tpu_torch.models.profile2d import ProfileForward2D  # noqa: E402
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D  # noqa: E402
from dgdm_tpu_torch.train.dynamics import DynamicsTrainer  # noqa: E402
from dgdm_tpu_torch.train.generator import GeneratorTrainer  # noqa: E402


def _batches(dev):
    g = torch.Generator(device=dev).manual_seed(0)

    def u(*shape):
        return torch.rand(shape, generator=g, device=dev) * 2 - 1

    rows = 36_000
    dyn = {"ctrl": u(rows, 14), "ori": u(rows, 1), "pos": u(rows, 2),
           "obj": u(1, 200).expand(rows, 200).contiguous(),
           "score": torch.randn(rows, 3, generator=g, device=dev)}
    return dyn, u(2048, 14, 1)


def _ms_per_step(trainer, batch, steps: int) -> float:
    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def _profile(trainer, batch, steps: int = 5) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = []
    for e in prof.key_averages():
        # the kernels themselves (an operator's entry repeats its kernels'
        # time)
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            kernels.append((dev_us, e.count, e.key))
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    return {"wall_ms_per_step": wall_us / 1e3 / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / wall_us,
            "top": [{"us_per_step": k[0] / steps, "calls_per_step":
                     k[1] / steps, "name": k[2][:90]} for k in kernels[:8]]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="", help="write the numbers as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.manual_seed(0)
    dyn_batch, gen_batch = _batches(dev)
    trainers = {
        "dynamics (36,000 rows, bf16)": (DynamicsTrainer(
            ProfileForward2D(), bf16=True, device=dev), dyn_batch),
        "diffusion (2,048 grippers)": (GeneratorTrainer(
            ConditionalUnet1D(), device=dev), gen_batch),
    }
    out = {"card": torch.cuda.get_device_name(0)}
    for name, (tr, batch) in trainers.items():
        res = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            res[f"ms_per_step_tf32_{'on' if tf32 else 'off'}"] = \
                _ms_per_step(tr, batch, 10)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        res["profile_tf32_off"] = _profile(tr, batch)
        out[name] = res
        prof = res["profile_tf32_off"]
        print(f"{name}: {res['ms_per_step_tf32_off']:.2f} ms/step with TF32 "
              f"off, {res['ms_per_step_tf32_on']:.2f} with TF32 on; profiled "
              f"(TF32 off): {prof['wall_ms_per_step']:.2f} ms/step wall, "
              f"{prof['device_ms_per_step']:.2f} ms of kernels "
              f"({100 * prof['device_busy_share']:.1f}% busy)", flush=True)
        for k in prof["top"]:
            print(f"    {k['us_per_step']:9.1f} us/step "
                  f"{k['calls_per_step']:5.1f} calls  {k['name']}",
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
