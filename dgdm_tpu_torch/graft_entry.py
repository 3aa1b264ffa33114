"""Flagship entry points — port of ``__graft_entry__.py``.

``entry()`` returns one guided-denoise step on the flagship 2D
configuration and its example arguments: the UNet's epsilon for B = 16
samples, the gradient of the rotate_clockwise objective over the
360 x 5 x 5 = 9,000-pose grid through the dynamics classifier, the epsilon
correction and the DDIM update (the hot loop of the reference's
``generator/diffusion.py:571-576``). The modules are seeded ``nn.Module``s
on the device, in float32 with TF32 off.

``dryrun_multichip(n)`` starts n ranks (``parallel/launch.py``, one process
each) and runs, at tiny shapes, the four steps of the JAX package's dry
run: (1) a data-parallel dynamics training step, (2) a data-parallel
diffusion training step, (3) a guided denoise step with the pose grid
sharded over the mesh's sp axis, (4) datagen pairs split over the ranks
through ``sim/datagen.profile_pairs_2d`` (the rollout kernel on the card,
its plain version on the CPU). Ranks that share a card, or run on the CPU,
use gloo; one rank per card uses NCCL.

    python -m dgdm_tpu_torch.graft_entry [n] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _flagship_pieces(grid_size=360, num_pos=5, batch=16, width=256,
                     pose_chunks=12, unet_dims=(128, 256), device="cuda",
                     mesh=None):
    """-> GuidedSampler2D over a seeded UNet and classifier on ``device``
    (the keyword arguments are the JAX function's, ``batch`` unused as
    there: the modules take any batch). The weights are drawn on the CPU
    from seed 0, so every device gets the same ones."""
    from dgdm_tpu_torch.design.guidance import GuidedSampler2D
    from dgdm_tpu_torch.models.profile2d import ProfileForward2D
    from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D

    del batch
    torch.manual_seed(0)
    unet = ConditionalUnet1D(down_dims=tuple(unet_dims))
    classifier = ProfileForward2D(width=width, object_ch=200)
    return GuidedSampler2D(unet, classifier, grid_size=grid_size,
                           num_pos=num_pos, pose_chunks=pose_chunks,
                           device=device, mesh=mesh)


def guided_denoise_step(sampler, objective: str = "rotate_clockwise"):
    """fn(x (B, 14, 1), obj_flat (200,)) -> x at t = 9: one guided DDIM
    step from t = 12 on the 15-step schedule, guidance scale 0.001, over
    the sampler's whole pose grid."""
    from dgdm_tpu_torch.design.guidance import pose_grid_normalized

    poses = sampler._tensor(pose_grid_normalized(sampler.grid_size,
                                                 sampler.num_pos))

    def fn(x, obj_flat):
        w, sq = sampler._objective_weights(objective, None, x.shape[0])
        obj_feat = sampler._encode_object(obj_flat)
        g = sampler.cond_grad(x, 12, obj_feat, w, sq, poses)
        return sampler._guided_step(x, 12, 9, g, 0.001)

    return fn


def entry(device="cuda"):
    """-> (fn, example_args): one guided denoise step, flagship config."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sampler = _flagship_pieces(device=device)
    x = torch.zeros((16, 14, 1), dtype=torch.float32, device=device)
    obj_flat = torch.zeros((200,), dtype=torch.float32, device=device)
    return guided_denoise_step(sampler), (x, obj_flat)


def _dryrun_rank(device: str) -> dict:
    """One rank of ``dryrun_multichip`` (run under ``parallel/launch.py``)."""
    from dgdm_tpu_torch.geom.fingers import sample_gripper_2d
    from dgdm_tpu_torch.models.profile2d import ProfileForward2D
    from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
    from dgdm_tpu_torch.parallel import mesh as meshlib
    from dgdm_tpu_torch.parallel.distributed import world_size
    from dgdm_tpu_torch.sim import datagen, engine2d
    from dgdm_tpu_torch.train.dynamics import DynamicsTrainer
    from dgdm_tpu_torch.train.generator import GeneratorTrainer

    dev = torch.device(device)
    n = world_size()
    mesh = meshlib.make_mesh()
    dp_mesh = meshlib.data_parallel_mesh(min_devices=1)

    # 1) dynamics training step, the global batch split over every rank
    torch.manual_seed(0)
    dtr = DynamicsTrainer(ProfileForward2D(width=32, num_trunk=2,
                                           object_ch=20),
                          total_steps=10, device=dev, mesh=dp_mesh)
    rows = 4 * n
    batch = {"ctrl": np.zeros((rows, 14)), "ori": np.zeros((rows, 1)),
             "pos": np.zeros((rows, 2)), "obj": np.zeros((rows, 20)),
             "score": np.zeros((rows, 3))}
    metrics = dtr.train_step(meshlib.shard_global_batch(dp_mesh, batch))

    # 2) diffusion training step
    gtr = GeneratorTrainer(ConditionalUnet1D(down_dims=(16, 32)),
                           total_steps=10, device=dev, mesh=dp_mesh)
    gmetrics = gtr.train_step(meshlib.shard_global_batch(
        dp_mesh, np.zeros((rows, 14, 1), np.float32)))

    # 3) guided denoise step, the pose grid sharded over sp
    grid_size = 4 * mesh.size("sp") * 2
    sampler = _flagship_pieces(grid_size=grid_size, num_pos=1, width=32,
                               pose_chunks=1, unet_dims=(16, 32),
                               device=dev, mesh=mesh)
    fn = guided_denoise_step(sampler, "shift_up")
    out = fn(torch.zeros((2 * mesh.size("dp"), 14, 1), device=dev),
             torch.zeros((200,), device=dev))

    # 4) datagen pairs split over every rank (the rollout kernel on the
    # card, its plain version on the CPU)
    ang = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    contour = np.stack([0.035 * np.cos(ang), 0.035 * np.sin(ang)], -1)
    scenes = datagen.stack_scenes([
        engine2d.make_scene(*sample_gripper_2d(i), contour)
        for i in range(n)])
    res = datagen.profile_pairs_2d(
        scenes, engine2d.pose_grid(grid_size=4, num_pos=1), device=dev)
    return {"mesh": dict(mesh.shape),
            "dynamics_loss": float(metrics["loss"]),
            "diffusion_loss": float(gmetrics["loss"]),
            "guided_shape": tuple(out.shape),
            "guided_finite": bool(torch.isfinite(out).all()),
            "dth_shape": tuple(res["delta_theta"].shape)}


def dryrun_multichip(n_devices: int, device="cuda", timeout=600.0) -> dict:
    """Run the four dry-run steps on ``n_devices`` ranks; prints the JAX
    package's summary line and returns rank 0's numbers."""
    from dgdm_tpu_torch.parallel import launch

    backend = "gloo"
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip on cuda: no CUDA device")
        if torch.cuda.device_count() >= n_devices:
            backend = "nccl"
    outs = launch.run(n_devices, "dgdm_tpu_torch.graft_entry:_dryrun_rank",
                      {"device": device}, backend=backend, timeout=timeout)
    o = outs[0]
    for r, other in enumerate(outs[1:], 1):
        if other != o:
            raise RuntimeError(f"rank {r} disagrees with rank 0: {other} "
                               f"vs {o}")
    if not o["guided_finite"]:
        raise RuntimeError("dryrun_multichip: non-finite guided step")
    print(f"dryrun_multichip OK on {n_devices} devices "
          f"(mesh dp={o['mesh']['dp']} sp={o['mesh']['sp']}): "
          f"dynamics loss={o['dynamics_loss']:.4f}, "
          f"diffusion loss={o['diffusion_loss']:.4f}, "
          f"guided step out shape={o['guided_shape']}, "
          f"datagen dth shape={o['dth_shape']}", flush=True)
    return o


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    n = a.n or (torch.cuda.device_count() if a.device == "cuda" else 2)
    dryrun_multichip(n, a.device)
