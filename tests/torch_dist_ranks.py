"""Rank bodies of the port's multi-process tests
(tests/test_torch_parallel*.py). ``dgdm_tpu_torch.parallel.launch`` runs
each in N gloo processes on the CPU; the module imports no JAX, so that the
children start fast. Inputs come as an npz written by the test, results go
back as what the function returns (numpy arrays and floats)."""

import os

import numpy as np
import torch

from dgdm_tpu_torch.parallel import mesh as meshlib
from dgdm_tpu_torch.parallel.distributed import rank, world_size


def _load(path):
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def _state(module):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


# ---- mesh --------------------------------------------------------------------


def mesh_layout():
    """This rank's (dp, sp) mesh, the ranks of its groups (an all-gather
    over each) and a module initialised from this rank's seed after
    ``replicate``."""
    m = meshlib.make_mesh()
    probe = {}
    for axis in ("dp", "sp"):
        t = torch.tensor([float(rank())])
        buf = [torch.zeros(1) for _ in range(m.size(axis))]
        torch.distributed.all_gather(buf, t, group=m.groups[axis])
        probe[axis] = [int(b.item()) for b in buf]
    torch.manual_seed(rank())
    module = torch.nn.Sequential(torch.nn.Linear(3, 3),
                                 torch.nn.BatchNorm1d(3))
    module(torch.randn(4, 3))     # running statistics of this rank's own
    replicated = _state(meshlib.replicate(m, module))
    return {"shape": m.shape, "coords": m.coords, "members": probe,
            "world": world_size(), "replicated": replicated}


# ---- training ---------------------------------------------------------------


def dynamics_dp(spec):
    """DynamicsTrainer steps on this rank's block of each global batch, with
    the given global draws; the null biases set from the spec before each
    step (tests/test_torch_training.null_biases). Returns the losses, the
    accuracies, the final state and the elementwise min |gradient|."""
    from dgdm_tpu_torch.models.profile2d import ProfileForward2D
    from dgdm_tpu_torch.train.dynamics import DynamicsTrainer

    z = _load(spec)
    model = ProfileForward2D(width=32, num_trunk=2, object_ch=200)
    model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in z.items()
                           if k.startswith("sd/")})
    mesh = meshlib.data_parallel_mesh()
    tr = DynamicsTrainer(model, learning_rate=float(z["lr"]),
                         total_steps=int(z["total"]), device="cpu",
                         mesh=mesh)
    batch = {k[6:]: v for k, v in z.items() if k.startswith("batch/")}
    local = meshlib.shard_global_batch(mesh, batch)
    params = dict(tr.model.named_parameters())
    out = {"metrics": [], "min_grads": {}}
    for i in range(int(z["steps"])):
        with torch.no_grad():
            for k, v in z.items():
                if k.startswith(f"null{i}/"):
                    params[k.split("/", 1)[1]].copy_(torch.from_numpy(v))
        sl = meshlib.block(mesh, z[f"t{i}"].shape[0])
        m = tr.step(local, torch.from_numpy(z[f"t{i}"][sl]),
                    torch.from_numpy(z[f"noise{i}"][sl]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        for n, p in tr.model.named_parameters():
            g = p.grad.abs().numpy()
            seen = out["min_grads"].get(n)
            out["min_grads"][n] = g if seen is None else np.minimum(seen, g)
    out["state"] = _state(tr.model)
    return out


def generator_dp(spec):
    """GeneratorTrainer steps on this rank's block of the global batch with
    the given global draws -> losses, EMA decays, final params and EMA,
    elementwise min |gradient|."""
    from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
    from dgdm_tpu_torch.train.generator import GeneratorTrainer

    z = _load(spec)
    model = ConditionalUnet1D(down_dims=(16, 32))
    model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in z.items()
                           if k.startswith("sd/")})
    mesh = meshlib.data_parallel_mesh()
    tr = GeneratorTrainer(model, learning_rate=float(z["lr"]),
                          total_steps=int(z["total"]), device="cpu",
                          mesh=mesh)
    local = meshlib.shard_global_batch(mesh, torch.from_numpy(z["batch"]))
    out = {"metrics": [], "min_grads": {}}
    for i in range(int(z["steps"])):
        sl = meshlib.block(mesh, z[f"t{i}"].shape[0])
        m = tr.step(local, torch.from_numpy(z[f"t{i}"][sl]),
                    torch.from_numpy(z[f"noise{i}"][sl]))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        for n, p in tr.model.named_parameters():
            g = p.grad.abs().numpy()
            seen = out["min_grads"].get(n)
            out["min_grads"][n] = g if seen is None else np.minimum(seen, g)
    out["state"] = _state(tr.model)
    out["ema"] = _state(tr.ema)
    return out


def two_process_training(outdir):
    """Port of tests/distributed_harness.py: a GeneratorTrainer on the dp
    mesh over every rank, 3 steps on seed-identical global batches split by
    ``shard_global_batch``, a parameter checksum, a rank-gated metric sink
    in a directory of each rank's own, a checkpoint save that every rank
    calls with one path; then the training CLI over the same ranks."""
    from dgdm_tpu_torch.cli import train_diffusion
    from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
    from dgdm_tpu_torch.train import checkpoints
    from dgdm_tpu_torch.train.data import procedural_grippers
    from dgdm_tpu_torch.train.generator import GeneratorTrainer
    from dgdm_tpu_torch.train.logging import MetricSink

    train, _ = procedural_grippers(64, fingers_3d=False)
    mesh = meshlib.data_parallel_mesh()
    torch.manual_seed(0)
    tr = GeneratorTrainer(ConditionalUnet1D(input_dim=1), learning_rate=1e-3,
                          total_steps=3, num_train_timesteps=15,
                          device="cpu", mesh=mesh)
    for step in range(3):
        batch = meshlib.shard_global_batch(
            mesh, torch.from_numpy(train[step * 16:(step + 1) * 16]))
        tr.train_step(batch)
    checksum = float(sum(p.detach().abs().sum(dtype=torch.float64)
                         for p in tr.model.parameters()))
    sink = MetricSink(os.path.join(outdir, f"rank{rank()}"), use_wandb=False)
    sink.log({"smoke": 1.0}, 0)
    sink.close()
    checkpoints.save(os.path.join(outdir, "ckpt", "smoke"), tr)
    cli = train_diffusion.main([
        "--num_fingers", "64", "--batch_size", "16", "--num_epochs", "1",
        "--save_dir", os.path.join(outdir, "cli"), "--device", "cpu"])
    return {"checksum": checksum, "world": world_size(),
            "cli_losses": (cli["first_loss"], cli["last_loss"]),
            "cli_steps": cli["steps"]}


# ---- simulation -------------------------------------------------------------


def _scenes_2d(n):
    from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
    from dgdm_tpu_torch.geom.fingers import sample_gripper_2d
    from dgdm_tpu_torch.sim import datagen, engine2d

    contour = extract_contours(synthetic_icon(0))
    return contour, datagen.stack_scenes([
        engine2d.make_scene(*sample_gripper_2d(i), contour)
        for i in range(n)])


def sims_2d(pairs=4, grid=8, eval_steps=400):
    """profile_pairs_2d on both routes (the kernel's route through
    ``block=False`` and its fetch) and sim_eval_batch_2d; the pairs split
    over the dp ranks when they divide the world."""
    from dgdm_tpu_torch.eval.simeval import sim_eval_batch_2d
    from dgdm_tpu_torch.sim import datagen, engine2d

    contour, scenes = _scenes_2d(pairs)
    poses = engine2d.pose_grid(grid_size=grid, num_pos=1)
    pending = datagen.profile_pairs_2d(scenes, poses, block=False,
                                       device="cpu")
    kernel = datagen.fetch_pairs_2d(pending)
    engine = datagen.profile_pairs_2d(scenes, poses, use_pallas=False,
                                      device="cpu")
    pts = np.random.RandomState(0).uniform(-0.5, 0.5, (pairs, 14)) \
        .astype(np.float32)
    metrics = sim_eval_batch_2d(pts, [contour], num_rot=grid,
                                total_steps=eval_steps,
                                regrasp_every=eval_steps // 2, device="cpu")
    return {"kernel": kernel, "engine": engine, "eval": metrics}


MUG = os.path.join(os.path.dirname(__file__), "fixtures", "scanned_objects",
                   "mug_small", "model.obj")


def sims_3d(pairs=4, grid=8, steps=800):
    """profile_pairs_3d on both routes and sim_eval_batch_3d (one squeeze
    of ``steps``), the pairs split over the dp ranks."""
    from dgdm_tpu_torch.eval.simeval3d import sim_eval_batch_3d
    from dgdm_tpu_torch.geom import mesh3d
    from dgdm_tpu_torch.geom.fingers import sample_gripper_3d
    from dgdm_tpu_torch.sim import datagen3d, engine2d

    verts, faces = mesh3d.load_obj(MUG)
    stacked = datagen3d.bake_3d([sample_gripper_3d(i) for i in range(pairs)],
                                verts, faces)
    poses = engine2d.pose_grid(grid_size=grid, num_pos=1)
    kernel = datagen3d.profile_pairs_3d(stacked, poses, steps=steps,
                                        device="cpu")
    engine = datagen3d.profile_pairs_3d(stacked, poses, steps=steps,
                                        use_pallas=False, device="cpu")
    pts = np.random.RandomState(1).uniform(-0.5, 0.5, (pairs, 42)) \
        .astype(np.float32)
    metrics = sim_eval_batch_3d(pts, [(verts, faces)], num_rot=grid,
                                total_steps=steps, regrasp_every=steps,
                                device="cpu")
    return {"kernel": kernel, "engine": engine, "eval": metrics}


# ---- guidance ---------------------------------------------------------------


def guided_sampler(spec):
    """GuidedSampler2D on the (dp, sp) mesh over every rank, from the
    spec's weights: ``sample`` (shift_up and convergence with the given
    centers), ``sample_sweep`` and ``sample_multi_object``; and the mesh's
    layout (``mesh_layout``)."""
    from dgdm_tpu_torch.design.guidance import GuidedSampler2D
    from dgdm_tpu_torch.models.profile2d import ProfileForward2D
    from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D

    z = _load(spec)
    layout = mesh_layout()
    sampler = sampler_from(z, meshlib.make_mesh(), ConditionalUnet1D,
                           ProfileForward2D, GuidedSampler2D)
    return {"layout": layout, **run_sampler(sampler, z)}


def sampler_from(z, mesh, unet_cls, cls_cls, sampler_cls):
    unet = unet_cls(down_dims=(16, 32))
    unet.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in z.items()
                          if k.startswith("u/")})
    cls = cls_cls(width=32, num_trunk=2, object_ch=20)
    cls.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in z.items()
                         if k.startswith("c/")})
    return sampler_cls(unet, cls, grid_size=int(z["grid"]),
                       num_pos=int(z["num_pos"]), pose_chunks=4,
                       device="cpu", mesh=mesh)


def run_sampler(sampler, z):
    """The sampler's three guided entry points on the spec's inputs."""
    noise, objs = z["noise"], z["objs"]
    out = {
        "shift_up": sampler.sample(noise, objs[0], "shift_up", 5.0).numpy(),
        "convergence": sampler.sample(
            noise, objs[0], "convergence", 1.0,
            centers=torch.from_numpy(z["centers"])).numpy(),
        "multi": sampler.sample_multi_object(
            noise, objs, "rotate_clockwise", 5.0).numpy(),
    }
    feats, w, rsq, scales, _ = sampler.sweep_inputs(
        ["rotate", "shift_left"], objs, False)
    out["sweep"] = sampler.sample_sweep(noise, feats, w, rsq,
                                        scales).numpy()
    return out

