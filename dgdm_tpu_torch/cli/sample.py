"""Guided-sampling CLI — port of ``dgdm_tpu/cli/sample.py`` (counterpart
of the reference ``generator/guided_sample_2d.sh`` / ``guided_sample_3d.sh``).

Loads the diffusion UNet (EMA weights) and the dynamics classifier, runs
unguided + guided DDIM for the chosen objectives over the test objects,
verifies every sample with re-grasp rollouts on the device (2D: 8,000 steps
through ``sim/rollout2d.py``; ``--fingers_3d``: 32,000 steps through
``sim/rollout3d.py``), and writes per-objective best-gripper tables to
``guided_report.json``.

Checkpoints are the directories that the training CLIs write
(``ckpt/best``, ``ckpt/last``, ...; ``train/checkpoints.py``) or the
``.npz`` files of ``models/convert.py`` (a flax tree carried across, or a
state_dict saved by the port).

``--render_video`` adds the JAX package's imagery: the denoise trajectory
(``denoise_steps.npy`` / ``.png``) and, for the best-success gripper of each
(objective, object) pair, its portrait, profile and final-orientation
plots, object silhouettes and a squeeze video (2D), or a scene render, a
profile plot and a squeeze video (3D; the final frame as a still without an
mp4 backend). The pairs' squeezes run as ONE batched trace of the pure
engine on the CLI's device after the objective loop (``render_inputs``),
where the JAX package traces pair by pair. The writers need matplotlib and
imageio: without them the flag fails before any sampling.

Over N GPUs, start N processes with the environment contract of
``parallel/distributed.py`` (one process a GPU): with more than one rank
and ``--grid_size`` divisible by the mesh's sp size, the design loop runs
on a (dp, sp) mesh (``parallel/mesh.make_mesh``), its pose grid split over
sp; verification splits the grippers over all ranks
(``eval/simeval.py``); rank 0 writes the report and the ``.npy`` files.

Examples:
    python -m dgdm_tpu_torch.cli.sample --diffusion_checkpoint_path unet.npz \\
        --checkpoint_path dyn2d.npz --save_dir runs/guided2d \\
        --batch_size 16 --device cuda
    python -m dgdm_tpu_torch.cli.sample --fingers_3d --ctrlpts_dim 42 \\
        --grid_size 45 --num_pos 5 --sub_bs 512 \\
        --object_dir tests/fixtures/scanned_objects \\
        --object_max_num_vertices 512 --diffusion_checkpoint_path unet3d.npz \\
        --checkpoint_path dyn3d.npz --save_dir runs/guided3d --device cuda
"""

from __future__ import annotations

import importlib
import json
import math
import os
import time

import numpy as np
import torch

from dgdm_tpu_torch.core.config import (
    GUIDANCE,
    GUIDED_OBJECTIVES,
    ICON_TEST_OBJECT_IDS,
    NORM,
    SIM,
)
from dgdm_tpu_torch.core.flags import build_parser
from dgdm_tpu_torch.design.guidance import GuidedSampler
from dgdm_tpu_torch.eval.metrics import average_objectives, best_ids_all_metrics
from dgdm_tpu_torch.eval.simeval import objectives_table, sim_eval_batch_2d
from dgdm_tpu_torch.eval.simeval3d import sim_eval_batch_3d
from dgdm_tpu_torch.geom.contour import extract_contours, load_icon, synthetic_icon
from dgdm_tpu_torch.geom.fingers import denormalize_y
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    rank,
    world_size,
)
from dgdm_tpu_torch.parallel.mesh import make_mesh
from dgdm_tpu_torch.sim import datagen, engine2d, engine3d
from dgdm_tpu_torch.sim.types import to_device
from dgdm_tpu_torch.train import generator


def load_test_objects(args):
    ids = list(ICON_TEST_OBJECT_IDS)
    if args.num_test_objects:
        ids = ids[: args.num_test_objects]
    contours = []
    for oid in ids:
        img = (load_icon(args.object_dir, oid) if args.object_dir
               else synthetic_icon(oid))
        contours.append(extract_contours(img))
    return ids, contours


def load_test_objects_3d(args):
    """Test-split scanned objects (reference: object_names_test.txt names
    under object_dir, generator/train.py:100-109): names, (verts, faces)
    meshes and normalized surface clouds of object_max_num_vertices points."""
    from dgdm_tpu_torch.geom import mesh3d

    names_file = os.path.join(args.object_dir, "object_names_test.txt")
    with open(names_file) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    if args.num_test_objects:
        names = names[: args.num_test_objects]
    meshes, clouds = [], []
    for name in names:
        verts, faces = mesh3d.load_obj(
            os.path.join(args.object_dir, name, "model.obj"))
        meshes.append((verts, faces))
        pts = np.array(mesh3d.sample_surface(verts, faces,
                                             args.object_max_num_vertices))
        e = NORM.object_extent_3d_xy
        pts[:, 0] = (pts[:, 0] + e) / (2 * e) * 2 - 1
        pts[:, 1] = (pts[:, 1] + e) / (2 * e) * 2 - 1
        pts[:, 2] = (
            (pts[:, 2] - NORM.object_z_min_3d)
            / (NORM.object_z_max_3d - NORM.object_z_min_3d) * 2 - 1
        )
        clouds.append(pts.astype(np.float32))
    return names, meshes, clouds


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def require_writers() -> None:
    """Raise ImportError naming the first writer package that
    ``--render_video`` needs and this host lacks."""
    for pkg in ("matplotlib", "imageio"):
        try:
            importlib.import_module(pkg)
        except ImportError as e:
            raise ImportError(
                f"--render_video writes its images and videos with {pkg}, "
                f"which is not installed") from e


def render_schedule(fingers_3d: bool, eval_steps: int = 0):
    """(steps, every, regrasp_every) of the render traces: the JAX CLI's
    2D trace (8,000 steps, 100 rows, the verification's regrasp) and 3D
    trace (800 steps, 40 rows, no regrasp), ``eval_steps`` overriding the
    depth as it does for verification."""
    if fingers_3d:
        steps = eval_steps or SIM.steps_3d
        return steps, max(1, steps // 40), 0
    steps = eval_steps or SIM.eval_steps_2d
    regrasp = max(1, eval_steps // 2) if eval_steps else SIM.eval_regrasp_2d
    return steps, max(1, steps // 100), regrasp


def render_pair(objective: str, oid, samples: np.ndarray, entry: dict, obj,
                fingers_3d: bool, metrics=None) -> dict:
    """What ``--render_video`` draws for one (objective, object) pair: the
    best-success sample of ``samples`` (B, L, 1) by the pair's table entry
    (``entry["best_ids"]``), denormalized, beside the object (2D: contour;
    3D: (verts, faces)) and that sample's metrics row."""
    bi = int(entry["best_ids"].get("success_rate", 0))
    return {"objective": objective, "oid": oid,
            "y": np.asarray(denormalize_y(samples[bi, :, 0],
                                          fingers_3d=fingers_3d)),
            "object": obj,
            "metrics": None if metrics is None else metrics[bi]}


def render_inputs(pairs, fingers_3d: bool, device, steps: int, every: int,
                  regrasp_every: int = 0, grid_size: int = SIM.grid_size):
    """The device part of ``--render_video`` and what the writers consume.

    ``pairs``: dicts with ``y`` (the gripper's denormalized control values,
    left then right finger) and ``object`` (2D: the (N, 2) contour; 3D: the
    (verts, faces) mesh). Every pair's squeeze runs as one batched trace of
    the pure engine on ``device``, scenes stacked as ``sim/datagen.py``
    stacks them (``expand_scene`` / ``expand_scene3`` against one shared
    pose, the 3D height grids baked per pair before stacking), rows of steps
    0, every, 2 * every, ... as ``rollout_trace`` records them: 2D from pose
    (0, 0, pi), 3D from (0, 0, 0.7). On the host, per pair: 2D the video's
    frames (``viz.rollout_frames_2d``, one a row) and the object's
    silhouettes at every ``grid_size // 10``-th orientation of the
    verification grid; 3D the scene's points and COM.

    Returns (per-pair dicts with ``trace`` (T, 5 or 9) and the items above,
    {"trace_s": seconds of the batched trace, synchronized, "host_s": host
    seconds of the rest})."""
    from dgdm_tpu_torch.eval import viz

    device = torch.device(device)
    n = len(pairs[0]["y"]) // 2
    t0 = time.perf_counter()
    if fingers_3d:
        scenes = [engine3d.with_hgrid(engine3d.make_scene(
            p["y"][:n], p["y"][n:], *p["object"])) for p in pairs]
        stacked = engine3d.expand_scene3(
            to_device(datagen.stack_scenes(scenes), device), 1)
        pose = torch.tensor([[0.0, 0.0, 0.7]], dtype=torch.float32,
                            device=device)
        trace_fn = engine3d.rollout_trace3d
    else:
        scenes = [engine2d.make_scene(p["y"][:n], p["y"][n:], p["object"])
                  for p in pairs]
        stacked = engine2d.expand_scene(
            to_device(datagen.stack_scenes(scenes), device), 1)
        pose = torch.tensor([[0.0, 0.0, math.pi]], dtype=torch.float32,
                            device=device)
        trace_fn = engine2d.rollout_trace
    bake_s = time.perf_counter() - t0
    _sync(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        traces = trace_fn(stacked, pose, steps=steps, every=every,
                          regrasp_every=regrasp_every)[:, 0]
    _sync(device)
    trace_s = time.perf_counter() - t0
    traces = traces.cpu().numpy()
    t0 = time.perf_counter()
    out = []
    for p, scene, tr in zip(pairs, scenes, traces):
        item = {"trace": tr}
        if fingers_3d:
            item["points"] = scene.points.numpy()
            item["com"] = scene.com.numpy()
        else:
            item["frames"] = viz.rollout_frames_2d(
                p["object"], p["y"][:n], p["y"][n:], tr, stride=1)
            sil_th = np.linspace(-1.0, 1.0, grid_size) * np.pi + np.pi
            item["silhouettes"] = np.stack([
                viz.render_object_silhouette(p["object"], float(th))
                for th in sil_th[:: max(1, grid_size // 10)]])
        out.append(item)
    host_s = bake_s + time.perf_counter() - t0
    return out, {"trace_s": trace_s, "host_s": host_s}


def write_renders(save_dir: str, pairs, items, fingers_3d: bool) -> None:
    """Per pair, the JAX CLI's files under ``{objective}_{oid}``: 2D
    ``_gripper.png``, ``_profile.png``, ``_final.png``,
    ``_silhouettes.npy`` and ``_rollout.mp4`` (``.gif`` without an mp4
    backend); 3D ``_scene.png``, ``_profile.png`` and ``_rollout.mp4`` (or
    ``_rollout_final.png``)."""
    from dgdm_tpu_torch.eval import viz

    for p, item in zip(pairs, items):
        stem = os.path.join(save_dir, f"{p['objective']}_{p['oid']}")
        y, m = p["y"], p["metrics"]
        n = len(y) // 2
        viz.visualize_profile(m["profile"] - 1, stem + "_profile.png")
        if fingers_3d:
            viz.render_scene_3d(item["points"], item["com"], y[:n], y[n:],
                                item["trace"][0], stem + "_scene.png")
            viz.rollout_video_3d(item["points"], item["com"], y[:n], y[n:],
                                 item["trace"], stem + "_rollout.mp4")
        else:
            viz.render_gripper_2d(y[:n], y[n:], stem + "_gripper.png")
            viz.visualize_finals(m["final_theta"], stem + "_final.png")
            np.save(stem + "_silhouettes.npy", item["silhouettes"])
            viz.write_video(item["frames"], stem + "_rollout.mp4")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.render_video:
        require_writers()
    maybe_initialize_distributed()
    writer = rank() == 0
    f3d = args.fingers_3d
    device = torch.device(args.device)
    # design and verification run in float32 (no TF32 products)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.save_dir, exist_ok=True)

    unet = convert.load_model(args.diffusion_checkpoint_path, "unet",
                              input_dim=1).to(device)
    if f3d:
        classifier = convert.load_model(
            args.checkpoint_path, "profile3d",
            params_ch=args.ctrlpts_dim).to(device)
        ids, meshes, clouds = load_test_objects_3d(args)
        obj_flats = np.stack(clouds)
    else:
        classifier = convert.load_model(
            args.checkpoint_path, "profile2d", params_ch=args.ctrlpts_dim,
            object_ch=2 * args.object_max_num_vertices).to(device)
        ids, contours = load_test_objects(args)
        obj_flats = np.stack([c.reshape(-1) / NORM.object_extent_2d
                              for c in contours])
    obj_flats = torch.as_tensor(obj_flats, dtype=torch.float32, device=device)
    b = args.batch_size

    # --sub_bs = rows per pose-grid chunk (the reference's sub-batching)
    n_poses = args.grid_size * args.num_pos**2
    pose_chunks = max(1, -(-n_poses // max(args.sub_bs, 1)))
    # multi-GPU: the pose grid splits over the mesh's sp axis when it
    # divides evenly, else every rank sweeps all of it
    mesh = None
    if world_size() > 1:
        cand = make_mesh(axes=("dp", "sp"))
        if args.grid_size % cand.size("sp") == 0:
            mesh = cand
        if writer:
            print(f"design loop mesh: {cand.shape}"
                  f"{'' if mesh else ' (grid does not split; unsharded)'}",
                  flush=True)
    sampler = GuidedSampler(
        unet, classifier, grid_size=args.grid_size, num_pos=args.num_pos,
        num_train_timesteps=args.num_train_timesteps,
        num_inference_steps=args.num_inference_steps,
        pose_chunks=pose_chunks, device=device, mesh=mesh,
    )

    # --eval_steps > 0 overrides the reference rollout length (8k 2D / 32k
    # 3D)
    eval_kw = {}
    if args.eval_steps:
        eval_kw["total_steps"] = args.eval_steps
        eval_kw["regrasp_every"] = max(1, args.eval_steps // 2)

    verify_seconds = [0.0]

    def sim_eval(samples, oi):
        t0 = time.perf_counter()
        pts_y = samples.detach().cpu().numpy()[..., 0]
        if f3d:
            out = sim_eval_batch_3d(pts_y, [meshes[oi]],
                                    num_rot=args.grid_size, device=device,
                                    **eval_kw)
        else:
            out = sim_eval_batch_2d(pts_y, [contours[oi]],
                                    num_rot=args.grid_size, device=device,
                                    **eval_kw)
        verify_seconds[0] += time.perf_counter() - t0
        return out

    def objs_entry(objs, objective):
        best = best_ids_all_metrics(objs, objective)
        succ = [o.get("success_rate", 0.0) for o in objs]
        return {
            "best_ids": best,
            "best_objectives": {k: objs[v] for k, v in best.items()},
            "mean_success": float(np.mean(succ)) if succ else 0.0,
        }

    def table_entry(metrics, objective):
        return objs_entry(objectives_table(metrics, objective), objective)

    # fixed-seed noise like the reference validation (diffusion.py:182-183)
    rs = np.random.RandomState(args.seed)
    noise = torch.as_tensor(rs.randn(b, args.ctrlpts_dim, 1).astype(np.float32),
                            device=device)
    if args.render_video:
        # per-step denoising snapshots (the reference dumps the sample
        # scatter at every DDIM step, diffusion.py:258-292); the last row
        # is generator.sample's result
        unguided, traj = generator.sample_trajectory(
            unet, noise, args.num_train_timesteps, args.num_inference_steps)
        if writer:
            from dgdm_tpu_torch.eval import viz

            traj = traj.cpu().numpy()
            np.save(os.path.join(args.save_dir, "denoise_steps.npy"), traj)
            viz.visualize_denoise_steps(
                traj, os.path.join(args.save_dir, "denoise_steps.png"))
    else:
        unguided = generator.sample(unet, noise, args.num_train_timesteps,
                                    args.num_inference_steps)

    # unguided baseline: sim-evaluate once per test object, reused by the
    # guided-vs-unguided table of every objective
    unguided_metrics = [sim_eval(unguided, oi) for oi in range(len(ids))]

    report = {}
    thr0 = NORM.threshold_std(f3d)[0]
    objectives = ([o for o in args.objectives.split(",") if o]
                  if args.objectives else list(GUIDED_OBJECTIVES))
    # --render_video: the best-success gripper of every (objective, object)
    # pair, rendered after the loop
    render_pairs = []
    # fused design sweep: every (objective, object) pair except convergence
    sweep_samples = {}
    sweep_names = [o for o in objectives if o != "convergence"]
    if sweep_names:
        obj_feats, s_weights, s_rsq, s_scales, s_labels = sampler.sweep_inputs(
            sweep_names, obj_flats, f3d)
        _sync(device)
        t0 = time.perf_counter()
        sweep_out = sampler.sample_sweep(noise, obj_feats, s_weights, s_rsq,
                                         s_scales)
        _sync(device)
        sweep_seconds = time.perf_counter() - t0
        if writer:
            print(f"design sweep: {len(s_labels)} (objective x object) "
                  f"pairs sampled in {sweep_seconds:.2f}s", flush=True)
        sweep_samples = {lab: sweep_out[i] for i, lab in enumerate(s_labels)}
    for objective in objectives:
        per_object = {}
        for oi, oid in enumerate(ids):
            if (objective, oi) in sweep_samples:
                samples = sweep_samples[(objective, oi)]
            else:  # convergence: per-sample pose re-centering, serial path
                centers = sampler.find_convergence_centers(
                    unguided, obj_flats[oi], thr0)
                samples = sampler.sample(
                    noise, obj_flats[oi], objective,
                    GUIDANCE.scale(f3d, objective), centers=centers)
            metrics = sim_eval(samples, oi)
            te = table_entry(metrics, objective)
            per_object[str(oid)] = {
                **te,
                "unguided": table_entry(unguided_metrics[oi], objective),
            }
            if args.render_video and writer:
                render_pairs.append(render_pair(
                    objective, oid, samples.detach().cpu().numpy(), te,
                    meshes[oi] if f3d else contours[oi], f3d, metrics))
            if writer:
                np.save(os.path.join(args.save_dir,
                                     f"samples_{objective}_{oid}.npy"),
                        samples.detach().cpu().numpy())
        entry = {"objects": per_object}
        # multi-object guided sampling: gradient averaged over all test
        # objects (convergence is per-object-centered, excluded there too)
        if objective != "convergence":
            msamples = sampler.sample_multi_object(
                noise, obj_flats, objective, GUIDANCE.scale(f3d, objective))
            mo_objs = [objectives_table(sim_eval(msamples, oi), objective)
                       for oi in range(len(ids))]
            entry["multi_object"] = {
                str(oid): objs_entry(mo_objs[oi], objective)
                for oi, oid in enumerate(ids)
            }
            entry["multi_object_average"] = objs_entry(
                average_objectives(mo_objs), objective)
            if writer:
                np.save(os.path.join(args.save_dir,
                                     f"samples_{objective}_multi.npy"),
                        msamples.detach().cpu().numpy())
        report[objective] = entry
        if writer:
            print(f"objective {objective} done", flush=True)
    if render_pairs:
        steps, every, regrasp = render_schedule(f3d, args.eval_steps)
        items, timing = render_inputs(render_pairs, f3d, device, steps, every,
                                      regrasp, grid_size=args.grid_size)
        write_renders(args.save_dir, render_pairs, items, f3d)
        print(f"render: {len(render_pairs)} pairs traced together over "
              f"{steps} steps in {timing['trace_s']:.2f}s on {device}",
              flush=True)
    if sweep_names:
        report["design_sweep"] = {"pairs": len(s_labels),
                                  "seconds": sweep_seconds}
    report["verification"] = {"seconds": verify_seconds[0],
                              "device": str(device)}
    if writer:
        with open(os.path.join(args.save_dir, "guided_report.json"),
                  "w") as f:
            json.dump(report, f, indent=1, default=str)
    return report


if __name__ == "__main__":
    main()
