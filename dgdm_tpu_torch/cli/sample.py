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
state_dict saved by the port). ``--render_video`` waits for a later slice of
the port.

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

import json
import os
import time

import numpy as np
import torch

from dgdm_tpu_torch.core.config import (
    GUIDANCE,
    GUIDED_OBJECTIVES,
    ICON_TEST_OBJECT_IDS,
    NORM,
)
from dgdm_tpu_torch.core.flags import build_parser
from dgdm_tpu_torch.design.guidance import GuidedSampler
from dgdm_tpu_torch.eval.metrics import average_objectives, best_ids_all_metrics
from dgdm_tpu_torch.eval.simeval import objectives_table, sim_eval_batch_2d
from dgdm_tpu_torch.eval.simeval3d import sim_eval_batch_3d
from dgdm_tpu_torch.geom.contour import extract_contours, load_icon, synthetic_icon
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    rank,
    world_size,
)
from dgdm_tpu_torch.parallel.mesh import make_mesh
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


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.render_video:
        raise NotImplementedError("--render_video is not ported yet")
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
    unguided = generator.sample(unet, noise, args.num_train_timesteps,
                                args.num_inference_steps)

    # unguided baseline: sim-evaluate once per test object, reused by the
    # guided-vs-unguided table of every objective
    unguided_metrics = [sim_eval(unguided, oi) for oi in range(len(ids))]

    report = {}
    thr0 = NORM.threshold_std(f3d)[0]
    objectives = ([o for o in args.objectives.split(",") if o]
                  if args.objectives else list(GUIDED_OBJECTIVES))
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
            per_object[str(oid)] = {
                **table_entry(metrics, objective),
                "unguided": table_entry(unguided_metrics[oi], objective),
            }
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
