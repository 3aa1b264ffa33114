"""The plain reference against the program at small sizes on the CPU:
scenes and kernel inputs, the plain rollouts (bit for bit), the models
with one seeded weight table, guided sampling, the metrics and tables.
The CUDA-graph replay of the reference's 2D rollout against its own eager
steps runs on the card only."""

import os

import numpy as np
import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import contour as rcontour
from perfbench.reference import guided, k1, k2, metrics, scene2d, scene3d
from perfbench.reference.fingers import sample_gripper_2d, sample_gripper_3d


def _poses2d(n_rot, device="cpu"):
    th = (np.linspace(-1, 1, n_rot) * np.pi + np.pi).astype(np.float32)
    thp = scene2d.pad_poses(th[:, None])[:, 0]
    return torch.as_tensor(np.stack(
        [np.zeros_like(thp), np.zeros_like(thp), thp], -1)).to(device)


def _arrays2d(device="cpu"):
    c = rcontour.extract_contours(rcontour.synthetic_icon(2009))
    grips = [sample_gripper_2d(i) for i in (3, 11)]
    st = scene2d.stack_scenes([scene2d.make_scene(yl, yr, c)
                               for yl, yr in grips])
    return c, grips, scene2d.scene_arrays(st, device=device)


def test_scenes_and_kernel_inputs_2d_match_the_program():
    from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
    from dgdm_tpu_torch.sim import datagen, engine2d, rollout2d

    c, grips, ours = _arrays2d()
    assert np.array_equal(c, extract_contours(synthetic_icon(2009)))
    theirs = rollout2d.scene_arrays(datagen.stack_scenes(
        [engine2d.make_scene(yl, yr, c) for yl, yr in grips]), device="cpu")
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


def test_k1_matches_the_programs_plain_rollout():
    from dgdm_tpu_torch.sim.rollout2d_ref import profile_batch_ref

    _, _, arrs = _arrays2d()
    poses = _poses2d(100)
    kw = dict(steps=300, regrasp_every=150, snapshot_step=150)
    theirs = profile_batch_ref(*arrs, poses, solver="newton", **kw)
    ours = k1.rollout(*arrs, poses, **kw)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    assert float(ours[6].max()) > 0      # full solves: the jaws touched


def test_k2_and_3d_scenes_match_the_program():
    from dgdm_tpu_torch.geom import mesh3d
    from dgdm_tpu_torch.sim import datagen, engine3d, rollout3d
    from dgdm_tpu_torch.sim.rollout3d_ref import profile_batch_ref

    verts, faces = mesh3d.load_obj(os.path.join(
        harness.HERE, "objects", "mug_small.obj"))
    grips = [sample_gripper_3d(i) for i in (5, 9)]
    props = scene3d.object_properties_3d(verts, faces)
    ours_sc = scene2d.stack_scenes([scene3d.make_scene(
        yl, yr, verts, faces, obj_props=props) for yl, yr in grips])
    pprops = engine3d.object_properties_3d(verts, faces)
    theirs_sc = datagen.stack_scenes([engine3d.make_scene(
        yl, yr, verts, faces, obj_props=pprops) for yl, yr in grips])
    ours = scene3d.scene_arrays_3d(ours_sc, device="cpu")
    theirs = rollout3d.scene_arrays_3d(theirs_sc, device="cpu")
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    poses = torch.as_tensor(scene2d.pad_poses(scene2d.pose_grid(4, 1)))
    a = k2.profile_batch_ref(*ours, poses, steps=40)
    b = profile_batch_ref(*theirs, poses, steps=40, solver="newton")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _models():
    from dgdm_tpu_torch.models.profile2d import ProfileForward2D as P
    from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D as U
    from perfbench.reference.profile2d import ProfileForward2D as RP
    from perfbench.reference.unet1d import ConditionalUnet1D as RU

    ucfg = dict(input_dim=1, down_dims=[16, 32], diffusion_step_embed_dim=32,
                kernel_size=5, n_groups=4)
    ccfg = dict(width=32, params_ch=14, object_ch=200, num_trunk=2)
    us = weights.seeded_state(RU(**ucfg), 2 ** 31 + 3, "cpu")
    cs = weights.seeded_state(RP(**ccfg), 2 ** 31 + 4, "cpu")
    return ([weights.load(m(**c), s).eval() for m, c, s in
             ((U, ucfg, us), (P, ccfg, cs))],
            [weights.load(m(**c), s).eval() for m, c, s in
             ((RU, ucfg, us), (RP, ccfg, cs))])


def test_seeded_weights_follow_the_default_law():
    from perfbench.reference.unet1d import ConditionalUnet1D

    m = ConditionalUnet1D(down_dims=[16, 32], n_groups=4)
    a = weights.seeded_state(m, 7, "cpu")
    b = weights.seeded_state(m, 7, "cpu")
    c = weights.seeded_state(m, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["final_conv.weight"], c["final_conv.weight"])
    assert torch.equal(a["final_block.norm.weight"],
                       torch.ones_like(a["final_block.norm.weight"]))
    w = a["time_in.weight"]
    assert float(w.abs().max()) <= 1 / np.sqrt(w.shape[1])


def test_models_and_guidance_match_the_program():
    from dgdm_tpu_torch.design.guidance import GuidedSampler2D
    from dgdm_tpu_torch.train import generator

    (unet, cls), (runet, rcls) = _models()
    x = torch.randn(3, 14, 1, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([12, 9, 3])
    assert torch.equal(unet(x, t), runet(x, t))
    obj = torch.randn(1, 200, generator=torch.Generator().manual_seed(2))
    assert torch.equal(cls.encode_object(obj), rcls.encode_object(obj))
    sampler = GuidedSampler2D(unet, cls, grid_size=4, num_pos=2,
                              pose_chunks=4, device="cpu")
    noise = torch.randn(2, 14, 1, generator=torch.Generator().manual_seed(3))
    for objective in ("shift_up", "rotate"):
        feats, w, rsq, sc, _ = sampler.sweep_inputs([objective], obj, False)
        got = sampler.sample_sweep(noise, feats, w, rsq, sc)[0]
        want = guided.guided(runet, rcls, noise, obj[0], objective, 0.001,
                             4, 2, 15, 5, 0.1, sub_bs=4)
        assert torch.equal(got, want), objective
    base = generator.sample(unet, noise, 15, 5)
    centers = sampler.find_convergence_centers(base, obj[0], 0.1)
    got = sampler.sample(noise, obj[0], "convergence", 10.0,
                         centers=centers)
    want = guided.guided(runet, rcls, noise, obj[0], "convergence", 10.0,
                         4, 2, 15, 5, 0.1, sub_bs=4)
    assert torch.equal(got, want)


def test_metrics_and_tables_match_the_program():
    from dgdm_tpu_torch.eval import metrics as pm

    rng = np.random.default_rng(0)
    n = 40
    th = (np.linspace(-1, 1, n) * np.pi + np.pi).astype(np.float32)
    args = (rng.normal(0, 0.3, n), rng.normal(0, 0.01, (n, 3)),
            rng.uniform(0, 2 * np.pi, n), th, rng.normal(0, 0.01, (n, 3)))
    a, b = metrics.profile_metrics_2d(*args), pm.profile_metrics_2d(*args)
    for key in b:
        assert np.array_equal(a[key], b[key])
    for objective in ("rotate", "convergence", "shift_left",
                      "clockwise_up"):
        oa = [metrics.metric2objective(a, objective)] * 2
        ob = [pm.metric2objective(b, objective)] * 2
        assert oa == ob
        assert metrics.best_ids_all_metrics(oa, objective) == \
            pm.best_ids_all_metrics(ob, objective)


@pytest.mark.cuda
def test_k1_graph_replay_matches_eager_steps(cuda_device):
    _, _, arrs = _arrays2d(cuda_device)
    poses = _poses2d(100, cuda_device)
    kw = dict(steps=400, regrasp_every=200, snapshot_step=200)
    eager = k1.rollout(*arrs, poses, graph=False, **kw)
    replay = k1.rollout(*arrs, poses, graph=True, **kw)
    for a, b in zip(eager, replay):
        assert torch.equal(a, b)
