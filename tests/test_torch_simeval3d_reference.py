"""``eval/simeval3d.sim_eval_batch_3d`` against the benchmark's plain
reference, on the CPU at a cut depth: 2 designs x 45 orientations (one
128-pose block each) x 400 steps with a re-grasp and the snapshot at 200,
on a mesh the jaws touch from the first steps. The reference builds the
scenes again from the same normalized samples (``perfbench/reference/
scene3d.py``) and runs ``reference/k2_graph.py``; every one of the 12 raw
output planes of the program's rollout is the reference's bit for bit. The
call opens its ``simeval3d.*`` spans once each, with one ``scene3d.fingers``
span a design inside ``simeval3d.scenes`` and the surface fits' one
``scene3d.fit`` inside ``simeval3d.arrays``.
"""

import os

import numpy as np
import torch

from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.eval.simeval3d import sim_eval_batch_3d
from dgdm_tpu_torch.sim import rollout3d
from perfbench.reference import k2, k2_graph, scene2d, scene3d
from perfbench.reference.fingers import denormalize_y
from perfbench.reference.mesh3d import load_obj
from tests import torch_parity  # noqa: F401  (one torch thread)

MESH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "perfbench", "objects", "crate_big.obj")
STEPS, REGRASP, NUM_ROT = 400, 200, 45
SPANS = ("simeval3d.object", "simeval3d.scenes", "simeval3d.arrays",
         "simeval3d.rollout", "simeval3d.fetch", "simeval3d.metrics")


def _reference(pts_y, verts, faces):
    y = np.asarray(denormalize_y(pts_y, fingers_3d=True))
    n = y.shape[1] // 2
    props = scene3d.object_properties_3d(verts, faces)
    scenes = scene2d.stack_scenes([
        scene3d.make_scene(yi[:n], yi[n:], verts, faces, obj_props=props)
        for yi in y])
    arrs = scene3d.scene_arrays_3d(scenes, device="cpu")
    th = (np.linspace(-1.0, 1.0, NUM_ROT) * np.pi + np.pi).astype(np.float32)
    th_p = scene2d.pad_poses(th[:, None])[:, 0]
    poses = torch.as_tensor(np.stack([np.zeros_like(th_p),
                                      np.zeros_like(th_p), th_p], -1))
    return k2_graph.rollout(*arrs, poses, steps=STEPS,
                            regrasp_every=REGRASP, snapshot_step=REGRASP)


def test_rollouts_are_the_reference_and_the_spans_open(monkeypatch):
    verts, faces = load_obj(MESH)
    pts_y = np.random.default_rng(20240226).uniform(
        -1.0, 1.0, (2, 42)).astype(np.float32)
    captured = []
    real = rollout3d.rollout

    def capture(*a, **kw):
        captured.append(real(*a, **kw))
        return captured[-1]

    monkeypatch.setattr(rollout3d, "rollout", capture)
    TRACER.start()
    try:
        metrics = sim_eval_batch_3d(pts_y, [(verts, faces)], num_rot=NUM_ROT,
                                    total_steps=STEPS, regrasp_every=REGRASP,
                                    device="cpu")
    finally:
        spans = TRACER.stop()
        TRACER.start()
        TRACER.stop()
    (got,) = captured
    want = _reference(pts_y, verts, faces)
    for name, a, b in zip(k2.OUT_NAMES, got, want):
        assert torch.equal(a, b), name
    assert float(want[9].min()) > 0.0, "no full solve: the jaws did not touch"
    assert len(metrics) == 2
    assert max(float(np.abs(m["delta_theta"]).max()) for m in metrics) > 0.5

    names = [s[0] for s in spans]
    assert [n for n in names if n.startswith("simeval3d.")] == list(SPANS)
    by_name = {s[0]: s for s in spans}
    fingers = [s for s in spans if s[0] == "scene3d.fingers"]
    assert len(fingers) == 2 and names.count("scene3d.fit") == 1
    for s in fingers:
        assert by_name["simeval3d.scenes"][1] <= s[1] \
            and s[2] <= by_name["simeval3d.scenes"][2]
    fit = by_name["scene3d.fit"]
    assert by_name["simeval3d.arrays"][1] <= fit[1] \
        and fit[2] <= by_name["simeval3d.arrays"][2]
