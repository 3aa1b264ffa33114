"""The benchmark's graphed plain 3D rollout (``perfbench/reference/
k2_graph.py``) against the plain version it reorganises
(``perfbench/reference/k2.py``'s ``profile_batch_ref``), bit for bit on all
12 output planes, on the CPU (where it runs step by step without graphs):

- with the kernel's summation order (``sum_group=32``) on rows whose
  blocks take different branches in one step (one pair in finger contact
  from the start, one whose jaws close on nothing), across a re-grasp, so
  that the steps computing every branch on every row run;
- with ``torch.sum``'s order (``sum_group=0``, the cell's) on rows that all
  end in settled travel, so that the travel-only step runs too.
"""

import collections
import os

import numpy as np
import pytest
import torch

from perfbench.reference import k2, k2_graph, scene2d, scene3d
from perfbench.reference.fingers import sample_gripper_3d
from perfbench.reference.mesh3d import load_obj
from tests import torch_parity  # noqa: F401  (one torch thread)

OBJECTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench", "objects")
MESHES = {n: load_obj(os.path.join(OBJECTS, f"{n}.obj"))
          for n in ("crate_big", "mug_small")}


def _inputs(objects, grippers):
    scenes = []
    for name, g in zip(objects, grippers):
        verts, faces = MESHES[name]
        props = scene3d.object_properties_3d(verts, faces, num_points=256)
        scenes.append(scene3d.make_scene(*sample_gripper_3d(g), verts, faces,
                                         obj_props=props))
    arrs = scene3d.scene_arrays_3d(scene2d.stack_scenes(scenes),
                                   device="cpu")
    th = (np.linspace(-1.0, 1.0, 45) * np.pi + np.pi).astype(np.float32)
    th_p = scene2d.pad_poses(th[:, None])[:, 0]
    poses = torch.as_tensor(np.stack([np.zeros_like(th_p),
                                      np.zeros_like(th_p), th_p], -1))
    return arrs, poses


@pytest.mark.parametrize("objects, sum_group, steps, kinds", [
    (("crate_big", "mug_small"), 32, 80, {"masked"}),
    (("mug_small", "mug_small"), 0, 90, {"masked", "travel"}),
])
def test_graph_rollout_is_the_plain_rollout(monkeypatch, objects, sum_group,
                                            steps, kinds):
    arrs, poses = _inputs(objects, (3, 11))
    ran = collections.Counter()
    real = k2_graph._step

    def counted(st, pr, k, regrasp, kind="masked"):
        ran[kind] += 1
        return real(st, pr, k, regrasp, kind)

    monkeypatch.setattr(k2_graph, "_step", counted)
    kw = dict(steps=steps, regrasp_every=40, snapshot_step=40,
              sum_group=sum_group)
    want = k2.profile_batch_ref(*arrs, poses, **kw)
    got = k2_graph.rollout(*arrs, poses, **kw)
    for name, a, b in zip(k2.OUT_NAMES, got, want):
        assert torch.equal(a, b), name
    assert set(ran) == kinds and sum(ran.values()) == steps
    # the blocks took more than one branch over the run
    cfull, ccheap = want[9][:, 0], want[10][:, 0]
    assert float(ccheap.max()) > 0.0
    if "travel" in kinds:
        assert float((cfull + ccheap).max()) < steps
    else:
        assert float(cfull.max()) > 0.0
