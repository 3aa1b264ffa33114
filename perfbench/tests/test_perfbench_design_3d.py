"""The 3D design cell (``dgdm-3d.design``, ``traffic/design_3d.py``) on the
CPU, at a size the CPU holds (2 designs of a cut classifier and UNet, a
4 x 1 pose grid, 4 verification orientations padded to one 128-lane block,
60 steps with a re-grasp at 30, the jaws on ``crate_big`` from the first
steps):

- a block sends each (objective, mesh) pair once, the meshes alternating
  from the first, each mesh's objectives in an order the seed draws; two
  seeds send the same requests of a block in another order;
- a traced run is correct with every compared number 0 and reports the
  cell's seven per-layer metrics (its four own and the three it shares
  with the 2D design cell);
- the control moves the compared numbers (on the CPU only its float32
  point sums: TF32 exists on the card alone);
- each planted fault makes a run not correct: a DDIM step that returns its
  sample unchanged, a rollout of 1 step where the verification depth is
  asked for, half of the designs left out of the rollout, one rollout's
  answer altered;
- on the card, the graphed plain rollout is the eager one bit for bit at
  16 designs x 128 poses x 2,400 steps, and the control is not correct at
  the cell's own size.
"""

import copy
import time

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.core.profiling import TRACER
from perfbench import harness, run
from perfbench.tests.test_perfbench_spans import ProfiledStandIn

CELL = "dgdm-3d.design"
SEED = 2 ** 31 + 5309
CPU = torch.device("cpu")
NEW = ("verify3d_host_ms", "finger_build3d_ms", "rollout_roofline.verify3d",
       "mfu.design3d")
SHARED = ("guidance_ms", "guidance_step_ms", "idle_share.design")


def small_cell():
    cell = copy.deepcopy(harness.load_cell(CELL))
    cfg = cell.config
    cfg.update(grid_size=4, num_pos=1, verify_orientations=4,
               verify_steps=60, verify_regrasp=30, sub_bs=2,
               trunk_widths=[64] + [32] * 7,
               objects=cfg["objects"][::-1],
               object_files=cfg["object_files"][::-1])
    cfg["classifier"].update(width=32)
    cfg["unet"].update(down_dims=[16, 32], n_groups=4)
    cell.params.update(batch=2, check_requests=1)
    return cell


@pytest.fixture
def empty_tracer():
    TRACER.start()
    TRACER.stop()
    yield TRACER
    TRACER.start()
    TRACER.stop()


class ProfiledStandIn3D(ProfiledStandIn):
    """``ProfiledStandIn`` whose one kernel is K2."""

    def kernels(self):
        d = self.t1 - self.t0
        return [("rollout3d_kernel<32, 0>", self.t0 + 0.1 * d,
                 self.t0 + 0.4 * d)]


def _run(cell=None, control=False, seconds=0.1):
    """A run of the small cell -> (correct, compared numbers)."""
    out = run.run_cell(cell or small_cell(), SEED, seconds, False, CPU,
                       control=control)
    return out["correct"], {k: v["value"] for k, v in
                            out["compared"].items()}


# -- the traffic ------------------------------------------------------------

def _blocks(seed, n=2):
    cell = harness.load_cell(CELL)
    traffic = harness.traffic_class(cell)(cell, seed, CPU)
    traffic.objectives = list(range(12))
    traffic.meshes = [None, None]
    traffic.order = np.random.default_rng(seed)
    return [traffic._block() for _ in range(n)]


def test_a_block_sends_each_pair_once_the_meshes_alternating():
    for block in _blocks(2 ** 31 + 11):
        assert len(block) == 24
        assert [m for _, _, m in block] == [0, 1] * 12
        assert sorted((o, m) for _, o, m in block) == [
            (o, m) for o in range(12) for m in range(2)]
        assert all(item == m * 12 + o for item, o, m in block)


def test_seeds_send_the_same_requests_in_another_order():
    a, b = _blocks(5), _blocks(2 ** 32 + 5)
    for x, y in zip(a, b):
        assert x != y and sorted(x) == sorted(y)
    assert a[0] != a[1]


# -- correctness and metrics ------------------------------------------------

def test_traced_run_is_correct_and_reports_the_metrics(empty_tracer):
    out = run.run_cell(small_cell(), SEED, 0.1, True, CPU,
                       tracer=ProfiledStandIn3D())
    assert out["correct"], out["compared"]
    assert all(v["value"] == 0.0 for v in out["compared"].values())
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(NEW + SHARED)
    assert all(v > 0.0 for v in m.values()), m
    assert m["finger_build3d_ms"] < m["verify3d_host_ms"]
    names = {s[0] for s in TRACER.spans()}
    assert {"guidance.encode", "simeval3d.rollout", "scene3d.fit"} <= names


def test_control_moves_the_compared_numbers():
    ok, sound = _run()
    assert ok and all(v == 0.0 for v in sound.values())
    _, control = _run(control=True)
    assert control["pos_gap_m"] > 0.0


def _fault(monkeypatch, kind):
    from dgdm_tpu_torch.diffusion import ddim
    from dgdm_tpu_torch.sim import rollout3d

    real = rollout3d.rollout
    if kind == "ddim_unchanged":
        monkeypatch.setattr(ddim, "ddim_step",
                            lambda sched, eps, t, pt, x: x)
    elif kind == "rollout_one_step":
        monkeypatch.setattr(rollout3d, "rollout",
                            lambda *a, **kw: real(*a, **dict(kw, steps=1)))
    elif kind == "half_designs":
        def half(coefs, points, scalars, poses, **kw):
            h = coefs.shape[0] // 2
            out = real(coefs[:h], points[:h], scalars[:h], poses, **kw)
            return tuple(torch.cat([o, torch.zeros_like(o)]) for o in out)
        monkeypatch.setattr(rollout3d, "rollout", half)
    else:
        def altered(*a, **kw):
            out = list(real(*a, **kw))
            # the first design's first rollout: the final quaternion z
            out[1] = out[1].clone()
            out[1][0, 0] += 0.1
            return tuple(out)
        monkeypatch.setattr(rollout3d, "rollout", altered)


@pytest.mark.parametrize("kind", ["ddim_unchanged", "rollout_one_step",
                                  "half_designs", "altered_answer"])
def test_fault_is_not_correct(monkeypatch, kind):
    _fault(monkeypatch, kind)
    ok, numbers = _run()
    assert not ok, numbers


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_graph_rollout_is_the_eager_one_on_the_card(cuda_device):
    from perfbench.reference import k2, k2_graph, scene2d, scene3d
    from perfbench.reference.fingers import sample_gripper_3d
    from perfbench.reference.mesh3d import load_obj

    cfg = harness.load_cell(CELL).config
    scenes = []
    for i in range(16):
        verts, faces = load_obj(cfg["object_files"][i % 2])
        props = scene3d.object_properties_3d(verts, faces, num_points=256)
        scenes.append(scene3d.make_scene(*sample_gripper_3d(i), verts,
                                         faces, obj_props=props))
    arrs = scene3d.scene_arrays_3d(scene2d.stack_scenes(scenes),
                                   device=cuda_device)
    th = (np.linspace(-1.0, 1.0, 45) * np.pi + np.pi).astype(np.float32)
    th_p = scene2d.pad_poses(th[:, None])[:, 0]
    poses = torch.as_tensor(np.stack([np.zeros_like(th_p),
                                      np.zeros_like(th_p), th_p],
                                     -1)).to(cuda_device)
    kw = dict(steps=2400, regrasp_every=800, snapshot_step=800)
    t0 = time.perf_counter()
    want = k2.profile_batch_ref(*arrs, poses, **kw)
    t1 = time.perf_counter()
    got = k2_graph.rollout(*arrs, poses, **kw)
    torch.cuda.synchronize(cuda_device)
    t2 = time.perf_counter()
    print(f"eager {t1 - t0:.1f} s, graphs {t2 - t1:.1f} s")
    for name, a, b in zip(k2.OUT_NAMES, got, want):
        assert torch.equal(a, b), name
    assert float(want[9].max()) > 0.0


@pytest.mark.cuda
def test_control_is_not_correct_at_the_cells_size(cuda_device):
    out = run.run_cell(harness.load_cell(CELL), SEED, 0.1, False,
                       cuda_device, control=True)
    assert not out["correct"], out["compared"]
