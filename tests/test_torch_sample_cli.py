"""The port's verification and sample CLI: sim_eval_batch_2d and
sim_eval_batch_3d metric dicts vs the JAX package (its Pallas path,
interpreted) at shortened schedules; guided sampling on 42-point 3D samples
with a width-32 ProfileForward3D vs the JAX sampler (<= 2e-4); CPU runs of
dgdm_tpu_torch.cli.sample.main on tiny shapes, 2D and --fingers_3d; and an
AST scan that the port and chip_smoke.py import nothing of JAX or
dgdm_tpu."""

import ast
import glob
import json
import os
from unittest import mock

import numpy as np
import jax
import jax.experimental.pallas as pl
import pytest
import torch

import jax.numpy as jnp
from dgdm_tpu.design.guidance import GuidedSampler2D as JSampler
from dgdm_tpu.eval import simeval as jsimeval
from dgdm_tpu.eval import simeval3d as jsimeval3d
from dgdm_tpu.geom import mesh3d as jmesh
from dgdm_tpu.geom.contour import extract_contours
from dgdm_tpu.geom.fingers import (
    normalize_y,
    sample_gripper_2d,
    sample_gripper_3d,
)
from dgdm_tpu.models.profile3d import ProfileForward3D as JProfile3D
from dgdm_tpu.models.unet1d import ConditionalUnet1D as JUnet
from dgdm_tpu.sim import pallas2d, pallas3d
from dgdm_tpu_torch.cli import sample as sample_cli
from dgdm_tpu_torch.design.guidance import GuidedSampler
from dgdm_tpu_torch.eval import simeval as tsimeval
from dgdm_tpu_torch.eval import simeval3d as tsimeval3d
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.models.profile3d import ProfileForward3D
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
from tests import torch_parity  # noqa: F401  (one torch thread)
from tests.util_icons import make_icon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dgdm_tpu"}
OBJECTS = os.path.join(ROOT, "tests", "fixtures", "scanned_objects")


def test_sim_eval_metrics_match_jax():
    contour = extract_contours(make_icon(3))
    ys = np.stack([np.concatenate(sample_gripper_2d(i)) for i in (0, 1)])
    pts_y = np.asarray(normalize_y(ys), np.float32)
    kw = dict(num_rot=128, total_steps=400, regrasp_every=200)
    orig = pl.pallas_call

    def interp(*args, **k):
        k["interpret"] = True
        return orig(*args, **k)

    with mock.patch.object(pallas2d.pl, "pallas_call", interp), \
            mock.patch.object(jsimeval.jax, "default_backend", lambda: "tpu"):
        ref = jsimeval.sim_eval_batch_2d(pts_y, [contour], **kw)
    out = tsimeval.sim_eval_batch_2d(pts_y, [contour], device="cpu", **kw)
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert o.keys() == r.keys()
        assert np.abs(r["delta_theta"]).max() > np.degrees(1e-2)
        for k, tol in (("delta_theta", np.degrees(1e-3)),
                       ("delta_pos", 0.1), ("final_pos", 0.1)):
            frac = np.mean(np.abs(o[k] - r[k]) < tol)
            assert frac >= 0.99, (k, frac)
        for k in ("profile", "profile_x", "profile_y"):
            assert np.mean(o[k] == r[k]) >= 0.99, k
        # final orientation after the regrasp: statistically
        assert np.corrcoef(o["final_theta"], r["final_theta"])[0, 1] > 0.999
    for objective in ("rotate", "shift_up", "convergence"):
        a = tsimeval.objectives_table(out, objective)
        b = jsimeval.objectives_table(ref, objective)
        assert [x.keys() for x in a] == [x.keys() for x in b]


def test_sim_eval_3d_metrics_match_jax():
    """2 grippers x mug_small x 8 orientations (padded to 128), 1,600 steps
    with regrasp and snapshot at 800."""
    verts, faces = jmesh.load_obj(os.path.join(OBJECTS, "mug_small",
                                               "model.obj"))
    ys = np.stack([np.concatenate(sample_gripper_3d(i)) for i in (0, 1)])
    pts_y = np.asarray(normalize_y(ys, fingers_3d=True), np.float32)
    kw = dict(num_rot=8, total_steps=1600, regrasp_every=800)
    orig = pl.pallas_call

    def interp(*args, **k):
        k["interpret"] = True
        return orig(*args, **k)

    with mock.patch.object(pallas3d.pl, "pallas_call", interp), \
            mock.patch.object(jsimeval3d.jax, "default_backend",
                              lambda: "tpu"):
        ref = jsimeval3d.sim_eval_batch_3d(pts_y, [(verts, faces)], **kw)
    out = tsimeval3d.sim_eval_batch_3d(pts_y, [(verts, faces)], device="cpu",
                                       **kw)
    assert len(out) == len(ref) == 2
    assert max(np.abs(r["delta_theta"]).max() for r in ref) > np.degrees(1e-2)
    for o, r in zip(out, ref):
        assert o.keys() == r.keys()
        for k in o:
            assert o[k].shape == r[k].shape, k
        for k, tol in (("delta_theta", np.degrees(1e-3)),
                       ("delta_pos", 0.1), ("final_pos", 0.1),
                       ("final_theta", np.degrees(1e-3))):
            frac = np.mean(np.abs(o[k] - r[k]) < tol)
            assert frac >= 0.99, (k, frac)
        for k in ("profile", "profile_x", "profile_y"):
            assert np.mean(o[k] == r[k]) >= 0.99, k
    for objective in ("rotate", "shift_up", "convergence"):
        a = tsimeval.objectives_table(out, objective)
        b = jsimeval.objectives_table(ref, objective)
        assert [x.keys() for x in a] == [x.keys() for x in b]


GRID3, NUM_POS3, B3 = 8, 2, 2


@pytest.fixture(scope="module")
def samplers_3d():
    """The JAX and the port's guided samplers on 42-point 3D samples: UNet
    down_dims (16, 32), ProfileForward3D width 32, the same weights."""
    ju, jc = JUnet(down_dims=(16, 32)), JProfile3D(width=32)
    key = jax.random.PRNGKey(0)
    uparams = jax.tree.map(np.asarray, ju.init(
        key, jnp.zeros((B3, 42, 1)), jnp.zeros((B3,), jnp.int32))["params"])
    cv = jc.init(key, jnp.zeros((2, 42)), jnp.zeros((2, 1)), jnp.zeros((2, 2)),
                 jnp.zeros((2,)), jnp.zeros((2, 64, 3)))
    rs = np.random.RandomState(0)
    cvars = {"params": jax.tree.map(np.asarray, cv["params"]),
             "batch_stats": jax.tree.map(
                 lambda a: (np.abs(np.asarray(a) + 0.1 * rs.randn(*a.shape))
                            + 0.8).astype(np.float32), cv["batch_stats"])}
    js = JSampler(ju, jc, grid_size=GRID3, num_pos=NUM_POS3, pose_chunks=4)
    tu = ConditionalUnet1D(down_dims=(16, 32))
    tu.load_state_dict({k: torch.from_numpy(v) for k, v in
                        convert.unet_state_dict(uparams).items()})
    tc = ProfileForward3D(width=32)
    tc.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                        convert.profile3d_state_dict(cvars).items()})
    ts = GuidedSampler(tu, tc, grid_size=GRID3, num_pos=NUM_POS3,
                       pose_chunks=4, device="cpu")
    rs = np.random.RandomState(1)
    noise = rs.randn(B3, 42, 1).astype(np.float32)
    objs = rs.uniform(-1, 1, (2, 96, 3)).astype(np.float32)
    return js, uparams, cvars, ts, noise, objs


@pytest.mark.parametrize("objective", ["rotate_clockwise", "convergence"])
def test_guided_sample_3d_matches_jax(samplers_3d, objective):
    js, uparams, cvars, ts, noise, objs = samplers_3d
    centers = np.array([1, 6]) if objective == "convergence" else None
    scale = 5.0
    ref = np.asarray(js.sample(
        uparams, cvars, jnp.asarray(noise), jnp.asarray(objs[0]), objective,
        jnp.asarray(scale),
        centers=None if centers is None else jnp.asarray(centers)))
    out = ts.sample(noise, objs[0], objective, scale,
                    centers=None if centers is None
                    else torch.from_numpy(centers)).numpy()
    assert out.shape == (B3, 42, 1)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def test_guided_sweep_and_multi_object_3d_match_jax(samplers_3d):
    js, uparams, cvars, ts, noise, objs = samplers_3d
    names = ["shift_up", "rotate", "convergence"]
    jin = js.sweep_inputs(cvars, names, jnp.asarray(objs), fingers_3d=True)
    tin = ts.sweep_inputs(names, objs, fingers_3d=True)
    assert tin[4] == jin[4] and len(tin[4]) == 4
    np.testing.assert_allclose(tin[0].numpy(), np.asarray(jin[0]), atol=1e-5)
    for a, b in zip(tin[1:4], jin[1:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = np.asarray(js.sample_sweep(uparams, cvars, jnp.asarray(noise),
                                     *jin[:4]))
    out = ts.sample_sweep(noise, *tin[:4]).numpy()
    assert out.shape == (4, B3, 42, 1)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)
    ref = np.asarray(js.sample_multi_object(
        uparams, cvars, jnp.asarray(noise), jnp.asarray(objs), "shift_up",
        jnp.asarray(1.0)))
    out = ts.sample_multi_object(noise, objs, "shift_up", 1.0).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=0)


def _write_checkpoints(tmp_path):
    torch.manual_seed(0)
    unet = ConditionalUnet1D(input_dim=1)
    cls = ProfileForward2D(params_ch=14, object_ch=200)
    with torch.no_grad():
        for bn in cls.trunk_bns:
            bn.running_mean.normal_(0.0, 0.1)
            bn.running_var.uniform_(0.8, 1.2)
    gpath, dpath = str(tmp_path / "unet.npz"), str(tmp_path / "dyn.npz")
    convert.save_npz(gpath, unet.state_dict(), {"down_dims": [128, 256]})
    convert.save_npz(dpath, cls.state_dict(),
                     {"width": 256, "num_trunk": 8, "object_ch": 200})
    return gpath, dpath


def test_sample_cli_cpu(tmp_path):
    gpath, dpath = _write_checkpoints(tmp_path)
    save_dir = str(tmp_path / "out")
    report = sample_cli.main([
        "--diffusion_checkpoint_path", gpath,
        "--checkpoint_path", dpath,
        "--save_dir", save_dir,
        "--batch_size", "2",
        "--grid_size", "8",
        "--num_pos", "1",
        "--sub_bs", "8",
        "--objectives", "convergence,rotate",
        "--num_test_objects", "1",
        "--eval_steps", "60",
        "--device", "cpu",
    ])
    with open(os.path.join(save_dir, "guided_report.json")) as f:
        saved = json.load(f)
    assert saved.keys() == report.keys()
    for objective in ("convergence", "rotate"):
        (entry,) = saved[objective]["objects"].values()
        assert "best_ids" in entry and "unguided" in entry
        samples = np.load(os.path.join(save_dir,
                                       f"samples_{objective}_10000.npy"))
        assert samples.shape == (2, 14, 1) and np.isfinite(samples).all()
    assert "multi_object" in saved["rotate"]
    avg = saved["rotate"]["multi_object_average"]
    assert "best_ids" in avg and "mean_success" in avg
    assert saved["design_sweep"]["pairs"] == 1
    assert saved["verification"]["device"] == "cpu"


def test_sample_cli_3d_cpu(tmp_path):
    torch.manual_seed(0)
    gpath, dpath = str(tmp_path / "unet.npz"), str(tmp_path / "dyn3d.npz")
    convert.save_npz(gpath, ConditionalUnet1D(input_dim=1).state_dict(),
                     {"down_dims": [128, 256]})
    convert.save_npz(dpath, ProfileForward3D(width=32).state_dict(),
                     {"width": 32, "params_ch": 42})
    save_dir = str(tmp_path / "out3d")
    report = sample_cli.main([
        "--fingers_3d", "--ctrlpts_dim", "42",
        "--diffusion_checkpoint_path", gpath,
        "--checkpoint_path", dpath,
        "--save_dir", save_dir,
        "--batch_size", "2",
        "--grid_size", "8",
        "--num_pos", "1",
        "--sub_bs", "8",
        "--objectives", "convergence,shift_up",
        "--object_dir", OBJECTS,
        "--object_max_num_vertices", "100",
        "--eval_steps", "60",
        "--device", "cpu",
    ])
    with open(os.path.join(save_dir, "guided_report.json")) as f:
        saved = json.load(f)
    assert saved.keys() == report.keys()
    for objective in ("convergence", "shift_up"):
        (entry,) = saved[objective]["objects"].values()
        assert "best_ids" in entry and "unguided" in entry
        samples = np.load(os.path.join(save_dir,
                                       f"samples_{objective}_mug_small.npy"))
        assert samples.shape == (2, 42, 1) and np.isfinite(samples).all()
    assert "multi_object" in saved["shift_up"]
    assert saved["design_sweep"]["pairs"] == 1
    assert saved["verification"]["device"] == "cpu"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_imports_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "dgdm_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_core_and_geom_import_nothing_of_sim():
    """The layers run one way: ``core`` and ``geom`` sit below ``sim``."""
    files = [p for layer in ("core", "geom") for p in glob.glob(
        os.path.join(ROOT, "dgdm_tpu_torch", layer, "*.py"))]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            assert not (mod + ".").startswith("dgdm_tpu_torch.sim."), (
                path, mod)
