"""The port's verification and sample CLI: sim_eval_batch_2d metric dicts vs
the JAX package (its Pallas path, interpreted) at a 400-step schedule; a CPU
run of dgdm_tpu_torch.cli.sample.main on tiny shapes; and an AST scan that
the port and chip_smoke.py import nothing of JAX or dgdm_tpu."""

import ast
import json
import os
from unittest import mock

import numpy as np
import jax
import jax.experimental.pallas as pl
import pytest
import torch

from dgdm_tpu.eval import simeval as jsimeval
from dgdm_tpu.geom.contour import extract_contours
from dgdm_tpu.geom.fingers import normalize_y, sample_gripper_2d
from dgdm_tpu.sim import pallas2d
from dgdm_tpu_torch.cli import sample as sample_cli
from dgdm_tpu_torch.eval import simeval as tsimeval
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
from tests.util_icons import make_icon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dgdm_tpu"}


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


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "dgdm_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
