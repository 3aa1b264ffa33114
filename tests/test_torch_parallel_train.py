"""The port's data-parallel trainers (dgdm_tpu_torch/parallel/,
train/dynamics.py, train/generator.py, models/profile2d.BatchNorm) on 4 gloo
ranks on the CPU, from the JAX package's initial weights
(models/convert.py), its global batch and its own draws of t and noise, at
the trainers' default learning rate 1e-4 (that of tests/test_multichip.py,
whose parameter bar is 5 x the step Adam gives a gradient of rounding
noise):

- against the port in one process on the same global batch: losses within
  2e-4 relative at each of 3 steps, parameters (the diffusion case: the EMA
  too) within 5e-4 absolute, BatchNorm running statistics within 1e-6 (the
  bars of tests/test_multichip.py; per-rank BatchNorm statistics, torch
  DDP's own, fail the running statistics by orders of magnitude);
- against JAX's data-parallel run over the 8 CPU devices of the conftest:
  the bars of tests/test_torch_training.py (losses within 1e-5 relative,
  parameters within 1e-5 absolute outside the Adam-sensitive elements);
- the port of tests/test_distributed.py's two-process run: both ranks end
  with the same parameters, bit for bit; the 2-rank checksum equals the
  1-rank one within 1e-4 relative; only rank 0 wrote metrics and the
  checkpoint, which loads in one process; the diffusion CLI over the same
  ranks gives the 1-rank losses within 2e-4.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.parallel import mesh as jmesh
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
from dgdm_tpu_torch.parallel import launch
from dgdm_tpu_torch.train import checkpoints
from dgdm_tpu_torch.train.generator import GeneratorTrainer
from tests import test_torch_training
from tests import torch_parity  # noqa: F401  (one torch thread)
from tests.test_torch_training import (
    TOTAL,
    _assert_dyn_state,
    _assert_gen_state,
    _dyn_draw,
    _dyn_pair,
    _gen_draw,
    _gen_pair,
    _load,
    _min_grads,
    _rel,
    null_biases,
)

STEPS = 3
LR = 1e-4


@pytest.fixture(autouse=True)
def _default_lr(monkeypatch):
    # the pairs of test_torch_training, and its Adam bound, at LR
    monkeypatch.setattr(test_torch_training, "LR", LR)


def _close_states(got, ref, atol, stats_atol=None, what=""):
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(r), k
            continue
        tol = stats_atol if stats_atol is not None and \
            k.endswith(("running_mean", "running_var")) else atol
        np.testing.assert_allclose(got[k], r, rtol=0, atol=tol,
                                   err_msg=f"{what}{k}")


def test_dynamics_dp_matches_one_process_and_jax(tmp_path):
    jtr, jstate, jbatch, ttr, batch, to_sd = _dyn_pair("2d")
    sd0 = to_sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    nulls = null_biases(ttr.model)
    # JAX's data-parallel run over the 8 CPU devices
    mesh = jmesh.data_parallel_mesh()
    assert mesh is not None and mesh.shape["dp"] == 8
    js = jmesh.replicate(mesh, jstate)
    sharded = jmesh.shard_batch(mesh, jbatch, "dp")
    spec = {f"sd/{k}": v for k, v in sd0.items()}
    spec.update({f"batch/{k}": v for k, v in batch.items()},
                lr=LR, total=TOTAL, steps=STEPS)
    jm = []
    for i in range(STEPS):
        key = jax.random.PRNGKey(10 + i)
        t, noise = _dyn_draw(jtr, key, batch["ctrl"].shape)
        spec[f"t{i}"], spec[f"noise{i}"] = t.numpy(), noise.numpy()
        ref = to_sd({"params": js.params, "batch_stats": js.batch_stats})
        spec.update({f"null{i}/{k}": ref[k] for k in nulls})
        js, m = jtr.train_step(js, sharded, key)
        jm.append({k: float(v) for k, v in m.items()})
    path = str(tmp_path / "spec.npz")
    np.savez(path, **spec)
    ranks = launch.start(4, "tests.torch_dist_ranks:dynamics_dp",
                         {"spec": path}, backend="gloo", timeout=300)
    # the port in one process, the same protocol
    params = dict(ttr.model.named_parameters())
    one = []
    for i in range(STEPS):
        with torch.no_grad():
            for k in nulls:
                params[k].copy_(torch.from_numpy(spec[f"null{i}/{k}"]))
        m = ttr.step(batch, torch.from_numpy(spec[f"t{i}"]),
                     torch.from_numpy(spec[f"noise{i}"]))
        one.append({k: float(v) for k, v in m.items()})
    outs = ranks.wait()
    one_state = {k: v.detach().numpy() for k, v in
                 ttr.model.state_dict().items()}
    for r, out in enumerate(outs):
        for k, v in out["state"].items():     # every rank holds one state
            np.testing.assert_array_equal(v, outs[0]["state"][k], err_msg=k)
        for i in range(STEPS):
            assert _rel(out["metrics"][i]["loss"], one[i]["loss"]) < 2e-4
            assert _rel(out["metrics"][i]["loss"], jm[i]["loss"]) < 1e-5
            for k in ("acc_ori", "acc_x", "acc_y"):
                assert out["metrics"][i][k] == jm[i][k], (r, i, k)
    _close_states(outs[0]["state"], one_state, 5e-4, 1e-6)
    # against JAX's 8-device run, by tests/test_torch_training.py's bars
    _load(ttr.model, outs[0]["state"])
    _assert_dyn_state(js, ttr, to_sd, outs[0]["min_grads"], STEPS)


def test_generator_dp_matches_one_process_and_jax(tmp_path):
    jtr, jstate, ttr, batch = _gen_pair()
    mesh = jmesh.data_parallel_mesh()
    js = jmesh.replicate(mesh, jstate)
    sharded = jmesh.shard_batch(mesh, jnp.asarray(batch), "dp")
    spec = {f"sd/{k}": v for k, v in
            convert.unet_state_dict(jstate.params).items()}
    spec.update(batch=batch, lr=LR, total=TOTAL, steps=STEPS)
    jm, one = [], []
    min_grads = {}
    for i in range(STEPS):
        key = jax.random.PRNGKey(20 + i)
        t, noise = _gen_draw(jtr, key, batch.shape)
        spec[f"t{i}"], spec[f"noise{i}"] = t.numpy(), noise.numpy()
        js, m = jtr.train_step(js, sharded, key)
        jm.append(float(m["loss"]))
    path = str(tmp_path / "spec.npz")
    np.savez(path, **spec)
    ranks = launch.start(4, "tests.torch_dist_ranks:generator_dp",
                         {"spec": path}, backend="gloo", timeout=300)
    for i in range(STEPS):
        one.append(float(ttr.step(batch, torch.from_numpy(spec[f"t{i}"]),
                                  torch.from_numpy(spec[f"noise{i}"]))
                         ["loss"]))
        _min_grads(ttr.model, min_grads)
    outs = ranks.wait()
    for out in outs:
        for i in range(STEPS):
            assert _rel(out["metrics"][i]["loss"], one[i]) < 2e-4
            assert _rel(out["metrics"][i]["loss"], jm[i]) < 1e-5
        for k in ("state", "ema"):
            for n, v in out[k].items():
                np.testing.assert_array_equal(v, outs[0][k][n], err_msg=n)
    _close_states(outs[0]["ema"], {k: v.detach().numpy() for k, v in
                                   ttr.ema.state_dict().items()}, 5e-4)
    _close_states(outs[0]["state"], {k: v.detach().numpy() for k, v in
                                     ttr.model.state_dict().items()}, 5e-4)
    # against JAX's 8-device run, by tests/test_torch_training.py's bars
    dp = GeneratorTrainer(ConditionalUnet1D(down_dims=(16, 32)),
                          device="cpu")
    _load(dp.model, outs[0]["state"])
    _load(dp.ema, outs[0]["ema"])
    _assert_gen_state(js, dp, outs[0]["min_grads"], STEPS)


def test_two_process_training_matches_single(tmp_path):
    p2, p1 = tmp_path / "p2", tmp_path / "p1"
    r2 = launch.start(2, "tests.torch_dist_ranks:two_process_training",
                      {"outdir": str(p2)}, backend="gloo", timeout=300)
    r1 = launch.start(1, "tests.torch_dist_ranks:two_process_training",
                      {"outdir": str(p1)}, backend="gloo", timeout=300)
    s2, (s1,) = r2.wait(), r1.wait()
    assert [s["world"] for s in s2] == [2, 2] and s1["world"] == 1
    # both ranks agree bit for bit (replicated state)
    assert s2[0]["checksum"] == s2[1]["checksum"]
    np.testing.assert_allclose(s2[0]["checksum"], s1["checksum"], rtol=1e-4)
    # rank 0 wrote metrics, rank 1 did not; one checkpoint at the shared
    # path, which loads in one process
    rec = json.loads((p2 / "rank0" / "metrics.jsonl").read_text()
                     .splitlines()[0])
    assert rec["smoke"] == 1.0
    assert not (p2 / "rank1" / "metrics.jsonl").exists()
    tr = GeneratorTrainer(ConditionalUnet1D(input_dim=1), learning_rate=1e-3,
                          total_steps=3, num_train_timesteps=15,
                          device="cpu")
    checkpoints.restore(str(p2 / "ckpt" / "smoke"), tr)
    assert tr.step_count == 3
    got = float(sum(p.detach().abs().sum(dtype=torch.float64)
                    for p in tr.model.parameters()))
    assert got == s2[0]["checksum"]
    assert sorted(os.listdir(p2 / "ckpt")) == ["smoke"]
    # the training CLI over the same ranks: the global batch's losses
    assert s2[0]["cli_steps"] == s1["cli_steps"] == 3
    for a, b in zip(s2[0]["cli_losses"], s1["cli_losses"]):
        assert _rel(a, b) < 2e-4
    assert s2[0]["cli_losses"] == s2[1]["cli_losses"]
    assert (p2 / "cli" / "ckpt" / "last" / "model.npz").exists()
