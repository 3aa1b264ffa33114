"""The port's trainers (dgdm_tpu_torch/train/) against the JAX package's, in
float32 at small widths, from the same weights (carried by
models/convert.py), the same batch and the JAX side's own t and noise draws:

- DynamicsTrainer (ProfileForward2D width 32, 2 trunk layers, 64 rows; one
  case with weight decay and warmup; ProfileForward3D width 32 at 32
  points): loss within 1e-5 relative at each of 3 steps, parameters within
  1e-5 absolute and BatchNorm running statistics within 1e-5 relative after
  them, class accuracies equal;
- GeneratorTrainer (UNet down_dims (16, 32)): loss within 1e-5 relative,
  parameters and EMA within 1e-5 absolute after 3 steps; ema_decay over
  steps 0..1000 within 1e-7; recon_metrics and sample_trajectory within
  1e-5 on the same noise;
- both LR schedules equal optax's to 1e-6 relative at every count from 0 to
  total_steps + 2;
- checkpoints: save after 2 steps, restore, a 3rd step is bitwise equal to
  3 uninterrupted steps; latest_step_dir as in JAX; an orbax checkpoint that
  JAX wrote after 2 steps, exported by scripts/export_jax_checkpoint.py and
  stepped once in the port, matches JAX's 3rd step within 1e-5.
"""

import contextlib
import importlib.util
import os
from unittest import mock

import numpy as np
import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dgdm_tpu.models.profile2d import ProfileForward2D as JProfile2D
from dgdm_tpu.models.profile3d import ProfileForward3D as JProfile3D
from dgdm_tpu.models.unet1d import ConditionalUnet1D as JUnet
from dgdm_tpu.train import checkpoints as jckpt
from dgdm_tpu.train.dynamics import DynamicsTrainer as JDyn
from dgdm_tpu.train.generator import GeneratorTrainer as JGen
from dgdm_tpu.train.generator import ema_decay as jema_decay
from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.models.profile3d import ProfileForward3D
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
from dgdm_tpu_torch.train import checkpoints
from dgdm_tpu_torch.train.dynamics import DynamicsTrainer
from dgdm_tpu_torch.train.generator import GeneratorTrainer, ema_decay
from tests import torch_parity  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
TOTAL = 10


def _export_module():
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint",
        os.path.join(ROOT, "scripts", "export_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(n, fingers_3d=False, points=32, seed=0):
    # one object per row: with one object for all rows its encoding is a
    # constant shift ahead of a BatchNorm, and its whole encoder would have
    # no gradient (see null_biases)
    rs = np.random.RandomState(seed)
    return {
        "ctrl": rs.uniform(-1, 1, (n, 42 if fingers_3d else 14)),
        "ori": rs.uniform(-1, 1, (n, 1)),
        "pos": rs.uniform(-1, 1, (n, 2)),
        "obj": rs.uniform(-1, 1, (n, points, 3) if fingers_3d else (n, 200)),
        "score": rs.randn(n, 3) * 2.0,
    }


def _f32(batch):
    return {k: np.asarray(v, np.float32) for k, v in batch.items()}


def _dyn_draw(jtr, key, ctrl_shape):
    """The t and noise that JAX's DynamicsTrainer._noised_inputs draws."""
    t = jax.random.randint(key, (ctrl_shape[0],), 0, jtr.num_train_timesteps)
    noise = jax.random.normal(jax.random.fold_in(key, 1), ctrl_shape)
    return (torch.from_numpy(np.asarray(t)).long(),
            torch.from_numpy(np.asarray(noise)))


def _gen_draw(jtr, key, shape):
    """The t and noise that JAX's GeneratorTrainer.train_step draws."""
    t_rng, n_rng = jax.random.split(key)
    t = jax.random.randint(t_rng, (shape[0],), 0, jtr.num_train_timesteps)
    noise = jax.random.normal(n_rng, shape)
    return (torch.from_numpy(np.asarray(t)).long(),
            torch.from_numpy(np.asarray(noise)))


def _load(model, sd):
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()})
    return model


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


DYN_CASES = {
    "2d": dict(weight_decay=0.0, warmup_steps=0, fingers_3d=False, rows=64),
    "2d_decay_warmup": dict(weight_decay=1e-2, warmup_steps=2,
                            fingers_3d=False, rows=64),
    "3d": dict(weight_decay=0.0, warmup_steps=0, fingers_3d=True, rows=8,
               steps=1, grad_floor=1e-4, weak_share=0.1),
}


def _blocked_stats(x, axes, dtype=None, **_):
    """flax's batch statistics (E[x], E[x^2] - E[x]^2 clipped at 0, float32)
    summed in blocks of 256 rows. The PointNet++ BatchNorms of the 3D case
    reduce 131,072 rows, over which XLA's CPU float32 sum is off by ~3e-5
    (mean) and ~1e-4 (variance) relative to the exact values, measured;
    the port's float64 sums are exact to float32, so the 3D reference is
    given sums accurate enough (~1e-6) for the 1e-5 bar."""
    x = jnp.asarray(x, jnp.float32)
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    blk = 256 if n % 256 == 0 else 1

    def mean(v):
        return v.reshape(n // blk, blk, -1).mean(1).mean(0)

    mu = mean(flat)
    return mu, jnp.maximum(0.0, mean(flat * flat) - mu * mu)


def _dyn_pair(case):
    c = DYN_CASES[case]
    if c["fingers_3d"]:
        jmodel, tmodel = JProfile3D(width=32), ProfileForward3D(width=32)
        to_sd = convert.profile3d_state_dict
    else:
        jmodel = JProfile2D(width=32, num_trunk=2, object_ch=200)
        tmodel = ProfileForward2D(width=32, num_trunk=2, object_ch=200)
        to_sd = convert.profile2d_state_dict
    kw = dict(learning_rate=LR, weight_decay=c["weight_decay"],
              total_steps=TOTAL, warmup_steps=c["warmup_steps"],
              fingers_3d=c["fingers_3d"])
    jtr = JDyn(jmodel, **kw)
    jtr.stats = (mock.patch.object(flax_norm, "_compute_stats",
                                   _blocked_stats) if c["fingers_3d"]
                 else contextlib.nullcontext())
    batch = _f32(_rows(c["rows"], c["fingers_3d"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jtr.stats:
        jstate = jtr.init(jax.random.PRNGKey(0), jbatch)
    sd = to_sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    ttr = DynamicsTrainer(_load(tmodel, sd), device="cpu", **kw)
    return jtr, jstate, jbatch, ttr, batch, to_sd


def null_biases(model):
    """Biases that reach a train-mode BatchNorm through linear maps only:
    the layer right before each BatchNorm, and the last layer of each
    encoder that feeds the first trunk layer. A change of one shifts the
    BatchNorm's input by the same vector on every row, which the batch mean
    takes out again, so their gradient is zero in exact arithmetic; what
    each framework computes is rounding noise (~1e-9), which Adam (eps
    1e-8) turns into steps of up to the learning rate in random directions.
    Their values are therefore compared by that bound, and the tests copy
    JAX's values into the port before each step so that both forward
    passes, the batch statistics and every other update see the same
    network."""
    names = [n for n, _ in model.named_parameters() if n.endswith(".bias")
             and (n.startswith("trunk_layers.") or ".mlps." in n
                  or n in ("gripper_encoder.fc1.bias",
                           "object_encoder.fc1.bias", "time_out.bias"))]
    return names


def _sync_null(jstate, ttr, to_sd):
    ref = to_sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    params = dict(ttr.model.named_parameters())
    with torch.no_grad():
        for k in null_biases(ttr.model):
            params[k].copy_(torch.from_numpy(ref[k]))


def _assert_null_grads_vanish(ttr):
    """Their gradients are rounding noise: far below the largest one (the
    PointNet++ BatchNorms sum over 131,072 rows, hence 1e-4 and not 1e-6)."""
    grads = {n: p.grad.abs().max().item()
             for n, p in ttr.model.named_parameters() if p.grad is not None}
    top = max(grads.values())
    for k in null_biases(ttr.model):
        assert grads[k] <= 1e-4 * top, (k, grads[k], top)


def _assert_dyn_state(jstate, ttr, to_sd, min_grads, steps, floor=1e-6,
                      share=0.01):
    """Running statistics within 1e-5 relative; parameters within 1e-5
    absolute except the Adam-sensitive elements (``_assert_weak``)."""
    ref = to_sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = {k: v.detach().numpy() for k, v in ttr.model.state_dict().items()}
    params = {}
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            # relative to each entry, or to the tensor's scale for entries
            # near zero
            np.testing.assert_allclose(got[k], r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=k)
        else:
            params[k] = (got[k], r)
    _assert_weak(params, min_grads, steps, set(null_biases(ttr.model)),
                 share=share, floor=floor)


@pytest.mark.parametrize("case", sorted(DYN_CASES))
def test_dynamics_step_matches_jax(case):
    jtr, jstate, jbatch, ttr, batch, to_sd = _dyn_pair(case)
    min_grads = {}
    steps = DYN_CASES[case].get("steps", 3)
    for i in range(steps):
        key = jax.random.PRNGKey(10 + i)
        t, noise = _dyn_draw(jtr, key, batch["ctrl"].shape)
        _sync_null(jstate, ttr, to_sd)
        with jtr.stats:
            jstate, jm = jtr.train_step(jstate, jbatch, key)
        tm = ttr.step(batch, t, noise)
        _assert_null_grads_vanish(ttr)
        _min_grads(ttr.model, min_grads)
        assert _rel(tm["loss"], jm["loss"]) < 1e-5, (i, tm["loss"],
                                                     jm["loss"])
        for k in ("acc_ori", "acc_x", "acc_y"):
            assert float(tm[k]) == float(jm[k]), (i, k)
    c = DYN_CASES[case]
    _assert_dyn_state(jstate, ttr, to_sd, min_grads, steps,
                      c.get("grad_floor", 1e-6), c.get("weak_share", 0.01))
    # eval mode on the state the JAX steps left behind (the Adam-sensitive
    # elements synced too)
    _load(ttr.model, to_sd({"params": jstate.params,
                            "batch_stats": jstate.batch_stats}))
    key = jax.random.PRNGKey(99)
    t, noise = _dyn_draw(jtr, key, batch["ctrl"].shape)
    jm = jtr.eval_step(jstate, jbatch, key)
    tm = ttr.eval_step(batch, t, noise)
    assert _rel(tm["loss"], jm["loss"]) < 1e-5
    for k in ("acc_ori", "acc_x", "acc_y"):
        assert float(tm[k]) == float(jm[k]), k


def test_class_accuracy_matches_jax():
    rs = np.random.RandomState(3)
    pred, score = rs.randn(512, 3).astype(np.float32), \
        rs.randn(512, 3).astype(np.float32)
    for f3d in (False, True):
        jtr = JDyn(JProfile2D(width=32, num_trunk=2), fingers_3d=f3d)
        ttr = DynamicsTrainer(ProfileForward2D(width=32, num_trunk=2),
                              fingers_3d=f3d, device="cpu")
        ref = jtr.class_accuracy(jnp.asarray(pred), jnp.asarray(score))
        out = ttr.class_accuracy(torch.from_numpy(pred),
                                 torch.from_numpy(score))
        assert {k: float(v) for k, v in out.items()} == \
            {k: float(v) for k, v in ref.items()}


def _gen_pair(total=TOTAL, warmup=0):
    jtr = JGen(JUnet(down_dims=(16, 32)), learning_rate=LR,
               total_steps=total, warmup_steps=warmup)
    batch = np.random.RandomState(1).uniform(-1, 1, (8, 14, 1)) \
        .astype(np.float32)
    jstate = jtr.init(jax.random.PRNGKey(0), jnp.asarray(batch))
    tmodel = _load(ConditionalUnet1D(down_dims=(16, 32)),
                   convert.unet_state_dict(jstate.params))
    ttr = GeneratorTrainer(tmodel, learning_rate=LR, total_steps=total,
                           warmup_steps=warmup, device="cpu")
    return jtr, jstate, ttr, batch


def _min_grads(model, seen=None):
    """Elementwise min |gradient| over the steps so far (numpy, by name)."""
    seen = {} if seen is None else seen
    for n, p in model.named_parameters():
        g = p.grad.abs().numpy()
        seen[n] = np.minimum(seen[n], g) if n in seen else g
    return seen


def _assert_weak(pairs, min_grads, steps, null=frozenset(), share=0.01,
                 floor=1e-6):
    """pairs: name -> (port array, JAX array). Within 1e-5 absolute, except
    elements whose gradient fell below ``floor`` at some step (2D: 1e-6,
    100 x Adam's eps; 3D: 1e-4): there Adam's step g / (|g| + eps) turns
    the frameworks' float32 rounding of the gradient (2D ~1e-6 of the
    tensor's largest entry; 3D up to ~1e-4, its PointNet++ BatchNorms having
    channels of variance ~1e-6 against eps 1e-5; measured) into differences
    of up to the learning rate. Those are held to the Adam
    bound, as are the ``null`` tensors (null_biases: no gradient but
    rounding noise, which in the 3D case's 131,072-row sums reaches ~1e-4
    of the largest); outside these the weak elements must stay under
    ``share`` of all."""
    n_weak = n_all = 0
    for k, (got, ref) in pairs.items():
        weak = min_grads[k.replace("ema.", "", 1)] < floor
        if k in null:
            weak[...] = True
        d = np.abs(got - ref)
        assert (d[~weak] <= 1e-5).all(), (k, d[~weak].max())
        assert (d[weak] <= 2 * LR * steps).all(), k
        if k not in null:
            n_weak += int(weak.sum())
            n_all += weak.size
    assert n_weak <= share * n_all, (n_weak, n_all)


def _assert_gen_state(jstate, ttr, min_grads, steps):
    """Parameters and EMA after the steps (``_assert_weak``)."""
    pairs = {}
    for tag, tree, mod in (("", jstate.params, ttr.model),
                           ("ema.", jstate.ema_params, ttr.ema)):
        got = mod.state_dict()
        for k, r in convert.unet_state_dict(tree).items():
            pairs[tag + k] = (got[k].detach().numpy(), r)
    _assert_weak(pairs, min_grads, steps)


def test_generator_step_matches_jax():
    jtr, jstate, ttr, batch = _gen_pair()
    min_grads = {}
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        t, noise = _gen_draw(jtr, key, batch.shape)
        jstate, jm = jtr.train_step(jstate, jnp.asarray(batch), key)
        tm = ttr.step(batch, t, noise)
        _min_grads(ttr.model, min_grads)
        assert _rel(tm["loss"], jm["loss"]) < 1e-5, i
        assert abs(float(tm["ema_decay"]) - float(jm["ema_decay"])) < 1e-7
    _assert_gen_state(jstate, ttr, min_grads, 3)
    # recon_metrics on the noise JAX draws from its key; eval_step
    key = jax.random.PRNGKey(7)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, batch.shape)))
    ref = jtr.recon_metrics(jstate, jnp.asarray(batch), key, 5)
    out = ttr.recon_metrics(batch, noise, 5)
    for k in ref:
        assert abs(float(out[k]) - float(ref[k])) <= 1e-5, k
    t, noise = _gen_draw(jtr, key, batch.shape)
    ref = jtr.eval_step(jstate, jnp.asarray(batch), key)
    assert _rel(ttr.eval_step(batch, t, noise)["loss"], ref["loss"]) < 1e-5
    # EMA sampling, with the trajectory
    x0 = np.random.RandomState(5).randn(4, 14, 1).astype(np.float32)
    rout, rtraj = jtr.sample_trajectory(jstate, jnp.asarray(x0), 5)
    tout, ttraj = ttr.sample_trajectory(torch.from_numpy(x0), 5)
    assert ttraj.shape == (6, 4, 14, 1)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(rtraj), atol=1e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(rout), atol=1e-5)
    np.testing.assert_allclose(ttr.sample(torch.from_numpy(x0), 5).numpy(),
                               np.asarray(jtr.sample(jstate, jnp.asarray(x0),
                                                     5)), atol=1e-5)


def test_ema_decay_matches_jax():
    steps = np.arange(0, 1001)
    ref = np.asarray(jax.vmap(jema_decay)(jnp.asarray(steps, jnp.int32)))
    out = np.array([float(ema_decay(int(s))) for s in steps])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedules_match_optax(warmup):
    total = 12
    # the schedules of dgdm_tpu/train/dynamics.py:52-60, generator.py:55-61
    if warmup:
        j_dyn = optax.warmup_cosine_decay_schedule(
            0.0, LR, warmup, total, end_value=0.01 * LR)
        j_gen = optax.warmup_cosine_decay_schedule(0.0, LR, warmup, total)
    else:
        j_dyn = optax.cosine_decay_schedule(LR, total, alpha=0.01)
        j_gen = optax.cosine_decay_schedule(LR, total)
    dyn = DynamicsTrainer(ProfileForward2D(width=32, num_trunk=2),
                          learning_rate=LR, total_steps=total,
                          warmup_steps=warmup, device="cpu")
    gen = GeneratorTrainer(ConditionalUnet1D(down_dims=(16, 32)),
                           learning_rate=LR, total_steps=total,
                           warmup_steps=warmup, device="cpu")
    for tr, jfn in ((dyn, j_dyn), (gen, j_gen)):
        for count in range(total + 3):
            ref = float(jfn(jnp.asarray(count, jnp.int32)))
            for got in (tr.lr(count), tr.opt.param_groups[0]["lr"]):
                assert abs(got - ref) <= 1e-6 * abs(ref), (count, got, ref)
            tr.opt.step()          # no gradients: parameters untouched
            tr.lr_sched.step()


def _fixed_draws(n, shape, seed=4):
    rs = np.random.RandomState(seed)
    return [(torch.from_numpy(rs.randint(0, 15, shape[0])).long(),
             torch.from_numpy(rs.randn(*shape).astype(np.float32)))
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["dynamics", "generator"])
def test_checkpoint_resume_is_bitwise(kind, tmp_path):
    if kind == "dynamics":
        batch = _f32(_rows(32))

        def make():
            torch.manual_seed(0)
            return DynamicsTrainer(ProfileForward2D(width=32, num_trunk=2),
                                   learning_rate=LR, total_steps=TOTAL,
                                   weight_decay=1e-3, warmup_steps=1,
                                   device="cpu")
        shape = batch["ctrl"].shape
    else:
        batch = np.random.RandomState(1).uniform(-1, 1, (8, 14, 1)) \
            .astype(np.float32)

        def make():
            torch.manual_seed(0)
            return GeneratorTrainer(ConditionalUnet1D(down_dims=(16, 32)),
                                    learning_rate=LR, total_steps=TOTAL,
                                    warmup_steps=1, device="cpu")
        shape = batch.shape
    draws = _fixed_draws(3, shape)
    whole = make()
    for t, noise in draws:
        whole.step(batch, t, noise)
    first = make()
    for t, noise in draws[:2]:
        first.step(batch, t, noise)
    path = str(tmp_path / "ckpt" / "step_2")
    checkpoints.save(path, first)
    assert sorted(os.listdir(path)) == ["model.npz", "train_state.pt"]
    resumed = checkpoints.restore(path, make())
    assert resumed.step_count == 2
    resumed.step(batch, *draws[2])
    for a, b in ((whole.state_dict(), resumed.state_dict()),):
        assert a["step"] == b["step"] == 3
        for name in ("model", "ema"):
            for k, v in a.get(name, {}).items():
                assert torch.equal(v, b[name][k]), (name, k)
        sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
        for i in sa:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    # model.npz is the inference model: the sample CLI's loader reads it
    mkind = "profile2d" if kind == "dynamics" else "unet"
    loaded = convert.load_model(path, mkind)
    ref = first.inference_model().state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_latest_step_dir_matches_jax(tmp_path):
    root = str(tmp_path / "ckpt")
    assert checkpoints.latest_step_dir(root) is None
    assert jckpt.latest_step_dir(root) is None
    os.makedirs(root)
    assert checkpoints.latest_step_dir(root) == jckpt.latest_step_dir(root)
    for d in ("best", "step_9", "step_x", "step_10", "last", "step_2"):
        os.makedirs(os.path.join(root, d))
    out = checkpoints.latest_step_dir(root)
    assert out == jckpt.latest_step_dir(root) == os.path.join(root, "step_10")


@pytest.mark.parametrize("kind", ["dynamics", "generator"])
def test_exported_orbax_checkpoint_resumes(kind, tmp_path):
    export = _export_module()
    if kind == "dynamics":
        jtr, jstate, jbatch, _, batch, to_sd = _dyn_pair("2d_decay_warmup")
        draw = _dyn_draw
        shape = batch["ctrl"].shape
        hp = dict(weight_decay=1e-2, warmup_steps=2)
    else:
        jtr, jstate, _, batch = _gen_pair(warmup=2)
        jbatch = jnp.asarray(batch)
        draw = _gen_draw
        shape = batch.shape
        hp = dict(warmup_steps=2)
    keys = [jax.random.PRNGKey(30 + i) for i in range(3)]
    for key in keys[:2]:
        jstate, _ = jtr.train_step(jstate, jbatch, key)
    src, dst = str(tmp_path / "orbax"), str(tmp_path / "torch_ckpt")
    jckpt.save(src, jstate)
    export.export(src, dst, learning_rate=LR, total_steps=TOTAL, **hp)
    if kind == "dynamics":
        ttr = DynamicsTrainer(ProfileForward2D(width=32, num_trunk=2,
                                               object_ch=200),
                              learning_rate=LR, total_steps=TOTAL,
                              device="cpu", **hp)
    else:
        ttr = GeneratorTrainer(ConditionalUnet1D(down_dims=(16, 32)),
                               learning_rate=LR, total_steps=TOTAL,
                               device="cpu", **hp)
    checkpoints.restore(dst, ttr)
    assert ttr.step_count == 2
    if kind == "dynamics":
        _sync_null(jstate, ttr, to_sd)
    t, noise = draw(jtr, keys[2], shape)
    jstate, jm = jtr.train_step(jstate, jbatch, keys[2])
    tm = ttr.step(batch, t, noise)
    assert _rel(tm["loss"], jm["loss"]) < 1e-5
    if kind == "dynamics":
        _assert_dyn_state(jstate, ttr, to_sd, _min_grads(ttr.model), 1)
    else:
        _assert_gen_state(jstate, ttr, _min_grads(ttr.model), 1)
