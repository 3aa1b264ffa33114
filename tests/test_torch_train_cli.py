"""The port's data-to-checkpoint slice through its CLIs on the CPU, shaped
like tests/test_end_to_end_2d.py: cli.datagen (grid 8, 1 position, 2
synthetic icons x 2 grippers, plus a validation icon), cli.train_dynamics
and cli.train_diffusion (2 epochs each, their default widths), then
cli.sample on the checkpoint directories they wrote (--eval_steps 400, grid
8) with no conversion step. Each stage's files exist and its numbers are
finite; --mode validate reads a checkpoint back."""

import json
import os

import numpy as np
import pytest

from dgdm_tpu_torch.cli import datagen, sample, train_diffusion, train_dynamics
from tests import torch_parity  # noqa: F401  (one torch thread)


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _finite(recs, prefix):
    vals = [v for r in recs for k, v in r.items() if k.startswith(prefix)]
    assert vals and np.isfinite(vals).all(), prefix
    return vals


@pytest.fixture(scope="module")
def slice_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    small = ["--grid_size", "8", "--num_pos", "1", "--device", "cpu"]
    out = datagen.main(["--num_objects", "2", "--num_fingers", "2",
                        "--save_dir", str(d / "data")] + small)
    assert out["pairs"] == 4 and out["rollouts"] == 32
    datagen.main(["--object_start", "2", "--num_objects", "1",
                  "--num_fingers", "2", "--save_dir", str(d / "val")] + small)
    return d


def test_datagen_writes_shards(slice_dir):
    assert sorted(os.listdir(slice_dir / "data")) == [
        "0_0.npz", "0_1.npz", "1_0.npz", "1_1.npz"]
    assert sorted(os.listdir(slice_dir / "val")) == ["2_0.npz", "2_1.npz"]
    rec = np.load(slice_dir / "data" / "1_1.npz",
                  allow_pickle=True)["arr_0"].item()
    assert rec["delta_theta"].shape == (8,) and rec["ctrlpts"].shape == (14, 2)
    assert np.isfinite(rec["delta_theta"]).all()


@pytest.fixture(scope="module")
def trained(slice_dir):
    d = slice_dir
    dyn = train_dynamics.main([
        "--data_dir", str(d / "data"), "--test_data_dir", str(d / "val"),
        "--save_dir", str(d / "dyn"), "--num_epochs", "2",
        "--batch_size", "2", "--device", "cpu"])
    diff = train_diffusion.main([
        "--num_fingers", "40", "--batch_size", "4", "--num_epochs", "2",
        "--save_dir", str(d / "diff"), "--device", "cpu"])
    return d, dyn, diff


def test_train_dynamics_cli(trained):
    d, dyn, _ = trained
    assert dyn["steps"] == 4
    assert np.isfinite([dyn["first_loss"], dyn["last_loss"],
                        dyn["best_val_loss"]]).all()
    assert sorted(os.listdir(d / "dyn" / "ckpt")) == ["best", "last"]
    for name in ("best", "last"):
        assert sorted(os.listdir(d / "dyn" / "ckpt" / name)) == [
            "model.npz", "train_state.pt"]
    val = _finite(_metrics(d / "dyn" / "metrics.jsonl"), "val/")
    assert len(val) == 2 * 4      # loss and 3 accuracies, 2 epochs
    vm = train_dynamics.main([
        "--data_dir", str(d / "data"), "--test_data_dir", str(d / "val"),
        "--save_dir", str(d / "dyn_val"), "--mode", "validate",
        "--checkpoint_path", str(d / "dyn" / "ckpt" / "best"),
        "--batch_size", "2", "--device", "cpu"])
    assert set(vm) == {"val/loss", "val/acc_ori", "val/acc_x", "val/acc_y"}
    assert np.isfinite(list(vm.values())).all()


def test_train_diffusion_cli(trained):
    d, _, diff = trained
    assert diff["steps"] == 18
    assert np.isfinite([diff["first_loss"], diff["last_loss"]]).all()
    assert sorted(os.listdir(d / "diff" / "ckpt")) == [
        "best_e0", "best_e1", "last"]
    recs = _metrics(d / "diff" / "metrics.jsonl")
    _finite(recs, "val/")
    assert {"val/loss", "val/noise_pred_loss", "val/denoise_loss",
            "val/accuracy"} <= set(recs[0])


def test_sample_cli_on_trained_checkpoints(trained):
    d = trained[0]
    report = sample.main([
        "--diffusion_checkpoint_path", str(d / "diff" / "ckpt" / "last"),
        "--checkpoint_path", str(d / "dyn" / "ckpt" / "best"),
        "--save_dir", str(d / "guided"), "--batch_size", "2",
        "--grid_size", "8", "--num_pos", "1", "--sub_bs", "8",
        "--objectives", "shift_up", "--num_test_objects", "1",
        "--eval_steps", "400", "--device", "cpu"])
    assert os.path.exists(d / "guided" / "guided_report.json")
    entry = report["shift_up"]
    (obj,) = entry["objects"].values()
    assert 0.0 <= obj["mean_success"] <= 1.0
    for name in os.listdir(d / "guided"):
        if name.endswith(".npy"):
            s = np.load(d / "guided" / name)
            assert s.shape == (2, 14, 1) and np.isfinite(s).all()
