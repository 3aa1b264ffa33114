"""Checkpoint / resume — port of ``dgdm_tpu/train/checkpoints.py``.

A checkpoint is a directory holding two files:

- ``train_state.pt`` (``torch.save``): the trainer's ``state_dict()``
  (parameters and BatchNorm buffers, the EMA copy where there is one, the
  optimizer's and the LR schedule's state, the update count) and the
  inference model's kind and constructor arguments;
- ``model.npz``: the inference weights through ``models/convert.save_npz``
  (the EMA UNet, or the classifier with its running statistics), which
  ``convert.load_model`` reads, so ``cli/sample.py`` loads a training
  CLI's ``ckpt/<name>`` directory as it is.

``save`` writes into a sibling temporary directory and renames it into
place, replacing an older checkpoint of the same name. In a
``torch.distributed`` run every rank calls it with the same path; rank 0
writes (the trainers' state is equal on every rank) and all ranks then meet
at a barrier, so none reads or replaces the directory early. ``restore``
runs on every rank.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch
import torch.distributed as dist

from dgdm_tpu_torch.models import convert
from dgdm_tpu_torch.parallel.distributed import rank

TRAIN_STATE = "train_state.pt"
MODEL_NPZ = "model.npz"


def save(path: str, trainer: Any) -> None:
    if rank() == 0:
        _write(os.path.abspath(path), trainer)
    if dist.is_initialized():
        dist.barrier()


def _write(path: str, trainer: Any) -> None:
    model = trainer.inference_model()
    kind = convert.kind_of(model)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({**trainer.state_dict(), "model_kind": kind,
                "model_config": model.config},
               os.path.join(tmp, TRAIN_STATE))
    convert.save_npz(os.path.join(tmp, MODEL_NPZ), model.state_dict(),
                     model.config)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def restore(path: str, trainer: Any) -> Any:
    """Load ``path``'s training state into ``trainer`` (built with the same
    model configuration) and return it."""
    state = torch.load(os.path.join(os.path.abspath(path), TRAIN_STATE),
                       map_location=trainer.device, weights_only=True)
    trainer.load_state_dict(state)
    return trainer


def latest_step_dir(root: str) -> Optional[str]:
    """Directory layout: <root>/step_<n>. Returns the largest-n path."""
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_"):
            try:
                steps.append((int(d.split("_", 1)[1]), d))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])
