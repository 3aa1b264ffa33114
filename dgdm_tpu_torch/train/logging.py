"""Pluggable metric sink — port of ``dgdm_tpu/train/logging.py``.

Metrics always stream to a JSONL file (cheap, greppable) and mirror to wandb
when it is importable (offline unless ``WANDB_MODE`` says otherwise). Only
rank 0 of an initialised ``torch.distributed`` process group writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricSink:
    def __init__(self, save_dir: str, project: str = "dgdm_tpu",
                 run_name: Optional[str] = None, use_wandb: bool = True):
        self.path = None
        self._f = None
        self._wandb = None
        if _rank() != 0:
            return
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        if use_wandb:
            try:  # pragma: no cover - wandb not installed in CI
                import wandb

                self._wandb = wandb.init(
                    project=project, dir=save_dir, name=run_name,
                    mode=os.environ.get("WANDB_MODE", "offline"),
                )
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if self._f is None:
            return
        rec = {"ts": time.time(), "step": step}
        rec.update({k: _to_py(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._f is None:
            return
        self._f.close()
        self._f = None
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
