"""Multi-process initialization — port of
``dgdm_tpu/parallel/distributed.py``.

One process drives one GPU, PyTorch's idiom: a run over N cards is N
processes, each calling ``maybe_initialize_distributed`` (the training,
datagen and sample CLIs do), after which ``parallel.mesh`` builds its meshes
over the process group. The reference's multi-node story is Lightning DDP
reading ``NODE_RANK`` (``generator/train.py:35``).

Environment contract (as the JAX package reads it):
  DGDM_COORDINATOR   "host:port" of rank 0 (absent -> one process, no-op)
  NODE_RANK          this process's rank (``PROCESS_ID`` is honored too)
  DGDM_NUM_NODES     the number of processes (or ``NUM_NODES``)

Rank r binds to ``cuda:(r % device_count)`` on a GPU host. The backend is
NCCL where CUDA is available and gloo otherwise; ``backend="gloo"`` lets
several ranks share one card (NCCL refuses two ranks on one device; gloo
takes CUDA tensors and stages them through the host).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_INITIALIZED = False


def maybe_initialize_distributed(verbose: bool = True,
                                 backend: Optional[str] = None) -> bool:
    """Initialize the default ``torch.distributed`` process group when a
    multi-process environment is declared; a no-op otherwise, and on repeat
    calls. Returns True when running with more than one process."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return dist.get_world_size() > 1

    coordinator = os.environ.get("DGDM_COORDINATOR")
    num = os.environ.get("DGDM_NUM_NODES") or os.environ.get("NUM_NODES")
    rank = os.environ.get("NODE_RANK") or os.environ.get("PROCESS_ID")
    if coordinator is None and num is None:
        return False
    if coordinator is None or num is None or rank is None:
        raise ValueError(
            "a multi-process run needs DGDM_COORDINATOR, NODE_RANK (or "
            "PROCESS_ID) and DGDM_NUM_NODES (or NUM_NODES); got "
            f"{coordinator!r}, {rank!r}, {num!r}")
    rank, world = int(rank), int(num)
    device = None
    if torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device is not None else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=rank, world_size=world)
    _INITIALIZED = True
    if verbose:
        print(f"[dgdm] torch.distributed: rank {rank}/{world}, backend "
              f"{backend}, device {device or 'cpu'}", flush=True)
    return world > 1


def shutdown() -> None:
    """Destroy the default process group (and the meshes' subgroups)."""
    global _INITIALIZED
    from dgdm_tpu_torch.parallel import mesh

    mesh.clear_groups()
    if dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_local_batch_slice(global_batch: int) -> slice:
    """Rows of a globally-indexed batch owned by this process (contiguous
    block partition, reference DDP-sampler analog)."""
    per = global_batch // world_size()
    lo = per * rank()
    return slice(lo, lo + per)
