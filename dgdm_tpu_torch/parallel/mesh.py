"""Process meshes and sharding helpers — port of
``dgdm_tpu/parallel/mesh.py``.

One process drives one device (``parallel/distributed.py``), so a mesh is a
factorisation of the process group's ranks, with a ``torch.distributed``
group for each axis:

- axis ``dp``: data parallelism (training batches, datagen pairs,
  verification grippers);
- axis ``sp``: the pose-grid axis of guidance (the workload's analog of
  sequence/context parallelism): each sp rank runs its block of the
  9,000-pose classifier sweep and the gradients are summed over the sp group.

Rank ``i * sp + j`` sits at dp coordinate i and sp coordinate j, as JAX's
``Mesh(devices.reshape(dp, sp))`` places device ``i * sp + j``. Results that
live on the host (datagen and verification outputs) are gathered over gloo
groups even where the device group is NCCL, so that a gather waits for no
kernel queued on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgdm_tpu_torch.parallel.distributed import rank as _rank
from dgdm_tpu_torch.parallel.distributed import world_size

# (backend, ranks) -> group; every rank creates every group in one order
_GROUPS: Dict[Tuple[str, Tuple[int, ...]], object] = {}


def clear_groups() -> None:
    for g in _GROUPS.values():
        if g is not None and g is not dist.group.WORLD:
            dist.destroy_process_group(g)
    _GROUPS.clear()


def _group(ranks: Sequence[int], backend: Optional[str] = None):
    """The process group over ``ranks`` (the default group when it spans
    the world with the default backend), created once per process."""
    ranks = tuple(ranks)
    default = dist.get_backend()
    backend = backend or default
    if backend == default and len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    key = (backend, ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks), backend=backend)
    return _GROUPS[key]


def mesh_shape(n: int, axes: Tuple[str, ...] = ("dp", "sp")
               ) -> Dict[str, int]:
    """JAX's factorisation of n devices: sp takes the first of 2, 4, 8 that
    divides n with n // sp >= sp // 2 (else 1); a flat mesh for one axis."""
    if len(axes) == 1:
        return {axes[0]: n}
    sp = 1
    for cand in (2, 4, 8):
        if n % cand == 0 and n // cand >= cand // 2:
            sp = cand
            break
    return {axes[0]: n // sp, axes[1]: sp}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp[, sp]) factorisation of the process
    group: ``shape`` and ``coords`` by axis name, and per axis the group of
    ranks that differ only in that coordinate (``groups``, device
    collectives) and its gloo twin (``host_groups``, host gathers)."""

    rank: int
    world: int
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    host_groups: Dict[str, object]

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("dp", "sp")) -> Mesh:
    """Factorize the process group into a (dp, sp) mesh (sp gets the smaller
    factor), or a flat mesh when ``axes`` has one name. Collective: every
    rank calls it, in the same order as every other mesh. Without a process
    group it is the one-rank mesh."""
    world = world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans the whole process group: asked for "
                         f"{n} devices in a group of {world}")
    shape = mesh_shape(n, axes)
    r = _rank()
    strides = {axes[0]: shape.get(axes[1], 1) if len(axes) > 1 else 1}
    if len(axes) > 1:
        strides[axes[1]] = 1
    coords = {a: (r // strides[a]) % shape[a] for a in axes}
    groups, host_groups = {}, {}
    if dist.is_initialized():
        host = "gloo"
        for a in axes:
            # one group per value of the other coordinate, all created by
            # every rank in the same order
            others = [b for b in axes if b != a]
            lines = {}
            for q in range(n):
                key = tuple((q // strides[b]) % shape[b] for b in others)
                lines.setdefault(key, []).append(q)
            for members in lines.values():
                g = _group(members)
                hg = _group(members, host)
                if r in members:
                    groups[a], host_groups[a] = g, hg
    return Mesh(r, n, shape, coords, groups, host_groups)


def data_parallel_mesh(min_devices: int = 2) -> Optional[Mesh]:
    """A flat dp mesh over the process group, or None below
    ``min_devices`` ranks (the training CLIs', datagen's and verification's
    data parallelism; the reference's DataParallel / DDP, devices=-1)."""
    if world_size() < min_devices:
        return None
    return make_mesh(axes=("dp",))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree if tree is None else fn(tree)


def leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def block(mesh: Optional[Mesh], n: int, axis: str = "dp") -> slice:
    """This rank's contiguous block of n rows trimmed to a multiple of the
    axis size (all n rows without a mesh)."""
    if mesh is None:
        return slice(0, n)
    k = mesh.size(axis)
    per = n // k
    lo = per * mesh.index(axis)
    return slice(lo, lo + per)


def shard_batch(mesh: Optional[Mesh], batch, axis: str = "dp"):
    """DDP-sampler analog: every rank passes the same GLOBAL batch (a tree
    of arrays or tensors with one leading dimension; same seed -> same
    host-side order, like the reference's Lightning DDP sampler,
    ``generator/train.py:35,152``); rows are trimmed to a multiple of the
    ``axis`` size and each rank keeps its contiguous block."""
    lens = {x.shape[0] for x in leaves(batch)}
    if len(lens) != 1:
        raise ValueError(f"inconsistent leading dims {lens}")
    sl = block(mesh, lens.pop(), axis)
    return _tree_map(lambda x: x[sl], batch)


# one process per device: the global batch and the process-local one are
# the same thing as in JAX's multi-host path
shard_global_batch = shard_batch


def replicate(mesh: Optional[Mesh], module: torch.nn.Module
              ) -> torch.nn.Module:
    """Broadcast a module's parameters and buffers from rank 0 to every
    rank of the mesh (in place); returns the module."""
    if mesh is None or mesh.world == 1:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def all_gather_rows(mesh: Optional[Mesh], x, axis: str = "dp"):
    """Concatenate, in coordinate order, every rank's block along the first
    dimension (equal blocks). ``x``: a numpy array (gathered on the host,
    returned as numpy) or a tensor (returned on its own device; gathered on
    the device over NCCL, else through the host over gloo)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    k = mesh.size(axis)
    if isinstance(x, np.ndarray):
        return all_gather_rows(mesh, torch.from_numpy(
            np.ascontiguousarray(x)), axis).numpy()
    on_device = x.is_cuda and dist.get_backend(mesh.groups[axis]) == "nccl"
    group = mesh.groups[axis] if on_device else mesh.host_groups[axis]
    src = x.contiguous() if on_device else x.detach().cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(k)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def all_reduce_sum(mesh: Optional[Mesh], x: torch.Tensor,
                   axis: str) -> torch.Tensor:
    """Sum ``x`` over the ranks of ``axis`` (JAX's ``psum``; in place on a
    tensor that carries no autograd history). Returns x."""
    if mesh is not None and mesh.size(axis) > 1:
        dist.all_reduce(x, group=mesh.groups[axis])
    return x


def dp_active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size("dp") > 1


def wrap_data_parallel(mesh: Optional[Mesh], model: torch.nn.Module,
                       device: torch.device) -> torch.nn.Module:
    """``model`` wrapped in ``DistributedDataParallel`` over the dp group
    (parameters broadcast from rank 0, gradients averaged over the dp
    ranks: with equal shards, the global batch's mean gradient), or the
    model itself without a mesh over a process group. Its train-mode
    BatchNorms take the global batch's statistics
    (``profile2d.set_sync_group``), so the buffers stay equal without DDP's
    broadcasts."""
    if mesh is None or "dp" not in mesh.groups:
        return model
    from torch.nn.parallel import DistributedDataParallel

    from dgdm_tpu_torch.models.profile2d import set_sync_group

    set_sync_group(model, mesh.groups["dp"])
    ids = None
    if device.type == "cuda":
        ids = [device.index if device.index is not None
               else torch.cuda.current_device()]
    return DistributedDataParallel(
        model, device_ids=ids, process_group=mesh.groups["dp"],
        broadcast_buffers=False)


def global_draw(mesh: Optional[Mesh], rows: int, draw):
    """``draw(global_rows)`` -> tensors with that many leading rows; every
    rank draws the global batch's values from its seed-identical generator
    and keeps its own block, so a dp run sees the one-process draws."""
    k = mesh.size("dp") if dp_active(mesh) else 1
    sl = block(mesh, rows * k)
    return tuple(x[sl] for x in draw(rows * k))


def mean_over_dp(mesh: Optional[Mesh], metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Per-rank means of equal shards -> global-batch means (one
    all-reduce)."""
    if not dp_active(mesh):
        return metrics
    keys = list(metrics)
    v = torch.stack([metrics[k].detach().float() for k in keys])
    all_reduce_sum(mesh, v, "dp")
    v = v / mesh.size("dp")
    return {k: v[i] for i, k in enumerate(keys)}


def pad_to_multiple(batch, k: int):
    """Pad each array's leading dim up to a multiple of k (repeating the last
    row) so it shards evenly; returns (padded_batch, original_length)."""
    lens = {x.shape[0] for x in leaves(batch)}
    if len(lens) != 1:
        raise ValueError(f"inconsistent leading dims {lens}")
    n = lens.pop()
    pad = (-n) % k

    def put(x):
        filler = np.broadcast_to(np.asarray(x[-1:]), (pad,) + tuple(x.shape[1:]))
        return np.concatenate([np.asarray(x), filler], axis=0)

    return (batch if pad == 0 else _tree_map(put, batch)), n
