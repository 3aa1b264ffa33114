"""Weights from the seed, made on the device in one random call.

Each floating-point tensor of a model's ``state_dict`` gets the values of
PyTorch's default initialisation law: weights and biases uniform in
+-1/sqrt(fan_in) (fan_in of the layer's weight, as PyTorch counts it), the
affine weights of normalisation layers 1, their biases and running means
0, running variances 1. One ``torch.rand`` call on a ``torch.Generator``
of the device draws every value; the per-tensor bounds and offsets are
spread over it by ``repeat_interleave``. The same seed gives the same
table, and both the program and the reference load it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_NORMS = (torch.nn.BatchNorm1d, torch.nn.GroupNorm, torch.nn.LayerNorm)


def _laws(model: torch.nn.Module):
    """(name, shape, bound, offset) of every floating-point tensor."""
    norm_prefixes = {n for n, m in model.named_modules()
                     if isinstance(m, _NORMS)}
    state = model.state_dict()
    fan_in = {}
    for name, t in state.items():
        if name.endswith(".weight") and t.ndim >= 2:
            fan_in[name[:-len(".weight")]] = t.shape[1] * math.prod(
                t.shape[2:])
    out = []
    for name, t in state.items():
        if not t.is_floating_point():
            continue
        prefix, _, leaf = name.rpartition(".")
        if prefix in norm_prefixes:
            one = leaf in ("weight", "running_var")
            out.append((name, tuple(t.shape), 0.0, 1.0 if one else 0.0))
        else:
            out.append((name, tuple(t.shape),
                        1.0 / math.sqrt(fan_in[prefix]), 0.0))
    return out


def seeded_state(model: torch.nn.Module, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` for every floating-point tensor of
    ``model``'s state, drawn from ``seed``."""
    laws = _laws(model)
    sizes = [math.prod(s) for _, s, _, _ in laws]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    bound = torch.repeat_interleave(
        torch.tensor([b for _, _, b, _ in laws], device=device), counts)
    offset = torch.repeat_interleave(
        torch.tensor([o for _, _, _, o in laws], device=device), counts)
    flat = offset + (2.0 * u - 1.0) * bound
    return {name: chunk.view(shape) for (name, shape, _, _), chunk in
            zip(laws, torch.split(flat, sizes))}


def load(model: torch.nn.Module, state: Dict[str, torch.Tensor]):
    """Copy ``state`` into ``model`` (integer buffers keep their values)."""
    missing = set(model.state_dict()) - set(state)
    floats = {k for k, v in model.state_dict().items()
              if v.is_floating_point()}
    if missing & floats:
        raise KeyError(f"no seeded value for {sorted(missing & floats)}")
    model.load_state_dict(state, strict=False)
    return model
