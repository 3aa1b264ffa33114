"""Carry weights between the JAX package's flax models and the port's
``nn.Module``s, and keep them as ``.npz`` files.

A flax variable tree arrives as nested dicts of numpy arrays (what
``flax.serialization.to_state_dict`` / ``jax.device_get`` give; this module
imports no JAX). ``unet_state_dict`` / ``profile2d_state_dict`` /
``profile3d_state_dict`` map it to the port's ``state_dict`` names with the
layout changes:

- Dense kernel (in, out) -> Linear weight (out, in);
- Conv kernel (k, in, out) -> Conv1d weight (out, in, k);
- ConvTranspose kernel (k, in, out) -> ConvTranspose1d weight (in, out, k),
  flipped along k (flax's transposed conv does not flip its kernel; torch's
  is the adjoint of a convolution);
- GroupNorm/BatchNorm scale -> weight; BatchNorm batch_stats mean/var ->
  running_mean/running_var.

``flax_unet`` / ``flax_profile2d`` / ``flax_profile3d`` invert the maps.
``save_npz`` writes a state_dict plus the constructor arguments;
``load_model`` rebuilds the module from such a file or from a training
checkpoint directory (``train/checkpoints.py``), which holds one as
``model.npz``. ``params_tree_to_torch`` carries any tree laid out like a
model's params (Adam's moments too) with the same rules.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from dgdm_tpu_torch.models.profile2d import ProfileForward2D
from dgdm_tpu_torch.models.profile3d import ProfileForward3D
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D

_CONFIG_KEY = "__config__"


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/leaf": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# layout transforms of a kernel: flax -> torch, and back
_TO_TORCH: Dict[str, Callable] = {
    "dense": lambda a: a.T,
    "conv": lambda a: a.transpose(2, 1, 0),
    "convT": lambda a: np.flip(a, 0).transpose(1, 2, 0),
}
_TO_FLAX: Dict[str, Callable] = {
    "dense": lambda a: a.T,
    "conv": lambda a: a.transpose(2, 1, 0),
    "convT": lambda a: np.flip(a.transpose(2, 0, 1), 0),
}

# (flax module path, torch module path, layer kind); {i} is a layer index
_UNET_RULES = (
    ("Dense_0", "time_in", "dense"),
    ("Dense_1", "time_out", "dense"),
    ("FiLMResBlock_{0}/Conv1dBlock_{1}/Conv_0",
     "res_blocks.{0}.block{1}.conv", "conv"),
    ("FiLMResBlock_{0}/Conv1dBlock_{1}/GroupNorm_0",
     "res_blocks.{0}.block{1}.norm", "norm"),
    ("FiLMResBlock_{0}/Dense_0", "res_blocks.{0}.film", "dense"),
    ("FiLMResBlock_{0}/Conv_0", "res_blocks.{0}.res_conv", "conv"),
    ("Downsample1d_{0}/Conv_0", "downs.{0}", "conv"),
    ("Upsample1d_{0}/ConvTranspose_0", "ups.{0}", "convT"),
    ("Conv1dBlock_0/Conv_0", "final_block.conv", "conv"),
    ("Conv1dBlock_0/GroupNorm_0", "final_block.norm", "norm"),
    ("Conv_0", "final_conv", "conv"),
)
_PROFILE_RULES = (
    ("gripper_encoder/Dense_{0}", "gripper_encoder.fc{0}", "dense"),
    ("object_encoder/Dense_{0}", "object_encoder.fc{0}", "dense"),
    ("time_in", "time_in", "dense"),
    ("time_out", "time_out", "dense"),
    ("head", "head", "dense"),
    ("trunk_{0}", "trunk_layers.{0}", "dense"),
    ("bn_{0}", "trunk_bns.{0}", "norm"),
)
_PROFILE3D_RULES = (
    ("gripper_encoder/Dense_{0}", "gripper_encoder.fc{0}", "dense"),
    ("object_encoder/sa{0}/mlp_{1}", "object_encoder.sa{0}.mlps.{1}",
     "dense"),
    ("object_encoder/sa{0}/bn_{1}", "object_encoder.sa{0}.bns.{1}", "norm"),
    ("head", "head", "dense"),
    ("trunk_{0}", "trunk_layers.{0}", "dense"),
    ("bn_{0}", "trunk_bns.{0}", "norm"),
)
# (flax collection, flax leaf) <-> torch leaf
_LEAVES = ((("params", "kernel"), "weight"), (("params", "scale"), "weight"),
           (("params", "bias"), "bias"),
           (("batch_stats", "mean"), "running_mean"),
           (("batch_stats", "var"), "running_var"))


def _pattern(tmpl: str) -> "re.Pattern":
    return re.compile(re.escape(tmpl).replace(r"\{0\}", r"(\d+)")
                      .replace(r"\{1\}", r"(\d+)"))


def _match(path: str, rules, src: int):
    for rule in rules:
        m = _pattern(rule[src]).fullmatch(path)
        if m:
            return rule, m.groups()
    raise KeyError(f"no counterpart for {path!r}")


def _to_torch(flat: Dict[str, np.ndarray], collection: str,
              rules) -> Dict[str, np.ndarray]:
    sd = {}
    for key, arr in flat.items():
        mod, leaf = key.rsplit("/", 1)
        (_, t_tmpl, kind), groups = _match(mod, rules, 0)
        tleaf = dict(_LEAVES)[(collection, leaf)]
        if leaf == "kernel":
            arr = _TO_TORCH[kind](arr)
        sd[f"{t_tmpl.format(*groups)}.{tleaf}"] = np.array(
            arr, dtype=np.float32, order="C")
    return sd


def _to_flax(sd: Dict[str, np.ndarray], rules) -> dict:
    flat = {}
    for key, arr in sd.items():
        mod, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        (f_tmpl, _, kind), groups = _match(mod, rules, 1)
        arr = np.asarray(arr)
        if leaf == "weight":
            collection, fleaf = "params", "scale" if kind == "norm" else "kernel"
            if fleaf == "kernel":
                arr = _TO_FLAX[kind](arr)
        else:
            (collection, fleaf), = [k for k, v in _LEAVES if v == leaf]
        flat[f"{collection}/{f_tmpl.format(*groups)}/{fleaf}"] = \
            np.ascontiguousarray(arr)
    return unflatten(flat)


def unet_state_dict(params) -> Dict[str, np.ndarray]:
    """flax ConditionalUnet1D ``params`` tree -> port state_dict (numpy)."""
    return _to_torch(flatten(params), "params", _UNET_RULES)


RULES = {"unet": _UNET_RULES, "profile2d": _PROFILE_RULES,
         "profile3d": _PROFILE3D_RULES}


def params_tree_to_torch(tree, kind: str) -> Dict[str, np.ndarray]:
    """A tree laid out like a ``kind`` model's flax ``params`` (the params,
    or Adam's first or second moments of them) -> port parameter names
    with the same layout changes."""
    return _to_torch(flatten(tree), "params", RULES[kind])


def _variables_to_torch(variables, rules) -> Dict[str, np.ndarray]:
    sd = _to_torch(flatten(variables["params"]), "params", rules)
    sd.update(_to_torch(flatten(variables["batch_stats"]), "batch_stats",
                        rules))
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = np.zeros(
            (), np.int64)
    return sd


def profile2d_state_dict(variables) -> Dict[str, np.ndarray]:
    """flax ProfileForward2D ``{"params", "batch_stats"}`` -> state_dict."""
    return _variables_to_torch(variables, _PROFILE_RULES)


def profile3d_state_dict(variables) -> Dict[str, np.ndarray]:
    """flax ProfileForward3D ``{"params", "batch_stats"}`` -> state_dict
    (the PointNet++ Dense layers act on (B, M, k, C) in flax and on the
    channel axis of the same layout here: the same kernel transform)."""
    return _variables_to_torch(variables, _PROFILE3D_RULES)


def flax_unet(sd: Dict[str, np.ndarray]) -> dict:
    """Port UNet state_dict -> flax ``params`` tree (inverse map)."""
    return _to_flax(sd, _UNET_RULES)["params"]


def flax_profile2d(sd: Dict[str, np.ndarray]) -> dict:
    """Port ProfileForward2D state_dict -> flax ``{"params", "batch_stats"}``."""
    return _to_flax(sd, _PROFILE_RULES)


def flax_profile3d(sd: Dict[str, np.ndarray]) -> dict:
    """Port ProfileForward3D state_dict -> flax ``{"params", "batch_stats"}``."""
    return _to_flax(sd, _PROFILE3D_RULES)


def save_npz(path: str, state_dict, config: dict) -> None:
    """Write a state_dict (tensors or arrays) and the constructor arguments."""
    arrs = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in state_dict.items()}
    arrs[_CONFIG_KEY] = np.asarray(json.dumps(config))
    np.savez(path, **arrs)


def load_npz(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    with np.load(path) as z:
        config = json.loads(str(z[_CONFIG_KEY])) if _CONFIG_KEY in z else {}
        sd = {k: torch.from_numpy(z[k].copy()) for k in z.files
              if k != _CONFIG_KEY}
    return sd, config


MODELS = {"unet": ConditionalUnet1D, "profile2d": ProfileForward2D,
          "profile3d": ProfileForward3D}


def kind_of(model: torch.nn.Module) -> str:
    """The key of ``MODELS`` that built ``model``."""
    kinds = [k for k, cls in MODELS.items() if type(model) is cls]
    if not kinds:
        raise TypeError(f"no model kind for {type(model).__name__}")
    return kinds[0]


def load_model(path: str, kind: str, **defaults) -> torch.nn.Module:
    """Rebuild a ``kind`` module (a key of ``MODELS``) from ``save_npz``
    output, or from a training checkpoint directory (its ``model.npz``);
    constructor arguments stored in the file override ``defaults``."""
    if os.path.isdir(path):
        path = os.path.join(path, "model.npz")
    sd, config = load_npz(path)
    model = MODELS[kind](**{**defaults, **config})
    model.load_state_dict(sd)
    return model.eval()
