"""Carry the JAX package's flax variables into the port's modules.

The flax tree ``{'params': ..., 'batch_stats': ...}`` (nested dicts of
arrays) maps onto a port module's parameters and buffers by name:

* the module path is the same, with the trunk's ``backbone`` named
  ``ResNet_0`` on the flax side;
* ``Conv2d.weight`` <- ``kernel`` (HWIO -> OIHW), ``Conv2d.bias`` <- ``bias``;
* ``Linear.weight`` <- ``kernel`` ((in, out) -> (out, in)), ``bias`` as is;
* ``BatchNorm2d`` ``weight``/``bias`` <- ``scale``/``bias`` in params,
  ``running_mean``/``running_var`` <- ``mean``/``var`` in batch_stats;
* LSTM ``w_ih``/``w_hh``/``b_ih``/``b_hh`` as they are.

Every port entry must be found and every flax entry used: a missing or
leftover key, or a shape that differs, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.sequence import LSTM

Path = Tuple[str, ...]


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _flax_module_path(name: str) -> Path:
    return tuple("ResNet_0" if p == "backbone" else p for p in name.split(".") if p)


def _entries(module: nn.Module):
    """(port tensor, collection, flax path, numpy transform) for every weight."""
    for name, m in module.named_modules():
        path = _flax_module_path(name)
        if isinstance(m, nn.Conv2d):
            yield m.weight, "params", path + ("kernel",), lambda a: a.transpose(3, 2, 0, 1)
            if m.bias is not None:
                yield m.bias, "params", path + ("bias",), None
        elif isinstance(m, nn.Linear):
            yield m.weight, "params", path + ("kernel",), lambda a: a.T
            yield m.bias, "params", path + ("bias",), None
        elif isinstance(m, nn.BatchNorm2d):
            yield m.weight, "params", path + ("scale",), None
            yield m.bias, "params", path + ("bias",), None
            yield m.running_mean, "batch_stats", path + ("mean",), None
            yield m.running_var, "batch_stats", path + ("var",), None
        elif isinstance(m, LSTM):
            for p in ("w_ih", "w_hh", "b_ih", "b_hh"):
                yield getattr(m, p), "params", path + (p,), None
        elif any(True for _ in m.parameters(recurse=False)):
            raise TypeError(f"no flax mapping for module {name!r} ({type(m).__name__})")


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax ``variables`` into ``module`` in place; returns the module."""
    flat = {
        (col,) + path: arr
        for col in variables
        for path, arr in _flatten(variables[col]).items()
    }
    used = set()
    missing = []
    for tensor, col, path, fn in _entries(module):
        key = (col,) + path
        if key not in flat:
            missing.append("/".join(key))
            continue
        arr = flat[key] if fn is None else fn(flat[key])
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(
                f"{'/'.join(key)}: flax array of shape {flat[key].shape} "
                f"does not fit {tuple(tensor.shape)}"
            )
        tensor.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(tensor.dtype))
        used.add(key)
    leftover = sorted("/".join(k) for k in flat if k not in used)
    if missing or leftover:
        raise KeyError(f"flax variables do not match the module: missing {missing}, "
                       f"leftover {leftover}")
    return module


def seeded_flax_variables(variables: Mapping, seed: int) -> Dict:
    """A copy of a flax variables tree with every leaf redrawn from a numpy
    generator: kernels and LSTM weights N(0, 1/fan_in), biases N(0, 0.05²),
    BN scale 1 + N(0, 0.1²), BN mean N(0, 0.05²), BN var U(0.5, 1.5).

    Random weights that both packages can share, made without a framework's
    own generator (JAX's and torch's differ)."""
    rng = np.random.default_rng(seed)

    def draw(name: str, shape) -> np.ndarray:
        if name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            a = 0.05 * rng.standard_normal(shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "b_ih", "b_hh"):
            a = 0.05 * rng.standard_normal(shape)
        else:  # kernel (..., in, out) or w_ih / w_hh (4H, in)
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else shape[-1]
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        return a.astype(np.float32)

    def walk(tree: Mapping) -> Dict:
        return {
            k: walk(v) if isinstance(v, Mapping) else draw(str(k), np.shape(v))
            for k, v in tree.items()
        }

    return walk(variables)
