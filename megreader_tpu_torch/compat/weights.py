"""Carry the JAX package's flax variables into the port's modules.

The flax tree ``{'params': ..., 'batch_stats': ...}`` (nested dicts of
arrays) maps onto a port module's parameters and buffers by name:

* the module path is the same, with the trunk's ``backbone`` named
  ``ResNet_0`` on the flax side (the 2D-CTC net's heads ``class_head``,
  ``height_head``, ``trans_head`` and ``init_head``, the detector's ``fpn``,
  ``prob_head`` and ``thresh_head``, and the attention net's ``trunk``,
  ``mem_proj``, ``embed``, ``gru``, ``attn_*`` and ``out``, keep their names);
* ``Conv2d.weight`` <- ``kernel`` (HWIO -> OIHW), ``Conv2d.bias`` <- ``bias``;
* ``Linear.weight`` <- ``kernel`` ((in, out) -> (out, in)), ``bias`` as is
  where the layer has one;
* ``Embedding.weight`` <- ``embedding``, as it is;
* ``BatchNorm2d`` ``weight``/``bias`` <- ``scale``/``bias`` in params,
  ``running_mean``/``running_var`` <- ``mean``/``var`` in batch_stats;
* LSTM and GRU cell ``w_ih``/``w_hh``/``b_ih``/``b_hh`` as they are;
* ``LayerNorm`` ``weight``/``bias`` <- ``scale``/``bias``; the attention's
  ``DenseGeneral`` ``kernel``/``bias`` (query, key, value (D, heads,
  head_dim), out (heads, head_dim, D)) as they are; the transformer
  encoder's ``pos_embed`` as it is;
* the deformable conv's ``kernel`` (K * C, F) as it is (its ``offset_conv``
  is a conv as above);
* the root module's own parameter ``pos2d`` (the attention net's, which flax
  makes inside ``encode``) <- ``params/pos2d``, as it is.

Every port entry must be found and every flax entry used: a missing or
leftover key, or a shape that differs, raises. ``export_flax_variables`` maps
the other way (parameters, buffers or gradients -> a flax tree of numpy
arrays), so tests can compare the two packages tree against tree.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.attention import GRUCellTorchlike
from ..models.deform import DeformableConv
from ..models.sequence import LSTM, DenseGeneral, TransformerEncoder

Path = Tuple[str, ...]


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


#: parameters that the root module holds itself, by name
_ROOT_PARAMS = ("pos2d",)


def _flax_module_path(name: str) -> Path:
    return tuple("ResNet_0" if p == "backbone" else p for p in name.split(".") if p)


#: flax layout -> port layout, and back
_TO_PORT = {"conv": lambda a: a.transpose(3, 2, 0, 1), "linear": lambda a: a.T}
_TO_FLAX = {"conv": lambda a: a.transpose(2, 3, 1, 0), "linear": lambda a: a.T}


def _entries(module: nn.Module):
    """(port name, collection, flax path, layout) for every weight; layout
    is "conv" (HWIO <-> OIHW), "linear" ((in, out) <-> (out, in)) or None."""
    for name, m in module.named_modules():
        path = _flax_module_path(name)
        pre = f"{name}." if name else ""
        if isinstance(m, nn.Conv2d):
            yield pre + "weight", "params", path + ("kernel",), "conv"
            if m.bias is not None:
                yield pre + "bias", "params", path + ("bias",), None
        elif isinstance(m, nn.Linear):
            yield pre + "weight", "params", path + ("kernel",), "linear"
            if m.bias is not None:
                yield pre + "bias", "params", path + ("bias",), None
        elif isinstance(m, nn.Embedding):
            yield pre + "weight", "params", path + ("embedding",), None
        elif isinstance(m, nn.LayerNorm):
            yield pre + "weight", "params", path + ("scale",), None
            yield pre + "bias", "params", path + ("bias",), None
        elif isinstance(m, DenseGeneral):
            yield pre + "kernel", "params", path + ("kernel",), None
            yield pre + "bias", "params", path + ("bias",), None
        elif isinstance(m, DeformableConv):
            yield pre + "kernel", "params", path + ("kernel",), None
        elif isinstance(m, TransformerEncoder):
            yield pre + "pos_embed", "params", path + ("pos_embed",), None
        elif isinstance(m, nn.BatchNorm2d):
            yield pre + "weight", "params", path + ("scale",), None
            yield pre + "bias", "params", path + ("bias",), None
            yield pre + "running_mean", "batch_stats", path + ("mean",), None
            yield pre + "running_var", "batch_stats", path + ("var",), None
        elif isinstance(m, (LSTM, GRUCellTorchlike)):
            for p in ("w_ih", "w_hh", "b_ih", "b_hh"):
                yield pre + p, "params", path + (p,), None
        else:
            for p, _ in m.named_parameters(recurse=False):
                if name or p not in _ROOT_PARAMS:
                    raise TypeError(f"no flax mapping for parameter {p!r} of module {name!r} "
                                    f"({type(m).__name__})")
                yield p, "params", (p,), None


def _named_tensors(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def port_arrays(module: nn.Module, variables: Mapping,
                collections: Optional[Tuple[str, ...]] = None) -> Dict[str, np.ndarray]:
    """flax ``variables`` -> {port name: numpy array in the port's layout}
    for every entry of ``module`` in ``collections`` (default: all). A
    missing or leftover flax entry, or a shape that differs, raises."""
    flat = {
        (col,) + path: arr
        for col in variables
        for path, arr in _flatten(variables[col]).items()
    }
    shapes = {n: tuple(t.shape) for n, t in _named_tensors(module).items()}
    out, used, missing = {}, set(), []
    for name, col, path, layout in _entries(module):
        if collections is not None and col not in collections:
            continue
        key = (col,) + path
        if key not in flat:
            missing.append("/".join(key))
            continue
        arr = flat[key] if layout is None else _TO_PORT[layout](flat[key])
        if tuple(arr.shape) != shapes[name]:
            raise ValueError(
                f"{'/'.join(key)}: flax array of shape {flat[key].shape} "
                f"does not fit {shapes[name]}"
            )
        out[name] = np.array(arr, order="C")
        used.add(key)
    leftover = sorted("/".join(k) for k in flat if k not in used)
    if missing or leftover:
        raise KeyError(f"flax variables do not match the module: missing {missing}, "
                       f"leftover {leftover}")
    return out


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax ``variables`` into ``module`` in place; returns the module."""
    tensors = _named_tensors(module)
    for name, arr in port_arrays(module, variables).items():
        tensors[name].copy_(torch.from_numpy(arr).to(tensors[name].dtype))
    return module


def export_flax_variables(module: nn.Module,
                          tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """The inverse of ``load_flax_variables``: a flax variables tree
    ``{collection: nested dict of numpy arrays}`` in flax layouts.

    ``tensors`` maps port names (as ``named_parameters``/``named_buffers``
    give them) to the tensors to export, e.g. ``{n: p.grad for n, p in
    module.named_parameters()}`` for the gradients; entries that are None are
    left out. Default: the module's own parameters and buffers. The arrays
    are copies. A name the module does not map raises."""
    src = _named_tensors(module) if tensors is None else dict(tensors)
    out: Dict = {}
    known = set()
    for name, col, path, layout in _entries(module):
        known.add(name)
        t = src.get(name)
        if t is None:
            continue
        arr = t.detach().cpu().numpy()
        node = out.setdefault(col, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        # a copy: the numpy view of a CPU tensor would follow later updates
        node[path[-1]] = np.array(arr if layout is None else _TO_FLAX[layout](arr), order="C")
    unknown = sorted(n for n in src if n not in known and not n.endswith("num_batches_tracked"))
    if unknown:
        raise KeyError(f"no flax mapping for {unknown}")
    return out


def seeded_flax_variables(variables: Mapping, seed: int) -> Dict:
    """A copy of a flax variables tree with every leaf redrawn from a numpy
    generator: kernels, LSTM and GRU weights N(0, 1/fan_in), embeddings,
    ``pos2d`` and ``pos_embed`` N(0, 1/D) (D their last axis), biases N(0, 0.05²),
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
        else:  # kernel (..., in, out), w_ih / w_hh (gates x H, in), embedding, pos2d,
            # pos_embed
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else shape[-1]
            if name == "kernel" and len(shape) == 3 and shape[1] * shape[2] == shape[0]:
                fan_in = shape[0]  # the attention's query/key/value (D, heads, head_dim)
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        return a.astype(np.float32)

    def walk(tree: Mapping) -> Dict:
        return {
            k: walk(v) if isinstance(v, Mapping) else draw(str(k), np.shape(v))
            for k, v in tree.items()
        }

    return walk(variables)
