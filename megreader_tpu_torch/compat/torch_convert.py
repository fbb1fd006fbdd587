"""PyTorch ``state_dict`` -> the port's modules, through the flax layout.

A copy of the JAX package's ``compat/torch_convert.py``: a ``state_dict``
whose module names mirror the flax module tree (a ``name_map`` rewrites the
prefixes of one whose names differ) becomes the flax variables tree
``{'params': ..., 'batch_stats': ...}`` of numpy arrays, the tree the JAX
package loads. ``load_torch_state_dict`` loads that tree into a port module
through ``weights.py::load_flax_variables``, which checks every name and
shape.

Conventions:
  conv weight   (O, I, kH, kW) -> kernel (kH, kW, I, O)
  linear weight (O, I)         -> kernel (I, O)
  batchnorm     weight/bias    -> scale/bias (params);
                running_mean/var -> mean/var (batch_stats)
  lstm          weight_ih/hh, bias_ih/hh -> w_ih/w_hh/b_ih/b_hh as they are
                (torch's gate order [i, f, g, o], as the port's LSTM)
  embedding, pos2d             as they are
Any other leaf raises ``KeyError``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch.nn as nn

from .weights import load_flax_variables

_LSTM_LEAVES = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias_ih": "b_ih", "bias_hh": "b_hh",
                "w_ih": "w_ih", "w_hh": "w_hh", "b_ih": "b_ih", "b_hh": "b_hh"}


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _numpy(t: Any) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def convert_state_dict(state_dict: Mapping[str, Any],
                       name_map: Optional[Dict[str, str]] = None) -> Dict[str, Dict]:
    """-> {'params': ..., 'batch_stats': ...}, nested dicts of numpy arrays.

    ``name_map``: prefix rewrites applied to each key first (the first
    prefix that matches)."""
    params: Dict = {}
    batch_stats: Dict = {}
    items = {}
    for key, tensor in state_dict.items():
        for old, new in (name_map or {}).items():
            if key.startswith(old):
                key = new + key[len(old):]
                break
        items[key] = _numpy(tensor)
    bn_prefixes = {k[: -len(".running_mean")] for k in items if k.endswith(".running_mean")}

    for key, arr in items.items():
        if key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        prefix, leaf = ".".join(parts[:-1]), parts[-1]
        path = tuple(parts[:-1])
        if prefix in bn_prefixes:
            dest = {"weight": (params, "scale"), "bias": (params, "bias"),
                    "running_mean": (batch_stats, "mean"), "running_var": (batch_stats, "var")}
            if leaf in dest:
                tree, name = dest[leaf]
                _set(tree, path + (name,), arr)
            continue
        if leaf in _LSTM_LEAVES:
            _set(params, path + (_LSTM_LEAVES[leaf],), arr)
        elif leaf == "weight":
            if arr.ndim == 4:
                _set(params, path + ("kernel",), arr.transpose(2, 3, 1, 0))
            elif arr.ndim == 2:
                _set(params, path + ("kernel",), arr.T)
            else:
                _set(params, path + ("scale",), arr)
        elif leaf == "bias":
            _set(params, path + ("bias",), arr)
        elif leaf in ("embedding", "pos2d"):
            _set(params, path + (leaf,), arr)
        else:
            raise KeyError(f"unhandled torch checkpoint key {key!r} (leaf {leaf!r}); add a "
                           "conversion rule or rename it through name_map")
    out = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def torchvision_resnet_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """torchvision ``resnet{18,34,50,101}`` keys -> the trunk's module names
    (conv1/bn1 -> stem_conv/stem_bn, layerI.J -> layerI_blockJ, downsample.0/1
    -> downsample_conv/bn); the classifier ``fc.*`` is dropped."""
    renamed = {}
    for k, v in state_dict.items():
        if k.startswith("fc."):
            continue
        nk = k
        if nk.startswith("conv1."):
            nk = "stem_conv." + nk[len("conv1."):]
        elif nk.startswith("bn1."):
            nk = "stem_bn." + nk[len("bn1."):]
        nk = re.sub(r"^layer(\d+)\.(\d+)\.", r"layer\1_block\2.", nk)
        nk = nk.replace(".downsample.0.", ".downsample_conv.")
        nk = nk.replace(".downsample.1.", ".downsample_bn.")
        renamed[nk] = v
    return renamed


def convert_torchvision_resnet(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """A torchvision ResNet ``state_dict`` -> the flax tree of the 'det'
    trunk (``ResNet(variant='det')``), the ImageNet-pretrained route."""
    return convert_state_dict(torchvision_resnet_keys(state_dict))


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def tree_shapes(tree: Mapping) -> Dict:
    """The tree with each array replaced by its shape."""
    return {k: tree_shapes(v) if isinstance(v, Mapping) else tuple(np.shape(v))
            for k, v in tree.items()}


def assert_tree_compatible(converted: Mapping, reference: Mapping) -> None:
    """Raise ``ValueError`` naming the missing, extra and misshapen entries."""
    c_flat, r_flat = _flatten(converted), _flatten(reference)
    missing = sorted("/".join(k) for k in r_flat.keys() - c_flat.keys())
    extra = sorted("/".join(k) for k in c_flat.keys() - r_flat.keys())
    if missing or extra:
        raise ValueError(f"param tree mismatch.\n  missing: {missing}\n  extra: {extra}")
    for k in c_flat:
        cs, rs = tuple(np.shape(c_flat[k])), tuple(np.shape(r_flat[k]))
        if cs != rs:
            raise ValueError(f"shape mismatch at {'/'.join(k)}: converted {cs} vs model {rs}")


def load_torch_state_dict(module: nn.Module, state_dict: Mapping[str, Any],
                          name_map: Optional[Dict[str, str]] = None) -> nn.Module:
    """Load a ``state_dict`` named as the flax tree into a port ``module`` in
    place (``convert_state_dict``, then ``load_flax_variables``); returns it."""
    return load_flax_variables(module, convert_state_dict(state_dict, name_map))
