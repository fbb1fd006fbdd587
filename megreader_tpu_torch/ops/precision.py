"""bf16 serving and mixed precision with the JAX package's dtype rules.

Two modes, read off the flax modules:

* Serving cast (``cast_floats``): every float parameter and buffer,
  BatchNorm's running statistics included, is rounded to bf16, the inputs are
  cast to bf16, and each op computes in the promoted dtype of its input and
  its weights (flax's ``dtype=None``).
* Mixed precision (a module's ``compute_dtype`` set to bf16): the parameters
  stay float32, and the op casts its input and its parameters to bf16.

flax promotes mixed dtypes where ``F.conv2d`` and ``F.linear`` refuse them:
``op_dtype`` gives an op's compute dtype under both rules, and ``Conv2d`` and
``Linear`` apply it. ``torch.autocast`` is not used: its per-op dtype list is
not flax's.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def op_dtype(x: torch.Tensor, *weights: Optional[torch.Tensor],
             dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The dtype an op computes in: ``dtype`` (the module's compute dtype)
    when it is set, else the promotion of ``x``'s dtype and its weights'."""
    if dtype is not None:
        return dtype
    out = x.dtype
    for w in weights:
        if w is not None:
            out = torch.promote_types(out, w.dtype)
    return out


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or float64 where it is: the JAX package's
    ``astype(float32)`` before the float32 heads, which keeps the float64
    tests' precision."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in ``op_dtype``: input, kernel and bias cast to it.

    ``int8`` marks a layer whose JAX twin is a flax ``nn.Conv``, which int8
    serving quantizes (``ops/quantize.py``); other twins pass False."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, int8: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.int8 = int8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = op_dtype(x, self.weight, self.bias, dtype=self.compute_dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` in ``op_dtype``: input, weight and bias cast to it.

    ``int8`` marks a layer whose JAX twin is a flax ``nn.Dense`` (see
    ``Conv2d``)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, int8: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.int8 = int8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = op_dtype(x, self.weight, self.bias, dtype=self.compute_dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def matmul_t(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """``x @ w.T (+ b)`` in the promoted dtype, as ``jnp`` computes it."""
    dt = op_dtype(x, w, b)
    y = x.to(dt) @ w.to(dt).T
    return y if b is None else y + b.to(dt)


def parse_compute_dtype(name: str) -> Optional[torch.dtype]:
    """The task wrappers' ``compute_dtype`` string -> the nets' compute dtype
    (None: float32, flax's ``dtype=None``)."""
    if name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {name!r}: 'float32' or 'bfloat16'")


def cast_floats(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """A copy of ``module`` with every float parameter and buffer in
    ``dtype`` (the JAX package's ``cast_floats`` of a variables tree); integer
    buffers keep their type. The copy needs no gradient."""
    out = copy.deepcopy(module).to(dtype)
    out.requires_grad_(False)
    return out
