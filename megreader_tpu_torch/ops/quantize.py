"""int8 serving: the JAX package's ``ops/quantize.py`` on torch modules.

``int8_context(net)`` swaps the forward of every layer of ``net`` that
stands for a flax ``nn.Conv`` or ``nn.Dense`` (``precision.Conv2d`` and
``Linear`` built with ``int8=True``, the default) for an int8 version, and
restores them on exit. The JAX package intercepts exactly those two flax
types, so the port's layers whose JAX twins are other modules are built
with ``int8=False`` and stay float: the detector head's ``up1``/``up2``
under ``fused_upsample=True`` (the default), where they are ``_UpConv``s as
in JAX; under ``fused_upsample=False`` they are plain convs, twins of
``nn.Conv``, and run int8. The LSTM and GRU cells, the embedding and the
transformer attention's ``DenseGeneral`` projections are other classes
here too, and stay float.

The int8 layer, as in JAX:

* weights: symmetric per-output-channel scales ``max|w| / 127`` (at least
  1e-8; the division is the multiply by float32 ``1/127`` that XLA makes of
  it in the JAX package's jitted forwards), quantized on every call, so
  checkpoints stay float;
* activations: a dynamic symmetric per-tensor scale, the same rule;
* ``round`` half to even, clipped to +-127, int8;
* int8 x int8 with exact int32 accumulation, then ``acc * (sx * sk)`` in
  float32, ``+ bias`` in float32, cast to the layer's compute dtype (its
  input's dtype where it has none).

The accumulation is ``torch._int_mm`` (cuBLASLt s8 x s8 -> s32 on the card)
on the unfolded input, padded to the shapes it takes. JAX computes it with
``lax.conv_general_dilated`` / ``dot_general`` outside any Pallas kernel, so
it is a library product here too. The unfold runs in a float type that
holds the int8 values exactly (float16 on the card, where ``F.unfold`` takes
no int8).

``skip_names`` keeps the layers of those local names (the last part of the
module path, flax's ``mod.name``) in float: ``{"conv"}`` skips every layer
called ``conv``.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, FrozenSet, Iterator, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import Conv2d, Linear


#: JAX's ``max|w| / 127.0`` as XLA compiles it in the jitted forwards: a
#: multiply by the float32 reciprocal of 127 (exactly representable here, so
#: torch's float32 and float64 scalar arithmetic round alike)
_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def qscale_last(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel scales of a port weight (output channels
    first, flax's last axis), in float32, floored at 1e-8."""
    red = tuple(range(1, w.ndim))
    return torch.clamp(w.float().abs().amax(dim=red) * _INV127, min=1e-8)


def _q(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8)


def qtensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-tensor quantization: (int8 values, float32 scale)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax() * _INV127, min=1e-8)
    return _q(xf, s), s


def qweight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel quantization of a weight: (int8 values, (O,) scales)."""
    sk = qscale_last(w)
    return _q(w.float(), sk.reshape((-1,) + (1,) * (w.ndim - 1))), sk


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K).T int8 -> (M, N) int32, exact: ``torch._int_mm``
    with M padded past 16 and K, N to multiples of 8 by zeros."""
    m, k = a.shape
    n = b.shape[0]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b = F.pad(b, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:m, :n]


def conv_int8_acc(xq: torch.Tensor, wq: torch.Tensor, stride, padding) -> torch.Tensor:
    """The int32 accumulator of an int8 conv: (B, C, H, W) int8 input, (O, C,
    kh, kw) int8 kernel -> (B, O, Ho, Wo) int32 (channels-last in memory)."""
    B, C, H, W = xq.shape
    O, _, kh, kw = wq.shape
    sh, sw = stride
    ph, pw = padding
    Ho = (H + 2 * ph - kh) // sh + 1
    Wo = (W + 2 * pw - kw) // sw + 1
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        cols = xq.permute(0, 2, 3, 1).reshape(B * H * W, C)
    else:
        ft = torch.float16 if xq.is_cuda else torch.float32  # holds +-127 exactly
        cols = F.unfold(xq.to(ft), (kh, kw), padding=(ph, pw), stride=(sh, sw))
        cols = cols.transpose(1, 2).reshape(B * Ho * Wo, C * kh * kw).to(torch.int8)
    acc = int_mm(cols, wq.reshape(O, -1))
    return acc.reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


def _dequant(acc: torch.Tensor, sx: torch.Tensor, sk: torch.Tensor, bias, out_dt,
             channel_dim: int) -> torch.Tensor:
    shape = [1] * acc.ndim
    shape[channel_dim] = -1
    y = acc.float() * (sx * sk).reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    return y.to(out_dt)


def conv_int8(mod: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``Conv2d.forward`` in int8 (groups 1, dilation 1, zero padding)."""
    if mod.groups != 1 or tuple(mod.dilation) != (1, 1) or mod.padding_mode != "zeros":
        raise NotImplementedError("int8 convs take groups 1, dilation 1 and zero padding")
    wq, sk = qweight(mod.weight)
    xq, sx = qtensor(x)
    acc = conv_int8_acc(xq, wq, mod.stride, mod.padding)
    out_dt = mod.compute_dtype if mod.compute_dtype is not None else x.dtype
    return _dequant(acc, sx, sk, mod.bias, out_dt, 1)


def dense_int8(mod: Linear, x: torch.Tensor) -> torch.Tensor:
    """``Linear.forward`` in int8, on the last axis of any input."""
    wq, sk = qweight(mod.weight)
    xq, sx = qtensor(x)
    acc = int_mm(xq.reshape(-1, x.shape[-1]), wq).reshape(*x.shape[:-1], -1)
    out_dt = mod.compute_dtype if mod.compute_dtype is not None else x.dtype
    return _dequant(acc, sx, sk, mod.bias, out_dt, -1)


def int8_layers(net: nn.Module, skip_names: FrozenSet[str] = frozenset()
                ) -> Iterator[Tuple[str, nn.Module]]:
    """(path, layer) of every layer ``int8_context`` swaps."""
    for name, m in net.named_modules():
        if (isinstance(m, (Conv2d, Linear)) and m.int8
                and name.rsplit(".", 1)[-1] not in skip_names):
            yield name, m


@contextlib.contextmanager
def int8_context(net: nn.Module, skip_names: FrozenSet[str] = frozenset()):
    """Within the block, every marked layer of ``net`` runs int8 (see the
    module docstring); the float forwards come back on exit, also on an
    exception. Within an enclosing context on the same net, the layers that
    one swapped stay its own: this one swaps and restores only the rest."""
    swapped = []
    try:
        for _, m in int8_layers(net, skip_names):
            if "forward" in vars(m):
                continue
            fn = conv_int8 if isinstance(m, Conv2d) else dense_int8
            m.forward = functools.partial(fn, m)
            swapped.append(m)
        yield net
    finally:
        for m in swapped:
            del m.forward


def int8_methods(fn: Callable, net: nn.Module,
                 skip_names: FrozenSet[str] = frozenset()) -> Callable:
    """``fn`` run under ``int8_context(net, skip_names)``. torch has no
    global method interception, so the net whose layers swap is named."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with int8_context(net, skip_names):
            return fn(*args, **kwargs)

    return wrapped
