"""ResNet trunks (BasicBlock: ResNet-18/34; Bottleneck: ResNet-50/101),
detection and recognition flavors.

Modules take and return NCHW tensors. Padding follows the JAX package's
explicit torch-style padding, and BatchNorm (``BatchNorm2d`` below) has
flax's semantics in both modes, so weights carried from the flax tree
(``compat.weights``) reproduce its activations and its train-mode updates of
the running statistics.

variant='det': 7x7/s2 stem + 3x3/s2 max pool (pad 1), stage strides
(1, 2, 2, 2); returns (C2, C3, C4, C5) at strides 4/8/16/32.
variant='rec': 3x3/s1 stem + 2x2/s2 max pool, stage strides
(1, (2, 2), (2, 1), (2, 1)), so a 32x100 crop ends at H=2, W=25; returns the
last feature map.
variant='rec2d': the 'rec' stem with stage strides (1, (2, 2), (2, 1), (1, 1)),
keeping height for the 2D-CTC heads: 32x100 -> H=4, W=25; 48x160 -> 6x40.

``dcn_stages`` (1-based) swaps each of those stages' blocks' ``conv2`` for a
``DeformableConv`` (DCNv2, ``deform.py``); in a strided Bottleneck it carries
the block's stride (computed dense, subsampled), as in the JAX package. DB's
deformable ResNet-50 is ``resnet50`` with ``dcn_stages=(2, 3, 4)``.

A Bottleneck (1x1 -> 3x3 -> 1x1, expansion 4, the stride on the 3x3 conv2)
ends each stage at 4x the stage's features, so ``out_channels`` of
``resnet50``/``resnet101`` are (256, 512, 1024, 2048) at width 64.

``dtype`` is the convs' compute dtype (bf16 for mixed precision; None
promotes the input and the kernel, ``ops/precision.py``). BatchNorm computes
in float32 and returns its input's dtype in either case; each block casts
its second BatchNorm's output to the block's compute dtype (the JAX
package's ``_bn(..., dt)``), which matters after a deformable conv: that
conv takes no dtype and returns float32 under mixed precision.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.precision import Conv2d
from .deform import DeformableConv

#: trunk name -> stage sizes (resnet50/101 are Bottleneck trunks)
STAGE_SIZES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
               "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class BatchNorm2d(nn.BatchNorm2d):
    """``flax.linen.BatchNorm`` (epsilon 1e-5, momentum 0.99) as a torch module.

    Eval mode normalizes with the running statistics, as torch does. Train
    mode normalizes with the batch mean and the biased batch variance, and
    moves the running statistics toward those same values:
    ``running = 0.99 * running + 0.01 * batch``. torch's own train mode
    differs twice: its ``momentum`` is the weight of the batch value (so
    flax's 0.99 is torch's 0.01, not torch's default 0.1), and it moves
    ``running_var`` toward the unbiased variance.

    Both modes compute in float32 (float64 for a float64 input) from the
    input, the statistics and the affine as they are stored, and return the
    input's dtype: the JAX package's ``_bn`` (a float32 BatchNorm cast back to
    the surrounding compute dtype) under mixed precision and under the bf16
    serving cast alike.

    With a ``process_group`` of several ranks (``parallel.sync_batch_norm``)
    train mode takes the statistics of the ranks' batches together, as flax
    does over the global batch under SPMD: the sum and the sum of squares
    are all-reduced (their gradients too) and ``var = E[x^2] - E[x]^2``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # torch's batch norm computes a bf16 input in float32 and returns
        # bf16, with float32 (mixed precision) or bf16 (serving cast) affine
        # and statistics alike
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if self.process_group is not None:
            return self._forward_synced(x)
        with torch.no_grad():
            y = x.to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _forward_synced(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import all_reduce_sum

        y = x.to(torch.promote_types(x.dtype, torch.float32))
        C = y.shape[1]
        count = torch.full((1,), y.numel() // C, dtype=y.dtype, device=y.device)
        sums = all_reduce_sum(torch.cat([y.sum((0, 2, 3)), (y * y).sum((0, 2, 3)), count]),
                              self.process_group)
        mean = sums[:C] / sums[2 * C]
        var = torch.clamp(sums[C:2 * C] / sums[2 * C] - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        shape = (1, C, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(y.dtype)
        out = (y - mean.reshape(shape)) * mul.reshape(shape) + self.bias.to(y.dtype).reshape(shape)
        return out.to(x.dtype)


def _pair(s):
    return s if isinstance(s, tuple) else (s, s)


class BasicBlock(nn.Module):
    """2x(3x3 conv) residual block with a 1x1 projection where the shape changes."""

    def __init__(self, in_ch: int, features: int, stride=(1, 1),
                 dtype: Optional[torch.dtype] = None, use_dcn: bool = False):
        super().__init__()
        stride = _pair(stride)
        self.dtype = dtype
        self.conv1 = Conv2d(in_ch, features, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(features)
        if use_dcn:
            self.conv2 = DeformableConv(features, features)
        else:
            self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm2d(features)
        if in_ch != features or stride != (1, 1):
            self.downsample_conv = Conv2d(in_ch, features, 1, stride, bias=False,
                                          compute_dtype=dtype)
            self.downsample_bn = BatchNorm2d(features)
        else:
            self.downsample_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y)).to(self.dtype or x.dtype)
        r = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + r)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block (ResNet-50/101), expansion 4: the
    stride on conv2, a 1x1 projection where the channels or the stride
    change; ``use_dcn`` makes conv2 a ``DeformableConv`` with the block's
    stride."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride=(1, 1),
                 dtype: Optional[torch.dtype] = None, use_dcn: bool = False):
        super().__init__()
        stride = _pair(stride)
        out_ch = features * self.expansion
        self.dtype = dtype
        self.conv1 = Conv2d(in_ch, features, 1, 1, 0, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(features)
        if use_dcn:
            self.conv2 = DeformableConv(features, features, stride=stride)
        else:
            self.conv2 = Conv2d(features, features, 3, stride, 1, bias=False,
                                compute_dtype=dtype)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = Conv2d(features, out_ch, 1, 1, 0, bias=False, compute_dtype=dtype)
        self.bn3 = BatchNorm2d(out_ch)
        if in_ch != out_ch or stride != (1, 1):
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride, bias=False,
                                          compute_dtype=dtype)
            self.downsample_bn = BatchNorm2d(out_ch)
        else:
            self.downsample_conv = None

    def forward(self, x):
        dt = self.dtype or x.dtype
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)).to(dt))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + r.to(dt))


class ResNet(nn.Module):
    """Configurable BasicBlock or Bottleneck trunk (see the module docstring).

    ``stem_s2d`` and ``stem_s2d4`` are accepted, so that YAML files and
    checkpoints of the JAX package read unchanged, and compute the plain
    stem. In the JAX package they select space-to-depth rewrites of the same
    ``stem_conv`` weight (``megreader_tpu/models/resnet.py``: a 4x4/s1 conv
    over 2x2 phases, and a 3x3/s1 conv over 4x4 phases through the max pool)
    that fill a TPU's matrix unit with the stem's 3 input channels. They
    compute the plain stem's function (the port's tests hold JAX's rewrites
    to this stem within 1e-5), and on an H100 both ran slower than the plain
    stem's cuDNN conv (PERF.md, Findings)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2), variant: str = "det",
                 width: int = 64, in_ch: int = 3, dtype: Optional[torch.dtype] = None,
                 dcn_stages: Sequence[int] = (), block: type = BasicBlock,
                 stem_s2d: bool = False, stem_s2d4: bool = False):
        super().__init__()
        expansion = getattr(block, "expansion", 1)
        if variant == "det":
            self.stem_conv = Conv2d(in_ch, width, 7, 2, 3, bias=False, compute_dtype=dtype)
            self.pool = nn.MaxPool2d(3, 2, 1)
            strides = [(1, 1), (2, 2), (2, 2), (2, 2)]
        elif variant in ("rec", "rec2d"):
            self.stem_conv = Conv2d(in_ch, width, 3, 1, 1, bias=False, compute_dtype=dtype)
            self.pool = nn.MaxPool2d(2, 2)
            last = (2, 1) if variant == "rec" else (1, 1)
            strides = [(1, 1), (2, 2), (2, 1), last]
        else:
            raise ValueError(f"unknown ResNet variant {variant!r}")
        self.stem_bn = BatchNorm2d(width)
        self.variant = variant
        self.stages = []
        ch = width
        for i, (n, stride) in enumerate(zip(stage_sizes, strides)):
            names = []
            for j in range(n):
                name = f"layer{i + 1}_block{j}"
                self.add_module(name, block(ch, width * 2**i, stride if j == 0 else (1, 1),
                                            dtype, use_dcn=(i + 1) in tuple(dcn_stages)))
                ch = width * 2**i * expansion
                names.append(name)
            self.stages.append(names)
        self.out_channels = [width * 2**i * expansion for i in range(len(stage_sizes))]

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """Conv, BatchNorm, relu and max pool: the first block's input."""
        return self.pool(F.relu(self.stem_bn(self.stem_conv(x))))

    def forward(self, x):
        y = self.stem(x)
        feats = []
        for names in self.stages:
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        return tuple(feats) if self.variant == "det" else y


def resnet_variant(name: str, variant: str = "det", width: int = 64,
                   dtype: Optional[torch.dtype] = None, dcn_stages: Sequence[int] = (),
                   stem_s2d: bool = False, stem_s2d4: bool = False) -> ResNet:
    if name not in STAGE_SIZES:
        raise ValueError(f"unknown backbone {name!r}: one of {sorted(STAGE_SIZES)}")
    block = Bottleneck if name in ("resnet50", "resnet101") else BasicBlock
    return ResNet(STAGE_SIZES[name], variant, width, dtype=dtype, dcn_stages=dcn_stages,
                  block=block, stem_s2d=stem_s2d, stem_s2d4=stem_s2d4)

