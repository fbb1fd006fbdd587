"""Deformable convolution v2 and deformable RoI pooling
(``megreader_tpu/models/deform.py``).

``deform_sample``: each of a 3x3 conv's K taps at pixel p reads x at
p + p_k + (dy, dx), the offsets clipped to +-``max_offset``, by bilinear
interpolation with zero outside the page, times the tap's modulation. The
JAX package computes it as shifted multiply-adds over a static window of
(2R + 3)^2 shifts a tap (no gather on the TPU); here it gathers the four
corners of each tap, the same function. Its gradient is the JAX package's
at the kinks too (``_DeformSample``): JAX differentiates its tent weights
``max(0, 1 - |t - s|)`` with ``abs'(0) = 1`` and a ``maximum`` tie split
0.5 / 0.5, so at an integer position the derivative along an axis is
``0.5 x[n+1] - x[n] - 0.5 x[n-1]``, not ``x[n+1] - x[n]``, and ``jnp.clip``
passes half the gradient at exactly +-R. ``offset_conv`` starts at zero, so
every training run starts on those kinks.

``DeformableConv``: offset/modulation conv, the sampling, then one
contraction of the (K * C) sampled taps with ``kernel`` (K * C, F), a raw
parameter in flax's layout. Like the JAX module it takes no dtype: its conv
and contraction promote their operands (float32 under mixed precision), and
the block around it casts back (``resnet.py``). With ``stride`` the output
is the stride-1 result at ``[::s, ::s]``.

``roi_pool_bilinear`` / ``DeformRoIPooling``: per-RoI bin averages of
bilinear samples (each corner outside the map zeroed, RoI sizes floored at
0.1), the second pass displaced by per-bin offsets that a small head
predicts from the first (``trans_fc2`` zero-initialised: the module starts
as RoI align times sigmoid(0) = 0.5). Over a batch: the JAX package's
``nn.vmap`` over pages is a leading batch axis here.

Tensors here are channels-last, as the gathers read whole rows of C; the
modules' callers permute.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.precision import Conv2d, Linear, op_dtype


def _taps(kernel: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    half = kernel // 2
    r = torch.arange(-half, half + 1, device=device)
    return r.repeat_interleave(kernel), r.repeat(kernel)  # (K,) ky, kx, row-major


class _Corners:
    """Rows of a (B*H*W, C) table at integer (y, x) positions of each page,
    zero outside the page."""

    def __init__(self, x: torch.Tensor):
        B, H, W, C = x.shape
        self.table = x.reshape(B * H * W, C)
        self.H, self.W = H, W
        self.base = torch.arange(B, device=x.device) * (H * W)

    def index(self, yy: torch.Tensor, xx: torch.Tensor):
        """(B, ...) positions -> their flat rows (clamped) and whether each
        lies on its page."""
        inside = (yy >= 0) & (yy < self.H) & (xx >= 0) & (xx < self.W)
        base = self.base.view(-1, *([1] * (yy.dim() - 1)))
        idx = base + yy.clamp(0, self.H - 1) * self.W + xx.clamp(0, self.W - 1)
        return idx, inside

    def read(self, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
        idx, inside = self.index(yy, xx)
        return self.table[idx] * inside.unsqueeze(-1).to(self.table.dtype)


def _positions(x: torch.Tensor, offsets: torch.Tensor, kernel: int, max_offset: int):
    """Clipped tap offsets -> per (B, H, W, K) the integer corner (y0, x0), the
    fractions (fy, fx) and the clip's gradient factors (JAX's
    ``minimum(maximum(o, -R), R)``: 1 inside, 0.5 at exactly +-R, 0 beyond)."""
    B, H, W, _ = x.shape
    R = float(max_offset)
    ky, kx = _taps(kernel, x.device)
    oy, ox = offsets[..., 0::2], offsets[..., 1::2]
    # the tap's relative position in float, as JAX forms ky + dy, then its
    # integer part added to the pixel's row exactly
    ty = ky.to(oy.dtype) + torch.clamp(oy, -R, R)
    tx = kx.to(ox.dtype) + torch.clamp(ox, -R, R)
    fy0, fx0 = torch.floor(ty), torch.floor(tx)
    rows = torch.arange(H, device=x.device).view(1, H, 1, 1)
    cols = torch.arange(W, device=x.device).view(1, 1, W, 1)
    y0 = rows + fy0.long()
    x0 = cols + fx0.long()

    def clip_grad(o):
        a = o.abs()
        return torch.where(a < R, 1.0, torch.where(a == R, 0.5, 0.0)).to(o.dtype)

    return y0, x0, ty - fy0, tx - fx0, clip_grad(oy), clip_grad(ox)


class _DeformSample(torch.autograd.Function):
    """``deform_sample`` with the JAX package's gradient at the kinks (see the
    module docstring). Computes in at least float32; returns the promoted
    dtype of its inputs."""

    @staticmethod
    def forward(ctx, x, offsets, modulation, kernel, max_offset):
        out_dt = torch.promote_types(torch.promote_types(x.dtype, offsets.dtype),
                                     modulation.dtype)
        wt = torch.promote_types(out_dt, torch.float32)
        xw, ow, mw = x.to(wt).contiguous(), offsets.to(wt), modulation.to(wt)
        y0, x0, fy, fx, _, _ = _positions(xw, ow, kernel, max_offset)
        corners = _Corners(xw)
        raw = None
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                term = corners.read(y0 + dy, x0 + dx) * (wy * wx).unsqueeze(-1)
                raw = term if raw is None else raw + term
        ctx.save_for_backward(xw, ow, mw, raw)
        ctx.kernel, ctx.max_offset, ctx.dtypes = kernel, max_offset, (x.dtype, offsets.dtype,
                                                                      modulation.dtype)
        return (raw * mw.unsqueeze(-1)).to(out_dt)

    @staticmethod
    def backward(ctx, grad_out):
        xw, ow, mw, raw = ctx.saved_tensors
        x_dt, o_dt, m_dt = ctx.dtypes
        g = grad_out.to(raw.dtype)
        grad_mod = (g * raw).sum(-1)
        gm = g * mw.unsqueeze(-1)  # d loss / d raw
        y0, x0, fy, fx, cy, cx = _positions(xw, ow, ctx.kernel, ctx.max_offset)
        corners = _Corners(xw)
        B, H, W, C = xw.shape

        grad_x = torch.zeros_like(corners.table)
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                idx, inside = corners.index(y0 + dy, x0 + dx)
                w = (wy * wx * inside.to(wy.dtype)).unsqueeze(-1)
                grad_x.index_add_(0, idx.reshape(-1), (gm * w).reshape(-1, C))

        # d tent(t - s) / dt for s = n-1, n, n+1 (n = floor t): -1 at s = n
        # (abs'(0) = 1), and at an integer t the neighbours' ties of maximum
        # give -0.5 and +0.5; at a fractional t only s = n+1 (+1) is live
        on_y, on_x = fy == 0, fx == 0
        dwy = {-1: torch.where(on_y, -0.5, 0.0), 0: -1.0, 1: torch.where(on_y, 0.5, 1.0)}
        dwx = {-1: torch.where(on_x, -0.5, 0.0), 0: -1.0, 1: torch.where(on_x, 0.5, 1.0)}
        wy_val = {0: 1.0 - fy, 1: fy}
        wx_val = {0: 1.0 - fx, 1: fx}
        d_ty = torch.zeros_like(fy)
        d_tx = torch.zeros_like(fx)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == -1 and dx == -1:
                    continue  # weighs nothing along either axis
                dot = (gm * corners.read(y0 + dy, x0 + dx)).sum(-1)
                if dx >= 0:
                    d_ty = d_ty + dwy[dy] * wx_val[dx] * dot
                if dy >= 0:
                    d_tx = d_tx + wy_val[dy] * dwx[dx] * dot
        grad_off = torch.stack([d_ty * cy, d_tx * cx], -1).reshape(ow.shape)
        return (grad_x.reshape(B, H, W, C).to(x_dt), grad_off.to(o_dt), grad_mod.to(m_dt),
                None, None)


def deform_sample(x: torch.Tensor, offsets: torch.Tensor, modulation: torch.Tensor,
                  kernel: int = 3, max_offset: int = 2) -> torch.Tensor:
    """Sample the K deformed taps.

    x (B, H, W, C); offsets (B, H, W, 2K) as (dy, dx) per tap, row-major
    taps; modulation (B, H, W, K). Returns (B, H, W, K, C) in the promoted
    dtype of the three."""
    return _DeformSample.apply(x, offsets, modulation, kernel, max_offset)


def dcn_offset_saturation(offsets: torch.Tensor, max_offset: int = 2) -> Dict[str, torch.Tensor]:
    """Offset-clip diagnostics: ``frac_clipped`` (the share of offset
    components beyond +-``max_offset``), ``max_abs`` and ``p99_abs`` (linear
    interpolation, as ``jnp.quantile``) of the raw ``offset_conv`` offsets,
    any layout. Order statistics by ``kthvalue`` (``torch.quantile`` refuses
    inputs over 2^24 elements), the position and weights in float32 as
    ``jnp.quantile`` takes them."""
    a = offsets.detach().float().abs().reshape(-1)
    n = a.numel()
    pos = torch.tensor(0.99, dtype=torch.float32) * (n - 1)
    lo = torch.floor(pos)
    high_weight = pos - lo
    lo_i, hi_i = int(lo), min(int(torch.ceil(pos)), n - 1)
    v_lo = torch.kthvalue(a, lo_i + 1).values
    v_hi = torch.kthvalue(a, hi_i + 1).values if hi_i != lo_i else v_lo
    return {
        "frac_clipped": (a > max_offset).float().mean(),
        "max_abs": a.max(),
        "p99_abs": v_lo * (1 - high_weight).to(a.device) + v_hi * high_weight.to(a.device),
    }


class DeformableConv(nn.Module):
    """DCNv2 conv on NCHW tensors: offset/modulation conv (zero-initialised,
    so the block starts as a plain conv), the deformed sampling and one
    contraction with ``kernel`` (K * C, F)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, max_offset: int = 2,
                 stride: Sequence[int] = (1, 1)):
        super().__init__()
        K = kernel * kernel
        self.kernel_size = kernel
        self.max_offset = max_offset
        self.stride = tuple(stride)
        self.offset_conv = Conv2d(in_ch, 3 * K, kernel, 1, kernel // 2, bias=True)
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)
        self.kernel = nn.Parameter(torch.empty(K * in_ch, features))
        std = 1.0 / math.sqrt(K * in_ch) / 0.87962566103423978  # flax's lecun_normal
        nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std, b=2 * std)

    def offsets_and_modulation(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(raw offsets (B, 2K, H, W), modulation (B, K, H, W)) of ``x``."""
        K = self.kernel_size ** 2
        om = self.offset_conv(x)
        return om[:, :2 * K], torch.sigmoid(om[:, 2 * K:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        offsets, modulation = self.offsets_and_modulation(x)
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        sampled = deform_sample(nhwc(x), nhwc(offsets), nhwc(modulation), self.kernel_size,
                                self.max_offset)
        B, H, W, K, C = sampled.shape
        dt = op_dtype(sampled, self.kernel)
        out = sampled.reshape(B, H, W, K * C).to(dt) @ self.kernel.to(dt)
        if self.stride != (1, 1):
            out = out[:, ::self.stride[0], ::self.stride[1]]
        return out.permute(0, 3, 1, 2)


def _bins(out_size) -> Tuple[int, int]:
    return (out_size, out_size) if isinstance(out_size, int) else tuple(out_size)


def roi_pool_bilinear(features: torch.Tensor, rois: torch.Tensor,
                      bin_offsets: Optional[torch.Tensor], out_size=7, sample_ratio: int = 2,
                      spatial_scale: float = 1.0) -> torch.Tensor:
    """RoI average pooling with optional per-bin offsets.

    features (B, H, W, C); rois (B, R, 4) as (x0, y0, x1, y1) in input
    coordinates (times ``spatial_scale`` in the map's); ``out_size`` k or
    (kh, kw); bin_offsets (B, R, kh, kw, 2) as (dy, dx) in RoI units, or
    None. Each bin averages ``sample_ratio``^2 bilinear samples at its
    sub-grid, each corner outside the map zeroed. Returns (B, R, kh, kw, C)."""
    B, H, W, C = features.shape
    R = rois.shape[1]
    kh, kw = _bins(out_size)
    g = sample_ratio
    dt = torch.promote_types(features.dtype, rois.dtype)
    rois = rois.to(dt)
    x0, y0, x1, y1 = (rois[..., i] * spatial_scale for i in range(4))
    rw = torch.clamp(x1 - x0, min=0.1)  # (B, R)
    rh = torch.clamp(y1 - y0, min=0.1)
    bw, bh = rw / kw, rh / kh
    dev = features.device
    grid = torch.meshgrid(*(torch.arange(n, device=dev, dtype=dt) for n in (kh, kw, g, g)),
                          indexing="ij")
    bi, bj, su, sv = grid
    ex = lambda t: t[..., None, None, None, None]  # noqa: E731  (B, R) -> (B, R, 1, 1, 1, 1)
    ys = ex(y0) + (bi + (su + 0.5) / g) * ex(bh)
    xs = ex(x0) + (bj + (sv + 0.5) / g) * ex(bw)
    if bin_offsets is not None:
        bin_offsets = bin_offsets.to(dt)
        ys = ys + (bin_offsets[..., 0] * rh[..., None, None])[..., None, None]
        xs = xs + (bin_offsets[..., 1] * rw[..., None, None])[..., None, None]
    fy = ys.reshape(B, R, kh * kw * g * g, 1)
    fx = xs.reshape(B, R, kh * kw * g * g, 1)
    y0f, x0f = torch.floor(fy), torch.floor(fx)
    dy, dx = fy - y0f, fx - x0f
    yi, xi = y0f[..., 0].long(), x0f[..., 0].long()
    corners = _Corners(features.to(dt).contiguous())

    v = (corners.read(yi, xi) * (1 - dx) * (1 - dy)
         + corners.read(yi, xi + 1) * dx * (1 - dy)
         + corners.read(yi + 1, xi) * (1 - dx) * dy
         + corners.read(yi + 1, xi + 1) * dx * dy)  # (B, R, kh*kw*g*g, C)
    return v.reshape(B, R, kh, kw, g * g, C).mean(4)


class DeformRoIPooling(nn.Module):
    """Modulated deformable RoI pooling: RoI align, a head (``trans_fc1``,
    relu, ``trans_fc2``) on the pooled (kh, kw, C) features (flattened
    channel-last, as flax's ``reshape(R, -1)``) predicting per-bin offsets
    (times ``trans_std``) and a modulation mask, then the deformed pool."""

    def __init__(self, channels: int, out_size=7, sample_ratio: int = 2,
                 spatial_scale: float = 1.0, trans_std: float = 0.1, modulated: bool = True,
                 hidden: int = 256):
        super().__init__()
        self.bins = _bins(out_size)
        kh, kw = self.bins
        self.sample_ratio = sample_ratio
        self.spatial_scale = spatial_scale
        self.trans_std = trans_std
        self.modulated = modulated
        self.trans_fc1 = Linear(kh * kw * channels, hidden)
        self.trans_fc2 = Linear(hidden, kh * kw * (3 if modulated else 2))
        nn.init.zeros_(self.trans_fc2.weight)
        nn.init.zeros_(self.trans_fc2.bias)

    def forward(self, features: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """features (B, H, W, C), rois (B, R, 4) -> (B, R, kh, kw, C)."""
        kh, kw = self.bins
        pool = lambda off: roi_pool_bilinear(  # noqa: E731
            features, rois, off, self.bins, self.sample_ratio, self.spatial_scale)
        base = pool(None)
        B, R = base.shape[:2]
        trans = self.trans_fc2(F.relu(self.trans_fc1(base.reshape(B, R, -1))))
        out = pool(trans[..., :kh * kw * 2].reshape(B, R, kh, kw, 2) * self.trans_std)
        if self.modulated:
            out = out * torch.sigmoid(trans[..., kh * kw * 2:].reshape(B, R, kh, kw, 1))
        return out
