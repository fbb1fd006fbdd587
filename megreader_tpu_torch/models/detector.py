"""FPN segmentation text detector (DB-style prob/thresh maps).

ResNet C2-C5 -> top-down FPN -> concatenated /4 feature -> per-pixel map
heads. Internal modules are NCHW; ``SegDetectorNet`` takes NHWC pages and
returns (B, H, W) maps, as the JAX package does.

The map head's tail, [2x upsample -> conv3x3 -> BN -> relu -> 2x upsample ->
conv3x3], runs in one of the JAX ``MapHead``'s formulations, chosen by its
flag ``fused_upsample`` and the mode, each computing its own arithmetic on
the same parameters:

* ``fused_upsample=False``: the plain chain, resize then conv;
* train mode: each [2x bilinear upsample -> zero-padded conv3x3] pair folded
  into one low-resolution conv with per-phase composed kernels and a
  depth-to-space, its outer output row and column recomputed from thin
  strips (``_FusedUpsampleConv``);
* eval mode (the default): the whole tail at (h, w), the upsampled phases
  held as channels, row-phase-major (channel = (ph, pw, c)), and one final
  depth-to-space by 4; its borders built exact by closed-form border
  stencils. These are the JAX head's serving defaults (``packed_serving``,
  ``analytic_borders``); the port has no flag for JAX's other serving tails.

All of them agree within float32 rounding. The composed kernels are the
conv weight, cast to the layer's compute dtype, times a constant table of
the stencils' products (one matmul), made once per weight version where no
gradient is wanted.

``compute_dtype='bfloat16'`` is the JAX package's mixed precision: the trunk,
the FPN and the heads' convs in bf16 on float32 parameters, BatchNorm in
float32, the sigmoids and the loss in float32. Under the bf16 serving cast
(``ops/precision.py::cast_floats``) the same ops promote their bf16 input and
weights.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..ops.losses import balanced_bce_loss, dice_loss, masked_l1_loss
from ..ops.precision import Conv2d, at_least_float32, op_dtype, parse_compute_dtype
from .resnet import BatchNorm2d, resnet_variant


def _resize_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Half-pixel bilinear upscale with edge clamping (the JAX package's tent
    matrices / ``jax.image.resize`` for upscaling)."""
    if x.shape[-2:] == (h, w):
        return x
    if h < x.shape[-2] or w < x.shape[-1]:
        raise NotImplementedError("only upscaling resizes are ported")
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


class FPNNeck(nn.Module):
    """Top-down FPN: laterals to ``dim``, upsample+add, smooth, concat at /4."""

    def __init__(self, in_chs, dim: int = 256, out_dim: int = 256, dtype=None):
        super().__init__()
        for i, c in zip((2, 3, 4, 5), in_chs):
            self.add_module(f"lat{i}", Conv2d(c, dim, 1, compute_dtype=dtype))
        q = out_dim // 4
        for i in (2, 3, 4, 5):
            self.add_module(f"smooth{i}", Conv2d(dim, q, 3, 1, 1, compute_dtype=dtype))

    def forward(self, feats: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        c2, c3, c4, c5 = feats
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + _resize_to(p5, *c4.shape[-2:])
        p3 = self.lat3(c3) + _resize_to(p4, *c3.shape[-2:])
        p2 = self.lat2(c2) + _resize_to(p3, *c2.shape[-2:])
        h, w = c2.shape[-2:]
        outs = [
            _resize_to(getattr(self, f"smooth{i}")(p), h, w)
            for i, p in zip((2, 3, 4, 5), (p2, p3, p4, p5))
        ]
        return torch.cat(outs, 1)  # (B, out_dim, H/4, W/4)


# --- fused [2x bilinear upsample -> 3x3 conv] --------------------------------
#
# With the half-pixel 2x upsample u[2a] = 0.25 x[a-1] + 0.75 x[a],
# u[2a+1] = 0.75 x[a] + 0.25 x[a+1] (clamped at the edges, i.e. replicate
# padding), a following zero-padded 3x3 conv gives z[2i+p] = sum_t A_p[t]
# x[i+t]: one 3x3 conv on the replicate-padded low-resolution input with
# 4*Cout output channels, one per output phase. The outermost output row and
# column see the conv's zero padding on the upsampled grid instead, and are
# recomputed (strips) or composed from border stencils (the packed tail).

#: a[p, d+1, t+1] = weight of x[i+t] inside u[2i+p+d]
_PHASE_TAPS = np.array(
    [
        [[0.75, 0.25, 0.0], [0.25, 0.75, 0.0], [0.0, 0.75, 0.25]],
        [[0.25, 0.75, 0.0], [0.0, 0.75, 0.25], [0.0, 0.25, 0.75]],
    ],
    np.float32,
)

# Border stencils: the weight of input row t inside upsampled sample u[j]
# near the top / bottom (rows index u[-1..2] / u[2H-3..2H]; a zero row is the
# conv's zero padding).
_UP1_TOP = np.array([[0, 0], [1, 0], [0.75, 0.25], [0.25, 0.75]], np.float32)
_UP1_BOT = np.array([[0.75, 0.25], [0.25, 0.75], [0, 1], [0, 0]], np.float32)
# Stage 2 reads a packed input: its borders reach three rows r of the 2x grid
# (rows index u2[-1..4] / u2[4H-5..4H]; taps are the first / last three r-rows)
_UP2_TOP = np.array(
    [[0, 0, 0], [1, 0, 0], [0.75, 0.25, 0], [0.25, 0.75, 0], [0, 0.75, 0.25],
     [0, 0.25, 0.75]],
    np.float32,
)
_UP2_BOT = np.array(
    [[0.75, 0.25, 0], [0.25, 0.75, 0], [0, 0.75, 0.25], [0, 0.25, 0.75], [0, 0, 1],
     [0, 0, 0]],
    np.float32,
)
#: packed (row, phase) slot of r-row t in the 2-row border window
_P2_TOPMAP = ((0, 0), (0, 1), (1, 0))
_P2_BOTMAP = ((0, 1), (1, 0), (1, 1))


def _border_taps(table: np.ndarray, phases: int) -> np.ndarray:
    """BT[p, d, t] = table[p + d, t]: the weight of input row t in the u-grid
    sample that conv tap d of border output phase p reads."""
    return np.stack([table[p:p + 3] for p in range(phases)])


def _interior_dim_scatter() -> np.ndarray:
    """U[d, s, f, r]: the weight of conv tap d inside composed-kernel tap s,
    input phase f, output full-resolution phase r = 2q + p (interior):
    (s, f) = divmod(q + t + 1, 2), weight ``_PHASE_TAPS[p, d, t]``."""
    U = np.zeros((3, 3, 2, 4), np.float32)
    for q in range(2):
        for p in range(2):
            for t in range(3):
                s, f = divmod(q + t + 1, 2)
                U[:, s, f, 2 * q + p] += _PHASE_TAPS[p, :, t]
    return U


def _border_dim_scatter(table: np.ndarray, pmap) -> np.ndarray:
    """V[d, s, f, r]: the same for a border dimension: output phase r's conv
    tap d reads r-row t, packed in slot (s, f) = ``pmap[t]``, with the border
    stencil's weight."""
    b2 = _border_taps(table, 4)
    V = np.zeros((3, 2, 2, 4), np.float32)
    for r in range(4):
        for t in range(3):
            s, f = pmap[t]
            V[:, s, f, r] += b2[r, :, t]
    return V


_U2_INT = _interior_dim_scatter()
_V2_TOP = _border_dim_scatter(_UP2_TOP, _P2_TOPMAP)
_V2_BOT = _border_dim_scatter(_UP2_BOT, _P2_BOTMAP)


def _compose_table(rows: np.ndarray, cols: np.ndarray, spec: str) -> np.ndarray:
    """The product of a row and a column stencil table (``spec``: an
    ``np.einsum`` spec whose output starts with the conv's taps d, e), so
    that composing a conv weight with both is one matmul (``_compose``)."""
    return np.ascontiguousarray(np.einsum(spec, rows, cols), np.float32)


_S1 = "pdh,qew->depqhw"  # stage 1 / the fused conv: out phases (p, q), taps (h, w)
_S2 = "dhfr,ewgs->dersfghw"  # stage 2: out phases (r, s), in phases (f, g), taps (h, w)
_BT, _BB = _border_taps(_UP1_TOP, 2), _border_taps(_UP1_BOT, 2)

#: the stencil and composition tables by name, uploaded once per dtype and device
_CONSTS = {
    "s1_mid": _compose_table(_PHASE_TAPS, _PHASE_TAPS, _S1),
    "s1_top": _compose_table(_BT, _PHASE_TAPS, _S1),
    "s1_bot": _compose_table(_BB, _PHASE_TAPS, _S1),
    "s1_left": _compose_table(_PHASE_TAPS, _BT, _S1),
    "s1_right": _compose_table(_PHASE_TAPS, _BB, _S1),
    "s1_corners": np.stack([_compose_table(r, c, _S1) for r, c in
                            ((_BT, _BT), (_BT, _BB), (_BB, _BT), (_BB, _BB))], 2),
    "s2_mid": _compose_table(_U2_INT, _U2_INT, _S2),
    "s2_top": _compose_table(_V2_TOP, _U2_INT, _S2),
    "s2_bot": _compose_table(_V2_BOT, _U2_INT, _S2),
    "s2_left": _compose_table(_U2_INT, _V2_TOP, _S2),
    "s2_right": _compose_table(_U2_INT, _V2_BOT, _S2),
    "s2_corners": np.stack([_compose_table(r, c, _S2) for r, c in
                            ((_V2_TOP, _V2_TOP), (_V2_TOP, _V2_BOT), (_V2_BOT, _V2_TOP),
                             (_V2_BOT, _V2_BOT))], 2),
}


@functools.lru_cache(maxsize=None)
def _const_on(name: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_CONSTS[name], dtype=dtype, device=device)


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    """A constant in ``like``'s dtype on its device, uploaded once (a copy
    from host memory each call would wait for the card's queue to drain)."""
    return _const_on(name, like.dtype, like.device)


def _pad_edge(x: torch.Tensor) -> torch.Tensor:
    """Edge (replicate) padding by 1 of the last two dimensions."""
    return F.pad(x, (1, 1, 1, 1), mode="replicate")


def _depth_to_space(z: torch.Tensor, r: int) -> torch.Tensor:
    """(B, r*r*C, H, W), channels (ph, pw, c) row-phase-major ->
    (B, C, r*H, r*W)."""
    B, _, H, W = z.shape
    return z.reshape(B, r, r, -1, H, W).permute(0, 3, 4, 1, 5, 2).reshape(B, -1, r * H, r * W)


def _space_to_depth(z: torch.Tensor, r: int) -> torch.Tensor:
    """The inverse of ``_depth_to_space``."""
    B, C, H, W = z.shape
    return z.reshape(B, C, H // r, r, W // r, r).permute(0, 3, 5, 1, 2, 4).reshape(
        B, r * r * C, H // r, W // r)


def _compose(weight: torch.Tensor, name: str) -> torch.Tensor:
    """A conv weight (O, I, 3, 3) composed with the table ``name`` (3, 3,
    *S) in the weight's dtype: (O, I, *S) by one matmul (a three-operand
    ``einsum`` dispatches some 36 ops)."""
    table = _const(name, weight)
    O, I = weight.shape[:2]
    return (weight.reshape(O * I, 9) @ table.reshape(9, -1)).reshape(O, I, *table.shape[2:])


def _phase_kernel(weight: torch.Tensor, side: str = "mid") -> torch.Tensor:
    """Stage 1's composed kernel (4*O, I, th, tw), output channels (p, q, o)
    row-phase-major; ``side`` picks the interior's or a border's stencils."""
    K = _compose(weight, f"s1_{side}")  # (O, I, p, q, th, tw)
    O, I, P, Q, th, tw = K.shape
    return K.permute(2, 3, 0, 1, 4, 5).reshape(P * Q * O, I, th, tw)


def _phase_kernel_grad(dK: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The gradient of ``_phase_kernel(weight)`` (the interior's) with
    respect to the weight, given the composed kernel's gradient dK."""
    table = _const("s1_mid", weight)
    O, I = weight.shape[:2]
    g = dK.reshape(2, 2, O, I, 3, 3).permute(2, 3, 0, 1, 4, 5).reshape(O * I, -1)
    return (g @ table.reshape(9, -1).T).view(O, I, 3, 3)


def _packed2_kernel(weight: torch.Tensor, side: str = "mid") -> torch.Tensor:
    """[2x upsample -> conv3x3] composed on a phase-packed input: weight
    (C2, C1, 3, 3) -> (16*C2, 4*C1, th, tw), reading channels (fh, fw, c1)
    and writing (rh, rw, c2), r the output's phase at 4x."""
    K = _compose(weight, f"s2_{side}")  # (O, I, r, s, f, g, th, tw)
    O, I, R, S, Fh, Fw, th, tw = K.shape
    return K.permute(2, 3, 0, 4, 5, 1, 6, 7).reshape(R * S * O, Fh * Fw * I, th, tw)


def _corner_kernels(weight: torch.Tensor, stage: int) -> torch.Tensor:
    """The four corners' kernels (tl, tr, bl, br), (4, C_out, C_in, 2, 2),
    each over a corner's 2x2 patch of the (packed) input, channels packed as
    the stage reads and writes them."""
    K = _compose(weight, f"s{stage}_corners")
    if stage == 1:  # (O, I, n, p, q, h, w) -> (n, p, q, O, I, h, w)
        K = K.permute(2, 3, 4, 0, 1, 5, 6)
    else:  # (O, I, n, r, s, f, g, h, w) -> (n, r, s, O, f, g, I, h, w)
        K = K.permute(2, 3, 4, 0, 5, 6, 1, 7, 8)
    n_out = (4 if stage == 1 else 16) * weight.shape[0]
    return K.reshape(4, n_out, -1, 2, 2)


def _tiled(bias: Optional[torch.Tensor], n: int):
    return None if bias is None else bias.repeat(n)


def _edge_strip(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x's first and last two rows (``axis`` 2) or columns (3), side by
    side, upsampled 2x: (B, I, 8, 2W) or (B, I, 2H, 8). The strip's own
    clamp gives the image's first two and last two upsampled rows."""
    n = x.shape[axis]
    strip = torch.cat([x.narrow(axis, 0, 2), x.narrow(axis, n - 2, 2)], axis)
    return F.interpolate(strip, size=[2 * d for d in strip.shape[2:]], mode="bilinear",
                         align_corners=False)


#: the strip convs' stride by axis: their two outputs read [0, u0, u1] and
#: [u(2n-2), u(2n-1), 0] of ``_edge_strip``'s 8 upsampled rows (columns)
_STRIP_STRIDE = {2: (7, 1), 3: (1, 7)}


class _FusedUpsampleConv(torch.autograd.Function):
    """[2x bilinear upsample -> zero-padded conv3x3] at low resolution:
    x (B, I, H, W), weight (O, I, 3, 3), bias (O,) or None -> (B, O, 2H,
    2W). The interior is the composed phase conv on the replicate-padded
    input and one depth-to-space; over it the outer two rows, then the
    outer two columns (which settle the corners), each pair by one conv of
    ``_edge_strip``. The backward is written out: autograd through these
    steps dispatches about twice the ops, and a training step of the head
    is bound by the host's dispatch."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        H, W = x.shape[2:]
        # 16-bit convs run channels-last in cuDNN (see ``_packed_kernels``)
        fmt = torch.channels_last if weight.element_size() == 2 else torch.contiguous_format
        K = _phase_kernel(weight).contiguous(memory_format=fmt)
        weight = weight.contiguous(memory_format=fmt)
        xp = _pad_edge(x)
        z = _depth_to_space(F.conv2d(xp, K, _tiled(bias, 4)), 2)
        rows, cols = _edge_strip(x, 2), _edge_strip(x, 3)
        z[:, :, ::2 * H - 1] = F.conv2d(rows, weight, bias, padding=1, stride=_STRIP_STRIDE[2])
        z[..., ::2 * W - 1] = F.conv2d(cols, weight, bias, padding=1, stride=_STRIP_STRIDE[3])
        ctx.save_for_backward(xp, weight, K, rows, cols)
        ctx.has_bias = bias is not None
        return z

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xp, weight, K, rows, cols = ctx.saved_tensors
        x = xp[:, :, 1:-1, 1:-1]
        B, I, H, W = x.shape
        O = weight.shape[0]
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.needs_input_grad[2] and ctx.has_bias]
        # each output came from the last write: the columns, then the rows
        # but the corners, then the interior
        g_cols = g[..., ::2 * W - 1]
        g_rows = g[:, :, ::2 * H - 1].clone()
        g_rows[..., ::2 * W - 1].fill_(0)
        g_mid = g.clone()
        g_mid[:, :, ::2 * H - 1].fill_(0)
        g_mid[..., ::2 * W - 1].fill_(0)
        dxp, dK, db4 = torch.ops.aten.convolution_backward(
            _space_to_depth(g_mid, 2), xp, K, [4 * O] if ctx.has_bias else None,
            [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask)
        dx = torch.ops.aten.replication_pad2d_backward(dxp, x, [1, 1, 1, 1]) if mask[0] else None
        dw = _phase_kernel_grad(dK, weight) if mask[1] else None
        db = db4.view(4, O).sum(0) if mask[2] else None
        for axis, gs, strip in ((2, g_rows, rows), (3, g_cols, cols)):
            ds, dws, dbs = torch.ops.aten.convolution_backward(
                gs, strip, weight, [O] if ctx.has_bias else None, list(_STRIP_STRIDE[axis]),
                [1, 1], [1, 1], False, [0, 0], 1, mask)
            if mask[0]:
                n = x.shape[axis]
                d = torch.ops.aten.upsample_bilinear2d_backward(
                    ds, list(strip.shape[2:]), [B, I, *(k // 2 for k in strip.shape[2:])], False)
                dx.narrow(axis, 0, 2).add_(d.narrow(axis, 0, 2))
                dx.narrow(axis, n - 2, 2).add_(d.narrow(axis, 2, 2))
            if mask[1]:
                dw.add_(dws)
            if mask[2]:
                db.add_(dbs)
        return dx, dw, db


def _packed_kernels(weight: torch.Tensor, bias: Optional[torch.Tensor],
                    stage: int) -> Dict[str, Optional[torch.Tensor]]:
    """A packed stage's kernels: ``mid`` the interior's (3x3 taps) and
    ``borders`` the eight border kernels as 2x3 taps on the strip that
    ``_packed_conv_exact`` lays out, stacked along the output channels: top,
    bottom (2x3), left, right (3x2, transposed), and the tl, tr, bl, br
    corners (2x2, widened by a zero column on the side away from their
    patch); each with its bias tiled to match. In 16-bit floats both are
    channels-last, the layout cuDNN's 16-bit convs run in (an NCHW kernel
    costs a layout transform of input, kernel and output each call)."""
    make = _phase_kernel if stage == 1 else _packed2_kernel
    b = _tiled(bias, 4 if stage == 1 else 16)
    tl, tr, bl, br = _corner_kernels(weight, stage)
    left, right = (make(weight, side).transpose(2, 3) for side in ("left", "right"))
    borders = torch.cat([make(weight, "top"), make(weight, "bot"), left, right,
                         F.pad(tl, (0, 1)), F.pad(tr, (1, 0)), F.pad(bl, (0, 1)),
                         F.pad(br, (1, 0))])
    fmt = torch.channels_last if weight.element_size() == 2 else torch.contiguous_format
    return {"mid": make(weight).contiguous(memory_format=fmt), "bias": b,
            "borders": borders.contiguous(memory_format=fmt), "bias8": _tiled(b, 8)}


def _packed_conv_exact(x: torch.Tensor, k: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """One packed stage with exact borders: the interior by the composed
    kernel on the replicate-padded x (B, C, H, W); over it the outer packed
    rows, columns and corners by their border kernels, which read the outer
    two rows or columns of x (replicate-padded along the other axis: slices
    of the same padded x) and its 2x2 corners.

    The borders take one conv: the top and bottom row pairs (B, C, 4, W+2),
    the left and right column pairs transposed (B, C, 4, H+2) and the four
    corners (B, C, 4, 4) lie side by side in one strip, and a conv of stride
    (2, 1) applies all eight border kernels to all of it; each border keeps
    its own kernel's output over its own pair and place."""
    B, _, H, W = x.shape
    xp = _pad_edge(x)
    z = F.conv2d(xp, k["mid"], k["bias"])
    C = z.shape[1]
    rows = torch.cat([xp[:, :, 1:3], xp[:, :, -3:-1]], 2)
    cols = torch.cat([xp[..., 1:3], xp[..., -3:-1]], 3).transpose(2, 3)
    corners = torch.cat([rows[..., 1:3], rows[..., -3:-1]], 3)
    out = F.conv2d(torch.cat([rows, cols, corners], 3), k["borders"], k["bias8"],
                   stride=(2, 1)).view(B, 8, C, 2, -1)  # (B, kernel, C, pair, place)
    z[:, :, ::H - 1] = out[:, :2, ..., :W].diagonal(0, 1, 3).transpose(2, 3)
    z[..., ::W - 1] = out[:, 2:4, ..., W + 2:W + 2 + H].diagonal(0, 1, 3)
    z[:, :, ::H - 1, ::W - 1] = out[:, 4:, ..., W + H + 4:].view(
        B, 2, 2, C, 2, 2).diagonal(0, 1, 4).diagonal(0, 1, 3)
    return z


class _UpConv(Conv2d):
    """[2x bilinear upsample -> zero-padded conv3x3] with a ``Conv2d``'s
    weight and bias (the JAX ``_UpConv``'s ``kernel``/``bias``). It is not
    an int8 layer: the JAX int8 serving quantizes only flax ``nn.Conv``.

    ``forward(x, mode)``: ``'full'`` the fused formulation (B, O, 2H, 2W);
    ``'packed_exact'`` the packed stage 1 (B, 4*O, H, W) with exact borders;
    ``'packed2_exact'`` stage 2 on a packed (B, 4*I, H, W) input -> (B, O,
    4H, 4W), exact borders; ``'naive'`` the literal resize -> conv.

    The packed modes compose their kernels once per weight version under
    ``torch.no_grad`` or inference mode (serving), else every call."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = True, compute_dtype=None):
        super().__init__(in_ch, out_ch, 3, 1, 1, bias=bias, compute_dtype=compute_dtype,
                         int8=False)
        self._composed = None

    def _packed_kernels(self, stage: int, dt: torch.dtype):
        w, b = self.weight, self.bias
        make = lambda: _packed_kernels(w.to(dt), None if b is None else b.to(dt), stage)  # noqa: E731
        if torch.is_grad_enabled():
            return make()
        key = (stage, dt, w.data_ptr(), w._version,
               None if b is None else (b.data_ptr(), b._version))
        if self._composed is None or self._composed[0] != key:
            # the detached parameters keep their storage, so no later tensor
            # can take the address the key holds while the entry lives
            self._composed = (key, (w.detach(), b if b is None else b.detach()), make())
        return self._composed[2]

    def forward(self, x: torch.Tensor, mode: str = "full") -> torch.Tensor:
        dt = op_dtype(x, self.weight, self.bias, dtype=self.compute_dtype)
        x = x.to(dt)
        if mode in ("packed_exact", "packed2_exact"):
            stage = 1 if mode == "packed_exact" else 2
            z = _packed_conv_exact(x, self._packed_kernels(stage, dt))
            return z if stage == 1 else _depth_to_space(z, 4)
        weight = self.weight.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if mode == "full":
            return _FusedUpsampleConv.apply(x, weight, bias)
        if mode == "naive":
            H, W = x.shape[-2:]
            return F.conv2d(_resize_to(x, 2 * H, 2 * W), weight, bias, padding=1)
        raise ValueError(f"unknown _UpConv mode {mode!r}")


class MapHead(nn.Module):
    """conv3x3 -> BN -> relu -> [2x upsample -> conv3x3 -> BN -> relu] ->
    [2x upsample -> conv3x3] -> sigmoid: a (B, 4h, 4w) float32 map.

    ``fused_upsample`` is the JAX ``MapHead``'s flag, with its default (see
    the module docstring). Under False ``up1``/``up2`` are plain convs,
    which int8 serving quantizes as JAX does their ``nn.Conv`` twins;
    otherwise they are ``_UpConv``s and stay float, and the tail runs fused
    in train mode and packed, with analytic borders, in eval mode: the JAX
    head's defaults (``packed_serving``, ``analytic_borders``), which the
    port fixes. Every formulation calls ``up2`` once on the whole map, and
    its output is the (B, 1, 4h, 4w) pre-sigmoid map."""

    def __init__(self, in_ch: int, dim: int = 64, dtype=None, fused_upsample: bool = True):
        super().__init__()
        self.fused_upsample = fused_upsample
        if fused_upsample:
            up1 = _UpConv(dim, dim // 2, bias=False, compute_dtype=dtype)
            up2 = _UpConv(dim // 2, 1, compute_dtype=dtype)
        else:
            up1 = Conv2d(dim, dim // 2, 3, 1, 1, bias=False, compute_dtype=dtype)
            up2 = Conv2d(dim // 2, 1, 3, 1, 1, compute_dtype=dtype)
        self.conv = Conv2d(in_ch, dim, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn = BatchNorm2d(dim)
        self.up1 = up1
        self.bn1 = BatchNorm2d(dim // 2)
        self.up2 = up2

    def _tail_full(self, y: torch.Tensor) -> torch.Tensor:
        return self.up2(F.relu(self.bn1(self.up1(y))))

    def _packed_bn1(self, v: torch.Tensor) -> torch.Tensor:
        """Eval ``bn1`` on a packed (B, 4*C, h, w) tensor: each phase's C
        channels get the per-channel affine."""
        B, C4, h, w = v.shape
        return self.bn1(v.reshape(B * 4, C4 // 4, h, w)).reshape(B, C4, h, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn(self.conv(x)))
        h, w = y.shape[-2:]
        if not self.fused_upsample:
            y = F.relu(self.bn1(self.up1(_resize_to(y, 2 * h, 2 * w))))
            z = self.up2(_resize_to(y, 4 * h, 4 * w))
        elif self.training:
            # training normalizes the 2x tensor itself, as the plain chain does
            z = self._tail_full(y)
        else:
            v = F.relu(self._packed_bn1(self.up1(y, mode="packed_exact")))
            z = self.up2(v, mode="packed2_exact")
        return torch.sigmoid(at_least_float32(z[:, 0]))


class SegDetectorNet(nn.Module):
    """ResNet trunk + FPN + prob/thresh heads; NHWC pages in, (B, H, W) maps out."""

    def __init__(self, num_backbone: str = "resnet18", fpn_dim: int = 256,
                 head_dim: int = 64, k: float = 50.0, width: int = 64, dtype=None,
                 dcn_stages=(), stem_s2d: bool = False, stem_s2d4: bool = False,
                 fused_upsample: bool = True):
        super().__init__()
        self.backbone = resnet_variant(num_backbone, "det", width, dtype=dtype,
                                       dcn_stages=dcn_stages, stem_s2d=stem_s2d,
                                       stem_s2d4=stem_s2d4)
        self.fpn = FPNNeck(self.backbone.out_channels, fpn_dim, fpn_dim, dtype)
        self.prob_head = MapHead(fpn_dim, head_dim, dtype, fused_upsample)
        self.thresh_head = MapHead(fpn_dim, head_dim, dtype, fused_upsample)
        self.k = k

    def forward(self, images: torch.Tensor,
                heads: Tuple[str, ...] = ("prob", "thresh")) -> Dict[str, torch.Tensor]:
        """``heads=('prob',)`` is the serving call: the thresh head is a
        training auxiliary and is skipped."""
        fused = self.fpn(self.backbone(images.permute(0, 3, 1, 2)))
        out: Dict[str, torch.Tensor] = {}
        if "prob" in heads:
            out["prob"] = self.prob_head(fused)
        if "thresh" in heads:
            out["thresh"] = self.thresh_head(fused)
        if "prob" in heads and "thresh" in heads:
            out["binary"] = torch.sigmoid(self.k * (out["prob"] - out["thresh"]))
        return out


class SegDetector:
    """Task wrapper: the net on ``device``, the DB training loss over the
    prob, binary and thresh maps, and map inference. ``apply``, ``loss`` and
    ``predict_maps`` put the net in train or eval mode themselves.

    ``dcn_stages`` (1-based trunk stages, e.g. (3, 4)) swaps those stages'
    3x3 ``conv2`` for deformable ones (``deform.py``); ``backbone`` is
    ``resnet18``/``resnet34`` (BasicBlock) or ``resnet50``/``resnet101``
    (Bottleneck: DB's deformable ResNet-50 is ``resnet50`` with
    ``dcn_stages=(2, 3, 4)``).

    ``stem_s2d`` / ``stem_s2d4`` are accepted and compute the plain stem,
    the function of the JAX package's space-to-depth rewrites of the same
    ``stem_conv`` weight (``resnet.py::ResNet``). ``fused_upsample`` (JAX's
    default True) selects the map heads' formulation (``MapHead``): the
    packed serving tail in eval mode, the fused tail in train mode, or with
    False the plain resize -> conv chain, whose ``up1``/``up2`` int8 serving
    quantizes."""

    def __init__(self, backbone: str = "resnet18", fpn_dim: int = 256, head_dim: int = 64,
                 k: float = 50.0, bce_scale: float = 5.0, l1_scale: float = 10.0,
                 negative_ratio: float = 3.0, width: int = 64, compute_dtype: str = "float32",
                 fused_upsample: bool = True, dcn_stages=(), stem_s2d: bool = False,
                 stem_s2d4: bool = False, device="cuda"):
        dtype = parse_compute_dtype(compute_dtype)
        self.net = SegDetectorNet(backbone, fpn_dim, head_dim, k, width, dtype,
                                  tuple(dcn_stages), stem_s2d, stem_s2d4,
                                  fused_upsample).to(device).eval()
        self.bce_scale = bce_scale
        self.l1_scale = l1_scale
        self.negative_ratio = negative_ratio

    def apply(self, images: torch.Tensor, train: bool = False,
              heads: Tuple[str, ...] = ("prob", "thresh"), net: nn.Module = None):
        """NHWC normalized pages -> maps; ``train`` runs BatchNorm on batch
        statistics and updates its running statistics. ``net`` overrides the
        wrapper's own module (same architecture)."""
        net = self.net if net is None else net
        return net.train(train)(images, heads=tuple(heads))

    def loss(self, batch: Dict[str, torch.Tensor], train: bool = True):
        """batch: image (B, H, W, 3) normalized; gt (shrunk text), mask (valid
        pixels), thresh_map, thresh_mask, each (B, H, W) -> (bce_scale * bce +
        dice + l1_scale * l1, metrics {loss, bce, dice, thresh_l1} detached)."""
        return self.map_loss(self.apply(batch["image"], train=train), batch)

    def map_loss(self, maps: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        """``loss`` from the net's maps {prob, thresh, binary}."""
        bce = balanced_bce_loss(maps["prob"], batch["gt"], batch["mask"], self.negative_ratio)
        dice = dice_loss(maps["binary"], batch["gt"], batch["mask"])
        l1 = masked_l1_loss(maps["thresh"], batch["thresh_map"], batch["thresh_mask"])
        total = self.bce_scale * bce + dice + self.l1_scale * l1
        metrics = {"loss": total, "bce": bce, "dice": dice, "thresh_l1": l1}
        return total, {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def predict_maps(self, images: torch.Tensor, net: nn.Module = None,
                     heads: Tuple[str, ...] = ("prob", "thresh")) -> Dict[str, torch.Tensor]:
        """Eval-mode maps of NHWC normalized pages."""
        return self.apply(images, train=False, heads=heads, net=net)
