"""Page and crop resampling: normalize, box crops, perspective and
ruled-surface rectification, three-shear deskew, and train-time augmentation
on the device.

Channels-last (NHWC) at every public function, as in the JAX package. The
resamplers are separable tent-weight contractions (``einsum``/``matmul``):
the tent relu(1 - |s - i|) is the bilinear kernel, with cv2's pixel-centre
convention ``src = (dst + 0.5) * scale - 0.5`` and edge clamping.
``warp_bilinear`` is the one gather resampler (an arbitrary 3x3 map, for
the affine augmentation).

Each random augmentation takes a ``torch.Generator`` and is two steps: a
``*_draws`` function draws its uniforms with that generator on the
images' device, and a pure function applies the drawn values. The JAX
package draws with ``jax.random``, whose streams torch cannot reproduce, so
the arithmetic is held to it on JAX's own draws.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
              scale: float = 1.0 / 255.0) -> torch.Tensor:
    """(x * scale - mean) / std, channels-last."""
    m = torch.tensor(mean, dtype=images.dtype, device=images.device)
    s = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images * scale - m) / s


def _tent(src: torch.Tensor, n_in: int) -> torch.Tensor:
    """(..., n_out) source coordinates (already clamped) -> (..., n_out, n_in)
    bilinear weights."""
    idx = torch.arange(n_in, dtype=src.dtype, device=src.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - idx), min=0.0)


def _axis_resize_weights(src_coord: torch.Tensor, n_in: int,
                         valid_in: torch.Tensor) -> torch.Tensor:
    """(B, n_out) source coordinates -> (B, n_out, n_in) bilinear weights,
    each coordinate clamped to its row's valid input [0, valid_in[b] - 1]
    (a clamped row puts weight 1 on its edge pixel)."""
    hi = torch.clamp(valid_in.to(src_coord.dtype)[:, None] - 1.0, min=0.0)
    s = torch.minimum(torch.clamp(src_coord, min=0.0), hi)
    return _tent(s, n_in)


def resize_with_aspect_pad(images: torch.Tensor, sizes: torch.Tensor,
                           out_hw: Tuple[int, int],
                           jitter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aspect-preserving resize of each image's valid region onto a canvas.

    images (B, H, W, C) canvases whose top-left ``sizes[b] = (h, w)`` region
    holds the pixels; the height fits ``Ho`` exactly, the width follows the
    aspect ratio (``round`` halves to even, as ``jnp.round``; at most ``Wo``)
    and the rest of each row is zero. ``jitter`` = (scale (B, 2), shift
    (B, 2)), axes (y, x): the source coordinates are scaled about the valid
    region's centre and shifted by ``shift`` source pixels (train-time
    geometric augmentation riding the resize's weights). Source coordinates
    are then clamped to the valid region. Returns (out (B, Ho, Wo, C), valid
    widths (B,) int32)."""
    B, Hi, Wi, C = images.shape
    Ho, Wo = out_hw
    dev, dt = images.device, images.dtype
    h = sizes[:, 0].to(dt)
    w = sizes[:, 1].to(dt)
    scale = h / Ho
    out_w = torch.clamp(torch.round(w / scale), max=float(Wo))
    sx = w / torch.clamp(out_w, min=1.0)
    oy = torch.arange(Ho, dtype=dt, device=dev).view(1, Ho)
    ox = torch.arange(Wo, dtype=dt, device=dev).view(1, Wo)
    src_y = (oy + 0.5) * scale.view(B, 1) - 0.5
    src_x = (ox + 0.5) * sx.view(B, 1) - 0.5
    if jitter is not None:
        jscale, jshift = jitter
        cy = ((h - 1.0) / 2.0).view(B, 1)
        cx = ((w - 1.0) / 2.0).view(B, 1)
        src_y = (src_y - cy) * jscale[:, 0:1] + cy + jshift[:, 0:1]
        src_x = (src_x - cx) * jscale[:, 1:2] + cx + jshift[:, 1:2]
    Wy = _axis_resize_weights(src_y, Hi, h)  # (B, Ho, Hi)
    Wx = _axis_resize_weights(src_x, Wi, w)  # (B, Wo, Wi)
    tmp = torch.einsum("boi,biwc->bowc", Wy, images)
    out = torch.einsum("bpw,bowc->bopc", Wx, tmp)
    col = torch.arange(Wo, device=dev).view(1, 1, Wo)
    valid = col < out_w.to(torch.int32).view(B, 1, 1)
    return out * valid[..., None], out_w.to(torch.int32)


def crop_resize_boxes(images: torch.Tensor, boxes: torch.Tensor,
                      out_hw: Tuple[int, int], aspect: str = "stretch") -> torch.Tensor:
    """Axis-aligned crop + bilinear resize of K boxes per page.

    images (B, H, W, C); boxes (B, K, 4) as (x0, y0, x1, y1) pixels;
    returns (B, K, Ho, Wo, C). ``aspect='preserve_h'`` fits the height and
    keeps the aspect ratio, left-aligned with zero padding."""
    B, Hi, Wi, C = images.shape
    Ho, Wo = out_hw
    x0, y0, x1, y1 = boxes.unbind(-1)
    sh = (y1 - y0) / Ho
    if aspect == "stretch":
        sw = (x1 - x0) / Wo
    elif aspect == "preserve_h":
        sw = sh
    else:
        raise ValueError(f"unknown aspect mode {aspect!r}")
    dev, dt = images.device, images.dtype
    oy = torch.arange(Ho, dtype=dt, device=dev)
    ox = torch.arange(Wo, dtype=dt, device=dev)
    src_y = y0[..., None] + (oy + 0.5) * sh[..., None] - 0.5
    src_x = x0[..., None] + (ox + 0.5) * sw[..., None] - 0.5
    Wy = _tent(torch.clamp(src_y, 0.0, Hi - 1.0), Hi)  # (B, K, Ho, Hi)
    Wx = _tent(torch.clamp(src_x, 0.0, Wi - 1.0), Wi)  # (B, K, Wo, Wi)
    tmp = torch.einsum("bkoi,biwc->bkowc", Wy, images)
    out = torch.einsum("bkpw,bkowc->bkopc", Wx, tmp)
    if aspect == "preserve_h":
        out_w = (x1 - x0) / torch.clamp(sw, min=1e-6)
        col = torch.arange(Wo, dtype=dt, device=dev).view(1, 1, 1, Wo, 1)
        out = out * (col < out_w[:, :, None, None, None])
    return out


def _dlt_solve(quads: torch.Tensor, out_h: int, out_w: torch.Tensor) -> torch.Tensor:
    """Homographies (N, 3, 3) mapping output-rect coords -> quad coords.

    quads (N, 4, 2) corners TL, TR, BR, BL; each maps onto the rectangle
    [0, out_w-1] x [0, out_h-1]. Solves the 8-unknown DLT system per quad
    (``solve_ex``: a singular system gives non-finite values, as
    ``jnp.linalg.solve`` does, instead of raising)."""
    N = quads.shape[0]
    z = torch.zeros_like(out_w)
    right = out_w - 1.0
    bottom = torch.full_like(out_w, out_h - 1.0)
    X = torch.stack([z, right, right, z], 1)  # (N, 4)
    Y = torch.stack([z, z, bottom, bottom], 1)
    x, y = quads[..., 0].float(), quads[..., 1].float()
    one, zero = torch.ones_like(X), torch.zeros_like(X)
    row_x = torch.stack([X, Y, one, zero, zero, zero, -x * X, -x * Y], -1)
    row_y = torch.stack([zero, zero, zero, X, Y, one, -y * X, -y * Y], -1)
    A = torch.stack([row_x, row_y], 2).reshape(N, 8, 8)
    b = torch.stack([x, y], 2).reshape(N, 8, 1)
    h, _ = torch.linalg.solve_ex(A, b)
    return torch.cat([h[..., 0], torch.ones_like(h[:, :1, 0])], 1).reshape(N, 3, 3)


def perspective_matrix_from_quad(quad: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., 4, 2) quads -> (..., 3, 3) homographies onto the (Ho, Wo) rect."""
    lead = quad.shape[:-2]
    q = quad.reshape(-1, 4, 2)
    w = torch.full((q.shape[0],), float(out_hw[1]), device=q.device)
    return _dlt_solve(q, out_hw[0], w).reshape(*lead, 3, 3)


def perspective_matrix_from_quad_w(quad: torch.Tensor, out_h: int,
                                   out_w: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) quads and (...) target widths -> (..., 3, 3) homographies
    onto [0, out_w-1] x [0, out_h-1]."""
    lead = quad.shape[:-2]
    q = quad.reshape(-1, 4, 2)
    return _dlt_solve(q, out_h, out_w.reshape(-1).float()).reshape(*lead, 3, 3)


def _perspective_two_pass(crops: torch.Tensor, Hmats: torch.Tensor,
                          out_hw: Tuple[int, int]) -> torch.Tensor:
    """Exact-homography rectification of small crops, as two tent passes.

    crops (K, Hc, Wc, C); Hmats (K, 3, 3) map output (x, y, 1) -> crop
    (u, v); returns (K, Ho, Wo, C). Pass 1 resamples each crop column j at
    row v*(y, j), where x solves u(x, y) = j; pass 2 resamples columns at
    u(x, y). Zero outside the crop (cv2 BORDER_CONSTANT)."""
    K, Hc, Wc, C = crops.shape
    Ho, Wo = out_hw
    dev, dt = crops.device, crops.dtype

    def bc(t):
        return t[:, None, None]

    a, b, c = bc(Hmats[:, 0, 0]), bc(Hmats[:, 0, 1]), bc(Hmats[:, 0, 2])
    d, e, f = bc(Hmats[:, 1, 0]), bc(Hmats[:, 1, 1]), bc(Hmats[:, 1, 2])
    g, h, w1 = bc(Hmats[:, 2, 0]), bc(Hmats[:, 2, 1]), bc(Hmats[:, 2, 2])

    ys = torch.arange(Ho, dtype=dt, device=dev).view(1, Ho, 1)
    js = torch.arange(Wc, dtype=dt, device=dev).view(1, 1, Wc)
    denom = a - js * g
    denom = torch.where(torch.abs(denom) < 1e-6, torch.sign(denom) * 1e-6 + 1e-12, denom)
    x_at = (js * (h * ys + w1) - b * ys - c) / denom  # (K, Ho, Wc)
    wdiv = g * x_at + h * ys + w1
    wdiv = torch.where(torch.abs(wdiv) < 1e-8, 1e-8, wdiv)
    v_star = (d * x_at + e * ys + f) / wdiv
    Wy = _tent(torch.clamp(v_star, 0.0, Hc - 1.0), Hc)  # (K, Ho, Wc, Hc)
    tmp = torch.einsum("kowi,kiwc->kowc", Wy, crops)

    xs = torch.arange(Wo, dtype=dt, device=dev).view(1, 1, Wo)
    yo = torch.arange(Ho, dtype=dt, device=dev).view(1, Ho, 1)
    wdiv2 = g * xs + h * yo + w1
    wdiv2 = torch.where(torch.abs(wdiv2) < 1e-8, 1e-8, wdiv2)
    u = (a * xs + b * yo + c) / wdiv2  # (K, Ho, Wo)
    v_full = (d * xs + e * yo + f) / wdiv2
    Wx = _tent(torch.clamp(u, 0.0, Wc - 1.0), Wc)  # (K, Ho, Wo, Wc)
    out = torch.einsum("koxj,kojc->koxc", Wx, tmp)
    inside = (u >= -0.5) & (u <= Wc - 0.5) & (v_full >= -0.5) & (v_full <= Hc - 0.5)
    return out * inside[..., None]


def _bilinear_two_pass(crops: torch.Tensor, qcs: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
    """Ruled-surface (bilinear patch) rectification of small crops.

    crops (K, Hc, Wc, C); qcs (K, 4, 2) corners TL TR BR BL in crop pixels;
    returns (K, Ho, Wo, C). Output pixel (x, y) samples P(X, Y) = TL (1-X)(1-Y)
    + TR X (1-Y) + BL (1-X) Y + BR X Y at X = x / (Wo - 1), Y = y / (Ho - 1):
    corners to corners and edges linearly, so edge midpoints stay midpoints
    (a homography through a trapezoid's corners sags its spine toward the
    longer edge) and bands that share an edge map it alike. Pass 1 solves
    u(X, Y) = j for X (u is linear in X at fixed Y) and resamples each crop
    column at v(X, Y); pass 2 resamples the columns at u. Zero outside the
    crop."""
    K, Hc, Wc, C = crops.shape
    Ho, Wo = out_hw
    dev, dt = crops.device, crops.dtype
    TL, TR, BR, BL = qcs[:, 0], qcs[:, 1], qcs[:, 2], qcs[:, 3]
    a = torch.stack([TL, TR - TL, BL - TL, TL - TR - BL + BR], 1)  # (K, 4, 2): 1, X, Y, XY
    au = [t[:, None, None] for t in a[..., 0].unbind(1)]
    av = [t[:, None, None] for t in a[..., 1].unbind(1)]

    Y = torch.arange(Ho, dtype=dt, device=dev).view(1, Ho, 1) / max(Ho - 1, 1)
    js = torch.arange(Wc, dtype=dt, device=dev).view(1, 1, Wc)
    denom = au[1] + au[3] * Y  # du/dX at this Y
    denom = torch.where(torch.abs(denom) < 1e-6, torch.sign(denom) * 1e-6 + 1e-12, denom)
    X_at = (js - au[0] - au[2] * Y) / denom  # (K, Ho, Wc)
    v_star = av[0] + av[1] * X_at + av[2] * Y + av[3] * X_at * Y
    Wy = _tent(torch.clamp(v_star, 0.0, Hc - 1.0), Hc)  # (K, Ho, Wc, Hc)
    tmp = torch.einsum("kowi,kiwc->kowc", Wy, crops)

    X = torch.arange(Wo, dtype=dt, device=dev).view(1, 1, Wo) / max(Wo - 1, 1)
    Yo = torch.arange(Ho, dtype=dt, device=dev).view(1, Ho, 1) / max(Ho - 1, 1)
    u = au[0] + au[1] * X + au[2] * Yo + au[3] * X * Yo  # (K, Ho, Wo)
    v_full = av[0] + av[1] * X + av[2] * Yo + av[3] * X * Yo
    Wx = _tent(torch.clamp(u, 0.0, Wc - 1.0), Wc)  # (K, Ho, Wo, Wc)
    out = torch.einsum("koxj,kojc->koxc", Wx, tmp)
    inside = (u >= -0.5) & (u <= Wc - 0.5) & (v_full >= -0.5) & (v_full <= Hc - 0.5)
    return out * inside[..., None]


def rectify_quads_mxu(images: torch.Tensor, quads: torch.Tensor,
                      out_hw: Tuple[int, int], crop_hw: Tuple[int, int] = (48, 160),
                      chunk: int = 32, aspect: str = "stretch",
                      warp: str = "perspective") -> torch.Tensor:
    """Perspective-rectify word quads without gathers.

    images (B, H, W, C); quads (B, K, 4, 2) corners TL TR BR BL in page
    pixels; returns (B, K, Ho, Wo, C). Each quad's bounding box is cropped to
    ``crop_hw`` (``crop_resize_boxes``), the residual homography from the
    output rectangle to crop coordinates is solved per quad, and
    ``_perspective_two_pass`` warps ``chunk`` crops at a time (bounding the
    (chunk, Ho, Wc, Hc) tent tensors). ``aspect='preserve_h'`` sizes each
    quad's output width from its mean edge lengths, left-aligned.

    ``warp='bilinear'`` maps the ruled surface through the same corners
    instead of the homography (``_bilinear_two_pass``): chain mode's band
    quads, whose spine it keeps on the output's midline. It stretches only
    (``aspect='preserve_h'`` raises). The JAX function pads its last chunk
    with unit quads (identity homographies on the perspective path) to keep
    ``lax.map``'s shapes static; here the last chunk is shorter, which gives
    the same crops."""
    if warp not in ("perspective", "bilinear"):
        raise ValueError(f"unknown warp {warp!r}")
    if warp == "bilinear" and aspect == "preserve_h":
        raise ValueError("warp='bilinear' supports aspect='stretch' only")
    if aspect not in ("stretch", "preserve_h"):
        raise ValueError(f"unknown aspect mode {aspect!r}")
    B, K = quads.shape[:2]
    H, W, C = images.shape[1:]
    Hc, Wc = crop_hw
    Ho, Wo = out_hw

    m = 2.0
    x0 = torch.clamp(quads[..., 0].amin(-1) - m, 0, W - 1)
    x1 = torch.clamp(quads[..., 0].amax(-1) + m, 1, W)
    y0 = torch.clamp(quads[..., 1].amin(-1) - m, 0, H - 1)
    y1 = torch.clamp(quads[..., 1].amax(-1) + m, 1, H)
    crops = crop_resize_boxes(images, torch.stack([x0, y0, x1, y1], -1), (Hc, Wc))

    # quad corners in crop pixels (inverse of the crop_resize_boxes map)
    sx = (x1 - x0) / Wc
    sy = (y1 - y0) / Hc
    qc_x = (quads[..., 0] - x0[..., None] + 0.5) / sx[..., None] - 0.5
    qc_y = (quads[..., 1] - y0[..., None] + 0.5) / sy[..., None] - 0.5
    qc = torch.stack([qc_x, qc_y], -1).reshape(B * K, 4, 2)

    flat = crops.reshape(B * K, Hc, Wc, C)
    if warp == "bilinear":
        out = torch.cat([
            _bilinear_two_pass(flat[i:i + chunk], qc[i:i + chunk], out_hw)
            for i in range(0, B * K, chunk)
        ])
        return out.reshape(B, K, Ho, Wo, C)

    if aspect == "preserve_h":
        edge = lambda i, j: torch.linalg.norm(quads[..., i, :] - quads[..., j, :], dim=-1)  # noqa: E731
        qw = 0.5 * (edge(1, 0) + edge(2, 3))
        qh = torch.clamp(0.5 * (edge(3, 0) + edge(2, 1)), min=1.0)
        out_w = torch.clamp(torch.round(qw * Ho / qh), 2.0, float(Wo)).reshape(B * K)
        Hmats = perspective_matrix_from_quad_w(qc, Ho, out_w)
    else:
        Hmats = perspective_matrix_from_quad(qc, out_hw)

    out = torch.cat([
        _perspective_two_pass(flat[i:i + chunk], Hmats[i:i + chunk], out_hw)
        for i in range(0, B * K, chunk)
    ])
    if aspect == "preserve_h":
        col = torch.arange(Wo, dtype=out.dtype, device=out.device).view(1, 1, Wo, 1)
        out = out * (col < out_w[:, None, None, None])
    return out.reshape(B, K, Ho, Wo, C)


def _shear_x(crops: torch.Tensor, shift_per_row: torch.Tensor) -> torch.Tensor:
    """out[k, y, x] = crops[k, y, x + shift_per_row[k, y]] (bilinear, zero
    pad): per-row fractional shifts as tent-weight matmuls.

    crops (K, H, W, C); shift_per_row (K, H)."""
    W = crops.shape[2]
    ox = torch.arange(W, dtype=crops.dtype, device=crops.device)
    src = ox + shift_per_row[:, :, None]  # (K, H, Wo)
    ix = torch.arange(W, dtype=crops.dtype, device=crops.device)
    wmat = torch.relu(1.0 - torch.abs(src[..., None] - ix))  # (K, H, Wo, Wi)
    return torch.einsum("khoi,khic->khoc", wmat, crops)


def _shear_y(crops: torch.Tensor, shift_per_col: torch.Tensor) -> torch.Tensor:
    """out[k, y, x] = crops[k, y + shift_per_col[k, x], x]; shift_per_col (K, W)."""
    H = crops.shape[1]
    oy = torch.arange(H, dtype=crops.dtype, device=crops.device)
    src = oy + shift_per_col[:, :, None]  # (K, W, Ho)
    wmat = torch.relu(1.0 - torch.abs(src[..., None] - oy))  # (K, W, Ho, Hi)
    return torch.einsum("kwoi,kiwc->kowc", wmat, crops)


def rotate_crops(crops: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Deskew each crop: rotate its content by -theta about its centre, so
    that a region whose principal axis lies at +theta comes out level.

    The three-shear rotation R(t) = Sx(-tan t/2) Sy(sin t) Sx(-tan t/2), each
    shear a 1-D bilinear resample per row or column (``_shear_x``,
    ``_shear_y``). The output samples the input with R(+theta): walking the
    output's x axis follows the region's direction (cos t, sin t); -theta
    would rotate the text further.

    crops (K, H, W, C); theta (K,) radians."""
    K, H, W, _ = crops.shape
    t_half = torch.tan(theta / 2.0)
    s = torch.sin(theta)
    y_rel = torch.arange(H, dtype=crops.dtype, device=crops.device) - (H - 1) / 2.0
    x_rel = torch.arange(W, dtype=crops.dtype, device=crops.device) - (W - 1) / 2.0
    out = _shear_x(crops, -t_half[:, None] * y_rel)
    out = _shear_y(out, s[:, None] * x_rel)
    return _shear_x(out, -t_half[:, None] * y_rel)


# ---------------------------------------------------------------------------
# Train-time augmentation on the device
# ---------------------------------------------------------------------------


def _bilinear_gather(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     border: str = "zero") -> torch.Tensor:
    """Sample images (B, H, W, C) at float coordinates x, y (each (B, ...),
    image b read at the coordinates of row b). ``border='zero'`` reads 0
    outside the image; ``'clamp'`` repeats its edges."""
    if border not in ("zero", "clamp"):
        raise ValueError(f"unknown border {border!r}")
    B, H, W, C = images.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    bidx = torch.arange(B, device=images.device).view((B,) + (1,) * (x.dim() - 1))

    def at(yi, xi):
        v = images[bidx, torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        if border == "clamp":
            return v
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        return torch.where(inside[..., None], v, torch.zeros((), dtype=v.dtype, device=v.device))

    v00 = at(y0i, x0i)
    v01 = at(y0i, x0i + 1)
    v10 = at(y0i + 1, x0i)
    v11 = at(y0i + 1, x0i + 1)
    top = v00 * (1 - dx) + v01 * dx
    bot = v10 * (1 - dx) + v11 * dx
    return top * (1 - dy) + bot * dy


def warp_bilinear(images: torch.Tensor, matrices: torch.Tensor, out_hw: Tuple[int, int],
                  border: str = "zero") -> torch.Tensor:
    """Batched inverse warp: out[p] = image[M @ p], bilinear.

    images (B, H, W, C); matrices (B, *K, 3, 3) map output (x, y, 1) to
    input coordinates, each of them on its row's image; returns (B, *K, Ho,
    Wo, C). The coordinates are products and sums written out, as in the JAX
    package (no matmul)."""
    Ho, Wo = out_hw
    dev, dt = images.device, images.dtype
    lead = matrices.shape[:-2]
    ys = torch.arange(Ho, dtype=dt, device=dev).view(Ho, 1)
    xs = torch.arange(Wo, dtype=dt, device=dev).view(1, Wo)
    M = matrices.to(dt).reshape(*lead, 9, 1, 1).unbind(-3)
    w = M[6] * xs + M[7] * ys + M[8]
    w = torch.where(torch.abs(w) < 1e-8, torch.full_like(w, 1e-8), w)
    sx = (M[0] * xs + M[1] * ys + M[2]) / w
    sy = (M[3] * xs + M[4] * ys + M[5]) / w
    return _bilinear_gather(images, sx, sy, border=border)


def rectify_quads(images: torch.Tensor, quads: torch.Tensor,
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop and rectify word quads by their homographies, the gather form.

    images (B, H, W, C); quads (B, K, 4, 2) corners (x, y) TL, TR, BR, BL in
    image pixels -> (B, K, Ho, Wo, C): each crop is ``warp_bilinear`` of its
    page by ``perspective_matrix_from_quad`` (zero outside the page). The
    page program uses ``rectify_quads_mxu``; this is the plain warp that
    ``cv2.warpPerspective`` computes."""
    return warp_bilinear(images, perspective_matrix_from_quad(quads, out_hw), out_hw)


def resize_matrix(src_hw: Tuple[int, int], dst_hw: Tuple[int, int],
                  device=None) -> torch.Tensor:
    """3x3 float32 matrix mapping destination pixel coordinates to source
    ones, cv2's pixel-centre convention."""
    sh, sw = src_hw
    dh, dw = dst_hw
    sx = sw / dw
    sy = sh / dh
    return torch.tensor([[sx, 0.0, 0.5 * sx - 0.5], [0.0, sy, 0.5 * sy - 0.5],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def resize_bilinear(images: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_LINEAR-compatible batched resize (B, H, W, C) -> (B, Ho, Wo,
    C): two tent-weight contractions, height then width."""
    B, Hi, Wi, C = images.shape
    Ho, Wo = out_hw
    dev = images.device
    if not images.is_floating_point():
        images = images.to(torch.float32)
    sy, sx = Hi / Ho, Wi / Wo
    oy = torch.arange(Ho, dtype=torch.float32, device=dev).expand(B, Ho)
    ox = torch.arange(Wo, dtype=torch.float32, device=dev).expand(B, Wo)
    Wy = _axis_resize_weights((oy + 0.5) * sy - 0.5, Hi,
                              torch.full((B,), Hi, dtype=torch.int32, device=dev))
    Wx = _axis_resize_weights((ox + 0.5) * sx - 0.5, Wi,
                              torch.full((B,), Wi, dtype=torch.int32, device=dev))
    tmp = torch.einsum("boi,biwc->bowc", Wy.to(images.dtype), images)
    return torch.einsum("bpw,bowc->bopc", Wx.to(images.dtype), tmp)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    """U[lo, hi) float32 of ``shape`` from ``gen`` on ``device``."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def affine_draws(gen: torch.Generator, batch: int, device=None, max_rotate: float = 10.0,
                 max_scale: float = 0.2, max_shift: float = 0.05) -> Dict[str, torch.Tensor]:
    """The draws of ``augment_affine_matrix``: angle (degrees), scale offset
    and the two shifts (fractions of the image), each (B,)."""
    return {"angle": _uniform(gen, (batch,), -max_rotate, max_rotate, device),
            "scale": _uniform(gen, (batch,), -max_scale, max_scale, device),
            "tx": _uniform(gen, (batch,), -max_shift, max_shift, device),
            "ty": _uniform(gen, (batch,), -max_shift, max_shift, device)}


def affine_matrix(draws: Dict[str, torch.Tensor],
                  center_hw: Tuple[float, float] = (16.0, 50.0)) -> torch.Tensor:
    """Inverse affine maps (B, 3, 3): rotate and scale about the centre, then
    shift, from ``affine_draws``' values."""
    ang = draws["angle"] * (math.pi / 180.0)
    sc = 1.0 + draws["scale"]
    cy, cx = center_hw
    a = torch.cos(ang) / sc
    b = torch.sin(ang) / sc
    tx = draws["tx"] * 2 * cx
    ty = draws["ty"] * 2 * cy
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([a, b, cx - a * cx - b * cy + tx], -1),
        torch.stack([-b, a, cy + b * cx - a * cy + ty], -1),
        torch.stack([zero, zero, one], -1),
    ], 1)


def augment_affine_matrix(gen: torch.Generator, batch: int, max_rotate: float = 10.0,
                          max_scale: float = 0.2, max_shift: float = 0.05,
                          center_hw: Tuple[float, float] = (16.0, 50.0),
                          device=None) -> torch.Tensor:
    """Random inverse affine maps (B, 3, 3) about the image centre."""
    return affine_matrix(affine_draws(gen, batch, device, max_rotate, max_scale, max_shift),
                         center_hw)


def resize_draws(gen: torch.Generator, batch: int, device=None, max_scale_jitter: float = 0.12,
                 max_shift: float = 1.5, brightness: float = 0.15,
                 contrast: float = 0.15) -> Dict[str, torch.Tensor]:
    """The draws of ``augment_resize_with_aspect_pad``: jitter scale and
    shift (B, 2), brightness in 0-255 units and contrast factor (B, 1, 1, 1)."""
    return {
        "jscale": 1.0 + _uniform(gen, (batch, 2), -max_scale_jitter, max_scale_jitter, device),
        "jshift": _uniform(gen, (batch, 2), -max_shift, max_shift, device),
        "brightness": _uniform(gen, (batch, 1, 1, 1), -brightness, brightness, device) * 255.0,
        "contrast": 1.0 + _uniform(gen, (batch, 1, 1, 1), -contrast, contrast, device),
    }


def _photometric(out: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor) -> torch.Tensor:
    """Contrast about each image's mean, then brightness."""
    mean = torch.mean(out, dim=(1, 2, 3), keepdim=True)
    return (out - mean) * contrast + mean + brightness


def augment_resize_apply(images: torch.Tensor, sizes: torch.Tensor, out_hw: Tuple[int, int],
                         draws: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``augment_resize_with_aspect_pad`` on drawn values: the jittered
    resize, then brightness and contrast about each image's mean."""
    out, widths = resize_with_aspect_pad(images, sizes, out_hw,
                                         jitter=(draws["jscale"], draws["jshift"]))
    return _photometric(out, draws["brightness"], draws["contrast"]), widths


def augment_resize_with_aspect_pad(gen: torch.Generator, images: torch.Tensor,
                                   sizes: torch.Tensor, out_hw: Tuple[int, int],
                                   max_scale_jitter: float = 0.12, max_shift: float = 1.5,
                                   brightness: float = 0.15, contrast: float = 0.15,
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recognition ingest with augmentation: geometric jitter on the resize's
    weights (no extra pass), photometric jitter after."""
    draws = resize_draws(gen, images.shape[0], images.device, max_scale_jitter, max_shift,
                         brightness, contrast)
    return augment_resize_apply(images, sizes, out_hw, draws)


def images_draws(gen: torch.Generator, batch: int, device=None, brightness: float = 0.2,
                 contrast: float = 0.2, max_rotate: float = 8.0) -> Dict[str, torch.Tensor]:
    """The draws of ``augment_images``: ``affine_draws``' four (at
    ``max_rotate``), then brightness and contrast (B, 1, 1, 1)."""
    return {**affine_draws(gen, batch, device, max_rotate=max_rotate),
            "brightness": _uniform(gen, (batch, 1, 1, 1), -brightness, brightness, device),
            "contrast": 1.0 + _uniform(gen, (batch, 1, 1, 1), -contrast, contrast, device)}


def augment_images_apply(images: torch.Tensor, draws: Dict[str, torch.Tensor],
                         out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``augment_images`` on drawn values: the affine warp (zero border) about
    the centre, then brightness and contrast about each image's mean."""
    _, H, W, _ = images.shape
    out_hw = out_hw or (H, W)
    M = affine_matrix(draws, center_hw=(H / 2, W / 2))
    out = warp_bilinear(images, M, out_hw)
    return _photometric(out, draws["brightness"], draws["contrast"])


def augment_images(gen: torch.Generator, images: torch.Tensor,
                   out_hw: Optional[Tuple[int, int]] = None, brightness: float = 0.2,
                   contrast: float = 0.2, max_rotate: float = 8.0) -> torch.Tensor:
    """Geometric and photometric train-time augmentation on the device."""
    draws = images_draws(gen, images.shape[0], images.device, brightness, contrast, max_rotate)
    return augment_images_apply(images, draws, out_hw)
