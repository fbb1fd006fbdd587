"""Connected components and region extraction on page masks.

``connected_components`` labels each 4-connected component of a (B, H, W)
mask with its minimum own linear index (background -1). On a CUDA tensor it
launches the hand-written kernel ``csrc/ccl.cu``; on a CPU tensor it runs the
plain version ``connected_components_reference``. Both repeat the same sweep
(every horizontal run of mask pixels takes its minimum, then every vertical
run) until a sweep changes nothing or ``max_iters`` sweeps ran, so their labels
are bit-identical, including the capped state on serpentine masks. With
``multigrid=True`` (the JAX ``_ccl_multigrid_single``) a solve of the
2x2-min-pooled mask seeds the full-resolution one: on the card both are
launches of the same kernel, the second started from the seeds; the labels
equal the flat solve's.

``extract_regions`` turns labels and the prob map into K fixed region slots per
page (area, mean score, centroid, principal angle, rotated extents), and
``regions_to_quads`` / ``unclip_distance_*`` turn those into word quads.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import kernels

Stats = Dict[str, torch.Tensor]

#: pixels that belong to no slot spread their scatter writes over this many
#: dummy columns: thousands of atomics on one address serialize on the card
_SPILL = 1024


def _segmented_min(v: torch.Tensor, resets: torch.Tensor, dim: int,
                   reverse: bool, stride: int) -> torch.Tensor:
    """Running min of int64 ``v`` along ``dim``, restarting where ``resets``.

    Each run gets an offset ``-run_id * stride`` (``stride`` > every value),
    so a plain ``cummin`` never carries a value across a reset."""
    if reverse:
        v, resets = v.flip(dim), resets.flip(dim)
    offset = torch.cumsum(resets, dim) * stride
    out = torch.cummin(v - offset, dim).values + offset
    return out.flip(dim) if reverse else out


def _sweep(labels: torch.Tensor, mask: torch.Tensor, big: int) -> torch.Tensor:
    resets = (~mask).to(torch.int64)
    for dim, reverse in ((2, False), (2, True), (1, False), (1, True)):
        v = torch.where(mask, labels, big)
        labels = torch.where(
            mask, _segmented_min(v, resets, dim, reverse, big + 1), big
        )
    return labels


def connected_components_reference(
    mask: torch.Tensor, max_iters: int = 64, return_sweeps: bool = False,
    seed: torch.Tensor = None,
):
    """Plain PyTorch CCL: (B, H, W) bool/uint8 -> (B, H, W) int32 labels.

    With ``return_sweeps`` also returns the (B,) number of sweeps each page
    ran (the kernel runs the same number). ``seed`` ((B, H, W) int32): each
    mask pixel starts from min(its own index, seed) instead of its index."""
    mask = mask.bool()
    B, H, W = mask.shape
    big = H * W
    idx = torch.arange(big, device=mask.device, dtype=torch.int64).view(1, H, W)
    if seed is not None:
        idx = torch.minimum(idx, seed.to(torch.int64))
    prev = torch.where(mask, idx, big)
    labels = _sweep(prev, mask, big)
    sweeps = torch.ones(B, dtype=torch.int32, device=mask.device)
    for _ in range(1, max_iters):
        changed = (labels != prev).flatten(1).any(1)
        if not bool(changed.any()):
            break
        sweeps += changed.to(torch.int32)
        prev, labels = labels, _sweep(labels, mask, big)
    out = torch.where(mask, labels, -1).to(torch.int32)
    return (out, sweeps) if return_sweeps else out


def connected_components_cuda(mask: torch.Tensor, max_iters: int = 64,
                              return_sweeps: bool = False, seed: torch.Tensor = None):
    """Launch ``csrc/ccl.cu`` on a CUDA mask; raises on anything it does not take.

    With ``return_sweeps`` also returns the (B,) int32 number of sweeps each
    page ran, as the kernel counted them. ``seed`` ((B, H, W) int32 on the
    mask's device): the kernel starts each mask pixel from min(its own index,
    seed), as ``connected_components_reference`` does."""
    if mask.device.type != "cuda":
        raise ValueError(f"connected_components_cuda needs a CUDA tensor, got {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    if mask.dim() != 3:
        raise ValueError(f"mask must be (B, H, W), got {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    B, H, W = mask.shape
    if H * W >= 2**31:
        raise ValueError(f"page of {H}x{W} pixels overflows int32 labels")
    if seed is not None and (seed.dtype != torch.int32 or seed.shape != mask.shape
                             or seed.device != mask.device or not seed.is_contiguous()):
        raise ValueError("seed must be a contiguous int32 tensor of the mask's shape "
                         "and device")
    labels = torch.empty((B, H, W), dtype=torch.int32, device=mask.device)
    lib = kernels.library("ccl")
    lib.mr_ccl_scratch_size.argtypes = [ctypes.c_int]
    lib.mr_ccl_scratch_size.restype = ctypes.c_int64
    # the sweep counts, then the changed flags; the kernel zeroes them
    scratch = torch.empty(lib.mr_ccl_scratch_size(B), dtype=torch.int32, device=mask.device)
    fn = lib.mr_ccl_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(mask.data_ptr(), None if seed is None else seed.data_ptr(),
                 labels.data_ptr(), scratch.data_ptr(), B, H, W, int(max_iters), stream)
    kernels.check(err, "ccl kernel")
    connected_components_cuda.launches += 1
    return (labels, scratch[:B]) if return_sweeps else labels


def connected_components_cuda_config(B: int, H: int, W: int) -> Dict[str, int]:
    """The launch ``csrc/ccl.cu`` makes for a (B, H, W) mask on the current
    CUDA device: grid blocks, co-resident blocks per SM, SMs, and the strip
    width of the first sweep."""
    out = (ctypes.c_int * 4)()
    fn = kernels.library("ccl").mr_ccl_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    kernels.check(fn(B, H, W, out), "ccl launch config")
    return dict(zip(("grid", "blocks_per_sm", "sms", "strip"), out))


#: kernel launches since the count was last set to 0
connected_components_cuda.launches = 0


def multigrid_solve(solve, mask: torch.Tensor, max_iters: int = 64,
                    return_sweeps: bool = False):
    """Two-level CCL (the JAX ``_ccl_multigrid_single``), both levels by
    ``solve`` (``connected_components_reference`` or
    ``connected_components_cuda``).

    The coarse mask is the 2x2 min-pool of the mask, so a coarse component is
    connected at full resolution too, and each coarse label names a real
    member pixel. Each pixel of a coarse-on block is seeded with the full
    index of its coarse root's top-left pixel (pixels of an odd last row or
    column get no seed), and the full-resolution solve starts from
    min(index, seed): its fixed point is the flat solve's labels. With
    ``return_sweeps`` also returns (2, B) int32 sweeps, the coarse solve's
    then the full one's.

    The JAX dispatcher skips multigrid under its Pallas kernel (``impl``
    'pallas', which 'auto' picks on the TPU), so there it never ran under
    'auto'; this port runs it whenever it is asked for. JAX's optimization
    barrier on the mask guards an XLA fusion fault and has no counterpart
    here."""
    mask = mask.bool()
    B, H, W = mask.shape
    Hc, Wc = H // 2, W // 2
    m = mask[:, :2 * Hc, :2 * Wc]
    coarse = (m[:, 0::2, 0::2] & m[:, 0::2, 1::2] & m[:, 1::2, 0::2]
              & m[:, 1::2, 1::2]).contiguous()
    lc, coarse_sweeps = solve(coarse, max_iters, return_sweeps=True)
    lc = lc.to(torch.int64)
    cy = torch.div(lc, max(Wc, 1), rounding_mode="floor")
    seed = torch.where(lc >= 0, 2 * cy * W + 2 * (lc - cy * Wc), H * W).to(torch.int32)
    seed = seed.repeat_interleave(2, 1).repeat_interleave(2, 2)
    seed = torch.nn.functional.pad(seed, (0, W - 2 * Wc, 0, H - 2 * Hc), value=H * W)
    labels, sweeps = solve(mask.contiguous(), max_iters, return_sweeps=True,
                           seed=seed.contiguous())
    return (labels, torch.stack([coarse_sweeps, sweeps])) if return_sweeps else labels


def connected_components(mask: torch.Tensor, max_iters: int = 64,
                         multigrid: bool = False) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int32 labels (min linear index; -1 = bg).

    A CPU tensor runs the plain version; any other launches the CUDA kernel
    (twice under ``multigrid``, the second launch seeded by the first)."""
    solve = (connected_components_reference if mask.device.type == "cpu"
             else connected_components_cuda)
    return multigrid_solve(solve, mask, max_iters) if multigrid else solve(mask, max_iters)


def _candidates(lbl: torch.Tensor, K2: int):
    """Roots (pixels labelled with their own index) of lbl (B, N) int64 in
    K2 slots by raster rank, with their exact pixel counts: (cand_idx (B, K2)
    int64, cand_area (B, K2) f32). Dead slots hold root 0 and area 0; roots
    past the first K2 take no slot."""
    B, N = lbl.shape
    idx = torch.arange(N, device=lbl.device)
    valid = lbl >= 0
    is_root = (lbl == idx) & valid
    rank = torch.cumsum(is_root, 1) - 1
    spill = idx % _SPILL
    slot = torch.where(is_root & (rank < K2), rank, K2 + spill)
    cand_idx = torch.zeros((B, K2 + _SPILL), dtype=torch.int64, device=lbl.device)
    cand_idx.scatter_(1, slot, idx.expand(B, N))  # columns >= K2 take the rest
    alive = torch.arange(K2, device=lbl.device) < is_root.sum(1, keepdim=True)
    cand_idx = torch.where(alive, cand_idx[:, :K2], 0)

    counts = torch.zeros((B, N + _SPILL), dtype=torch.int64, device=lbl.device)
    counts.scatter_add_(1, torch.where(valid, lbl, N + spill), torch.ones_like(lbl))
    return cand_idx, counts.gather(1, cand_idx).to(torch.float32) * alive


def _top_k_slots(cand_idx: torch.Tensor, cand_area: torch.Tensor, K: int):
    """The K candidates of largest area: (top_area (B, K) f32, top_root (B, K),
    valid (B, K))."""
    # stable sort: equal areas keep the lower slot first, as lax.top_k does
    top_area, order = torch.sort(cand_area, dim=1, descending=True, stable=True)
    top_area, sel = top_area[:, :K], order[:, :K]
    return top_area, cand_idx.gather(1, sel), top_area > 0


def _candidate_roots(lbl: torch.Tensor, K: int):
    """Top-K component roots by area, as ``ops/ccl._candidate_roots_single``:
    only the first K2 = max(8K, 128) roots in raster order compete."""
    return _top_k_slots(*_candidates(lbl, max(8 * K, 128)), K)


def _group_stats(group: torch.Tensor, G: int, area: torch.Tensor,
                 scores: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> Stats:
    """Region statistics of pixel groups 0..G-1 (group >= G: no group).

    group (B, N) int64; area (B, G) divisor (>= 1). Sums run in float64, so
    the result is the exact value of the reference's float32 formulas up to
    their own rounding."""
    B, N = group.shape
    dev = group.device
    group = torch.where(group < G, group, G + torch.arange(N, device=dev) % _SPILL)

    def gsum(vals):  # (B, N) -> (B, G)
        out = torch.zeros((B, G + _SPILL), dtype=torch.float64, device=dev)
        return out.scatter_add_(1, group, vals)[:, :G]

    def per_pixel(t):  # (B, G) -> (B, N), 0 for pixels in no group
        return torch.cat([t, t.new_zeros(B, _SPILL)], 1).gather(1, group)

    a = area.to(torch.float64)
    score = gsum(scores) / a
    cx = gsum(xs.expand(B, N)) / a
    cy = gsum(ys.expand(B, N)) / a
    dx = xs - per_pixel(cx)
    dy = ys - per_pixel(cy)
    vxx = gsum(dx * dx) / a
    vyy = gsum(dy * dy) / a
    vxy = gsum(dx * dy) / a
    theta = (0.5 * torch.atan2(2.0 * vxy, vxx - vyy)).to(torch.float32)
    cos_p = per_pixel(torch.cos(theta).to(torch.float64))
    sin_p = per_pixel(torch.sin(theta).to(torch.float64))
    u = dx * cos_p + dy * sin_p
    v = -dx * sin_p + dy * cos_p

    def gext(vals, op, init):
        out = torch.full((B, G + _SPILL), init, dtype=torch.float64, device=dev)
        return out.scatter_reduce_(1, group, vals, op)[:, :G]

    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    return {
        "score": f32(score),
        "center": f32(torch.stack([cx, cy], -1)),
        "theta": theta,
        "extent_u": f32(torch.stack([gext(u, "amin", 1e9), gext(u, "amax", -1e9)], -1)),
        "extent_v": f32(torch.stack([gext(v, "amin", 1e9), gext(v, "amax", -1e9)], -1)),
    }


def extract_regions(labels: torch.Tensor, scores: torch.Tensor,
                    max_regions: int = 64, impl: str = "auto") -> Stats:
    """(B, H, W) labels + prob map -> per-region stats, K fixed slots per page.

    ``impl``: 'auto' is 'xla', as in the JAX package; 'pallas' and
    'pallas_full' run the JAX package's Pallas path through the CUDA kernels
    of ``ops/extract.py`` (its plain versions on the CPU): the XLA candidate
    phase or the candidates kernel, then the moments and extents kernels.

    'xla' gives the same slots and values as the JAX XLA formulation
    (``_region_stats_single``):
    slots in descending area (ties: lower raster rank first), centered second
    moments, principal angle, extents on the principal axes. A slot with no
    region (``valid`` False) holds root 0 with divisor 1, as there; its stats
    describe the component rooted at pixel 0, if one exists. Pixels reach their
    slot by gather and scatter, never through a (K, N) mask."""
    if impl == "auto":
        impl = "xla"
    if impl in ("pallas", "pallas_full"):
        from .extract import extract_regions_kernels

        return extract_regions_kernels(labels, scores, max_regions, full=impl == "pallas_full")
    if impl != "xla":
        raise ValueError(f"unknown extract impl {impl!r}")
    B, H, W = labels.shape
    N = H * W
    K = max_regions
    lbl = labels.reshape(B, N).to(torch.int64)
    top_area, top_root, region_valid = _candidate_roots(lbl, K)

    dev = labels.device
    yy, xx = torch.meshgrid(
        torch.arange(H, device=dev, dtype=torch.float64),
        torch.arange(W, device=dev, dtype=torch.float64), indexing="ij",
    )
    xs, ys = xx.reshape(1, N), yy.reshape(1, N)
    sc = scores.reshape(B, N).to(torch.float64)

    # pixel -> slot of its root: column N is background, N + 1 takes the
    # writes of empty slots (valid roots are distinct)
    slot_of = torch.full((B, N + 2), K, dtype=torch.int64, device=dev)
    slot_of.scatter_(1, torch.where(region_valid, top_root, N + 1),
                     torch.arange(K, device=dev).expand(B, K))
    group = slot_of.gather(1, torch.where(lbl >= 0, lbl, N))
    stats = _group_stats(group, K, torch.clamp(top_area, min=1.0), sc, xs, ys)

    # empty slots: the component whose root is pixel 0, divided by 1
    group0 = (lbl != 0).to(torch.int64)
    empty = _group_stats(group0, 1, torch.ones((B, 1), device=dev), sc, xs, ys)
    out = {}
    for key, val in stats.items():
        keep = region_valid.view(B, K, *([1] * (val.dim() - 2)))
        out[key] = torch.where(keep, val, empty[key])
    out["valid"] = region_valid
    out["area"] = top_area
    return out


def regions_to_quads(stats: Stats, unclip_distance: torch.Tensor = None) -> torch.Tensor:
    """Rotated-rect corners (B, K, 4, 2) in (x, y), clockwise from axis-min."""
    c = stats["center"]
    th = stats["theta"]
    u0, u1 = stats["extent_u"][..., 0] - 0.5, stats["extent_u"][..., 1] + 0.5
    v0, v1 = stats["extent_v"][..., 0] - 0.5, stats["extent_v"][..., 1] + 0.5
    if unclip_distance is not None:
        u0, u1 = u0 - unclip_distance, u1 + unclip_distance
        v0, v1 = v0 - unclip_distance, v1 + unclip_distance
    cos_t, sin_t = torch.cos(th), torch.sin(th)

    def corner(uu, vv):
        x = c[..., 0] + uu * cos_t - vv * sin_t
        y = c[..., 1] + uu * sin_t + vv * cos_t
        return torch.stack([x, y], -1)

    return torch.stack(
        [corner(u0, v0), corner(u1, v0), corner(u1, v1), corner(u0, v1)], -2
    )


def unclip_distance_for(stats: Stats, ratio: float = 1.5) -> torch.Tensor:
    """pyclipper-style offset distance d = area * ratio / perimeter (B, K)."""
    w = stats["extent_u"][..., 1] - stats["extent_u"][..., 0] + 1.0
    h = stats["extent_v"][..., 1] - stats["extent_v"][..., 0] + 1.0
    d = w * h * ratio / torch.clamp(2.0 * (w + h), min=1e-6)
    return torch.where(stats["valid"], d, 0.0)


def unclip_distance_inverse(stats: Stats, shrink_ratio: float = 0.4) -> torch.Tensor:
    """Exact inverse of the training-time shrink for rectangles (B, K): the
    positive root of 4(1+r²)D² + 2r²(w'+h')D - (1-r²)w'h' = 0."""
    w = stats["extent_u"][..., 1] - stats["extent_u"][..., 0] + 1.0
    h = stats["extent_v"][..., 1] - stats["extent_v"][..., 0] + 1.0
    r2 = float(shrink_ratio) ** 2
    a = 4.0 * (1.0 + r2)
    b = 2.0 * r2 * (w + h)
    c = (1.0 - r2) * w * h
    d = (-b + torch.sqrt(b * b + 4.0 * a * c)) / (2.0 * a)
    return torch.where(stats["valid"], d, 0.0)
