"""Region extraction through the hand-written CUDA kernels ``csrc/extract.cu``.

The port of ``megreader_tpu/ops/pallas_extract.py``: three kernels and the
K-sized glue between them.

* ``candidates``: the first K2 roots of a page in raster order take slots
  0..K2-1, with their exact pixel counts (``_candidates_kernel``);
* ``moments``: per slot, count, score sum, first moments and second moments
  centred on the slot's own centroid (``_moments_kernel``);
* ``extents``: per slot, min and max of the projections on its principal
  axes (``_extents_kernel``).

Each has a plain PyTorch version (``*_reference``) and a CUDA wrapper
(``*_cuda``) that counts its launches; the dispatching function runs the plain
version for a CPU tensor and the kernel for any other, which raises on what it
does not take. The kernels find a pixel's slot by probing its label in a
shared-memory table of the page's roots, with no loop over the slots; the
candidates, the moments' integer columns and the extents are bit-exact to
the plain versions and from launch to launch.

``extract_regions_kernels`` is ``extract_regions_pallas``: the candidate phase
by the XLA formulation (``ops/ccl.py::_candidate_roots``, K2 = max(8K, 128))
or, with ``full``, by the candidates kernel (K2 rounded up to a multiple of
128, as the Pallas path has it), then top-K by area (ties: the lower slot),
the moments kernel, the principal angle, the extents kernel. It keeps the
Pallas path's arithmetic on every slot: the moments are centred on the
kernel's own pixel count and divided by max(area, 1), so an empty slot (root
0, area 0) describes the component rooted at pixel 0 with its sums divided by
1 and its second moments centred on its mean, where the XLA formulation
centres them on the undivided sums.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import kernels
from .ccl import _SPILL, Stats, _candidate_roots, _candidates, _top_k_slots

#: slots a kernel takes (shared memory a slot with its share of the root
#: table: extents 104 bytes, moments 192; both opt in above 48 KB). The
#: candidates take up to 8 * MAX_REGIONS (a table of 2-8 entries a slot)
MAX_REGIONS = 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pallas_k2(max_regions: int) -> int:
    """Candidate slots of the full kernel path: round_up(max(8K, 128), 128)."""
    return _round_up(max(8 * max_regions, 128), 128)


def _coords(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    yy, xx = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float64),
                            torch.arange(W, device=device, dtype=torch.float64), indexing="ij")
    return xx.reshape(1, H * W), yy.reshape(1, H * W)


# --- plain versions ------------------------------------------------------------


def candidates_reference(labels: torch.Tensor, K2: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) int32 labels -> (cand_idx (B, K2) int32, cand_area (B, K2)
    float32): the first K2 roots in raster order and their pixel counts; dead
    slots hold root 0 and area 0."""
    B = labels.shape[0]
    cand_idx, cand_area = _candidates(labels.reshape(B, -1).to(torch.int64), K2)
    return cand_idx.to(torch.int32), cand_area


def check_moment_range(H: int, W: int) -> None:
    """Raise unless the moments' int64 sums cannot overflow on an (H, W) page.

    Every sum of x^2, y^2 or x*y over a slot, and every term of the centring,
    is at most H*W*(max(H, W) - 1)^2, which must stay below 2^63. Below 2^53
    (pages up to about 9,700 px square) every such integer also converts to
    float64 exactly."""
    if H * W * (max(H, W) - 1) ** 2 >= 2**63:
        raise ValueError(f"a page of {H}x{W} may overflow the moments' int64 sums")


def moments_reference(labels: torch.Tensor, scores: torch.Tensor,
                      roots: torch.Tensor) -> torch.Tensor:
    """labels (B, H, W) int32, scores (B, H, W), roots (B, K) -> (B, K, 8)
    float32 sums over each slot's pixels (label == root): count, score, x, y,
    then dx^2, dy^2, dx*dy centred on sum / max(count, 1); column 7 is 0.

    Each pixel joins the lowest slot holding its root; slots that repeat a
    root copy that slot's sums. The count n and the sums of x, y, x^2, y^2
    and x*y are exact int64 sums. The centring splits sum x = q*n + r
    (0 <= r < n), so that sum dx^2 = (sum x^2 - q^2*n - 2*q*r) - r^2/n and
    sum dx*dy = (sum xy - qx*qy*n - qx*ry - qy*rx) - rx*ry/n: each bracket is
    an exact int64, then one float64 division, one float64 subtraction and
    one rounding to float32 (n = 0 gives 0). The score is a float64 sum.
    ``csrc/extract.cu`` finishes with the same integer steps and float64
    operations."""
    B, H, W = labels.shape
    check_moment_range(H, W)
    N, K = H * W, roots.shape[1]
    dev = labels.device
    lbl = labels.reshape(B, N).to(torch.int64)
    roots = roots.to(torch.int64)
    slot_of = torch.full((B, N + 1), K, dtype=torch.int64, device=dev)
    slot_of.scatter_reduce_(1, roots, torch.arange(K, device=dev).expand(B, K), "amin")
    first = slot_of.gather(1, roots)  # (B, K): the lowest slot with the same root
    group = slot_of.gather(1, torch.where(lbl >= 0, lbl, N))
    group = torch.where(group < K, group, K + torch.arange(N, device=dev) % _SPILL)

    def gsum(vals):  # (1 or B, N) -> (B, K), in vals' type
        out = torch.zeros((B, K + _SPILL), dtype=vals.dtype, device=dev)
        return out.scatter_add_(1, group, vals.expand(B, N))[:, :K]

    pix = torch.arange(N, device=dev).view(1, N)
    xs, ys = pix % W, pix // W
    n, sx, sy = gsum(torch.ones_like(xs)), gsum(xs), gsum(ys)
    sxx, syy, sxy = gsum(xs * xs), gsum(ys * ys), gsum(xs * ys)
    m = n.clamp(min=1)
    qx, rx = sx // m, sx % m
    qy, ry = sy // m, sy % m

    def centred(e, r2):  # the exact int64 bracket less r^2 / n, in float64
        return e.to(torch.float64) - r2.to(torch.float64) / m.to(torch.float64)

    M = torch.stack([
        n.to(torch.float64), gsum(scores.reshape(B, N).to(torch.float64)),
        sx.to(torch.float64), sy.to(torch.float64),
        centred(sxx - qx * qx * n - 2 * qx * rx, rx * rx),
        centred(syy - qy * qy * n - 2 * qy * ry, ry * ry),
        centred(sxy - qx * qy * n - qx * ry - qy * rx, rx * ry),
        torch.zeros((B, K), dtype=torch.float64, device=dev),
    ], -1)
    return M.gather(1, first[..., None].expand(B, K, 8)).to(torch.float32)


def extents_reference(labels: torch.Tensor, roots: torch.Tensor,
                      params: torch.Tensor) -> torch.Tensor:
    """labels (B, H, W) int32, roots (B, K), params (B, K, 4) float32 (cx, cy,
    cos, sin) -> (B, K, 4) float32 (min u, max u, min v, max v) over each
    slot's pixels, u = dx cos + dy sin, v = -dx sin + dy cos in float64
    rounded to float32; a slot with no pixel keeps (1e9, -1e9, 1e9, -1e9).
    The minima start from 1e9 and the maxima from -1e9, as the TPU kernel's
    accumulators do, so a slot whose projections all lie past them (a dead
    slot centred on a page-sized component's undivided sums) keeps them too.

    One pass per slot: slots that share a root (the empty slots' root 0) may
    differ in their parameters."""
    B, H, W = labels.shape
    N, K = H * W, roots.shape[1]
    lbl = labels.reshape(B, N).to(torch.int64)
    xs, ys = _coords(H, W, labels.device)
    prm = params.to(torch.float64)
    big = torch.tensor(1e9, dtype=torch.float32, device=labels.device)
    out = []
    for k in range(K):
        member = lbl == roots[:, k:k + 1].to(torch.int64)
        cx, cy, c, s = (prm[:, k, j:j + 1] for j in range(4))
        dx, dy = xs - cx, ys - cy
        u = (dx * c + dy * s).to(torch.float32)
        v = (-dx * s + dy * c).to(torch.float32)
        out.append(torch.stack([
            torch.minimum(torch.where(member, u, big).amin(1), big),
            torch.maximum(torch.where(member, u, -big).amax(1), -big),
            torch.minimum(torch.where(member, v, big).amin(1), big),
            torch.maximum(torch.where(member, v, -big).amax(1), -big),
        ], -1))
    return torch.stack(out, 1) if out else params.new_zeros((B, 0, 4))


# --- CUDA wrappers ---------------------------------------------------------------


def _check_labels(labels: torch.Tensor, what: str) -> None:
    if labels.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {labels.device}")
    if labels.dtype != torch.int32 or labels.dim() != 3 or not labels.is_contiguous():
        raise ValueError(f"{what}: labels must be contiguous (B, H, W) int32, got "
                         f"{labels.dtype} {tuple(labels.shape)}")
    if labels.shape[1] * labels.shape[2] >= 2**31:
        raise ValueError(f"{what}: a page of {tuple(labels.shape[1:])} overflows int32 indices")


def _check_like(t: torch.Tensor, labels: torch.Tensor, dtype, shape, what: str) -> None:
    if t.device != labels.device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous {tuple(shape)} {dtype} on {labels.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _slots(roots: torch.Tensor, labels: torch.Tensor) -> int:
    """K of (B, K) int32 roots on the labels' device."""
    K = roots.shape[-1] if roots.dim() == 2 else -1
    _check_like(roots, labels, torch.int32, (labels.shape[0], K), "roots")
    if K > MAX_REGIONS:
        raise ValueError(f"{K} slots exceed the kernels' {MAX_REGIONS}")
    return K


# The C launchers of csrc/extract.cu, bound once (``kernels.functions``)
_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "mr_extract_candidates_scratch_bytes": ([_I] * 3, ctypes.c_longlong),
    "mr_extract_candidates": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "mr_extract_moments": ([_P] * 5 + [_I] * 4 + [_P], _I),
    "mr_extract_extents": ([_P] * 4 + [_I] * 4 + [_P], _I),
}
#: 64-bit words of the moments kernel's scratch a slot (kSums in csrc/extract.cu)
_MOMENT_WORDS = 8


def candidates_cuda(labels: torch.Tensor, K2: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the candidates kernels on CUDA labels (see ``candidates_reference``):
    a pass that ranks each tile's roots in the page (a chained scan), then one
    that counts each candidate's pixels through a shared table of the
    candidates. The scratch is K2-sized and a few words a tile."""
    _check_labels(labels, "candidates_cuda")
    if not 0 < K2 <= 8 * MAX_REGIONS:
        raise ValueError(f"K2 = {K2} outside 1..{8 * MAX_REGIONS}")
    B, H, W = labels.shape
    N = H * W
    fns = kernels.functions("extract", _PROTOTYPES)
    dev = labels.device
    scratch = torch.empty(fns["mr_extract_candidates_scratch_bytes"](B, N, K2),
                          dtype=torch.uint8, device=dev)
    cand_idx = torch.empty((B, K2), dtype=torch.int32, device=dev)
    areas = torch.empty((B, K2), dtype=torch.float32, device=dev)
    err = kernels.launch(fns["mr_extract_candidates"], dev, labels.data_ptr(),
                         scratch.data_ptr(), cand_idx.data_ptr(), areas.data_ptr(), B, N, K2)
    kernels.check(err, "extract candidates kernels")
    candidates_cuda.launches += 1
    return cand_idx, areas


def moments_cuda(labels: torch.Tensor, scores: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """Launch the moments kernels (see ``moments_reference``): one pass over
    the labels and scores, then a small one that writes the float32 result."""
    _check_labels(labels, "moments_cuda")
    B, H, W = labels.shape
    check_moment_range(H, W)
    _check_like(scores, labels, torch.float32, (B, H, W), "scores")
    K = _slots(roots, labels)
    dev = labels.device
    out = torch.empty((B, K, 8), dtype=torch.float32, device=dev)
    scratch = torch.empty((B, K, _MOMENT_WORDS), dtype=torch.int64, device=dev)
    fn = kernels.functions("extract", _PROTOTYPES)["mr_extract_moments"]
    err = kernels.launch(fn, dev, labels.data_ptr(), scores.data_ptr(), roots.data_ptr(),
                         scratch.data_ptr(), out.data_ptr(), B, H, W, K)
    kernels.check(err, "extract moments kernel")
    moments_cuda.launches += 1
    return out


def extents_cuda(labels: torch.Tensor, roots: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Launch the extents kernels (see ``extents_reference``): a small one that
    writes the sentinels, then one pass over the labels, each pixel projected
    for every distinct parameter set among the slots that hold its root.
    Bit-exact and repeatable."""
    _check_labels(labels, "extents_cuda")
    B, H, W = labels.shape
    K = _slots(roots, labels)
    _check_like(params, labels, torch.float32, (B, K, 4), "params")
    ext = torch.empty((B, K, 4), dtype=torch.float32, device=labels.device)
    fn = kernels.functions("extract", _PROTOTYPES)["mr_extract_extents"]
    err = kernels.launch(fn, labels.device, labels.data_ptr(), roots.data_ptr(),
                         params.data_ptr(), ext.data_ptr(), B, H, W, K)
    kernels.check(err, "extract extents kernel")
    extents_cuda.launches += 1
    return ext


#: kernel launches (wrapper calls) since the counts were last set to 0
candidates_cuda.launches = 0
moments_cuda.launches = 0
extents_cuda.launches = 0


def candidates(labels: torch.Tensor, K2: int):
    if labels.device.type == "cpu":
        return candidates_reference(labels, K2)
    return candidates_cuda(labels, K2)


def moments(labels: torch.Tensor, scores: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    if labels.device.type == "cpu":
        return moments_reference(labels, scores, roots)
    return moments_cuda(labels, scores, roots)


def extents(labels: torch.Tensor, roots: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    if labels.device.type == "cpu":
        return extents_reference(labels, roots, params)
    return extents_cuda(labels, roots, params)


# --- the Pallas path's glue --------------------------------------------------------


def extract_regions_kernels(labels: torch.Tensor, scores: torch.Tensor,
                            max_regions: int = 64, full: bool = False) -> Stats:
    """(B, H, W) int32 labels + prob map -> per-region stats, K slots per page,
    the JAX package's ``extract_regions_pallas`` (``full``: its
    ``candidates='pallas'``). Same keys as ``ops/ccl.py::extract_regions``."""
    B, H, W = labels.shape
    K = max_regions
    labels = labels.to(torch.int32).contiguous()
    if full:
        top_area, top_root, region_valid = _top_k_slots(*candidates(labels, pallas_k2(K)), K)
    else:
        top_area, top_root, region_valid = _candidate_roots(
            labels.reshape(B, H * W).to(torch.int64), K)
    top_root = top_root.to(torch.int32).contiguous()
    M = moments(labels, scores.to(torch.float32).contiguous(), top_root)

    a = torch.clamp(top_area, min=1.0)
    score, cx, cy = M[..., 1] / a, M[..., 2] / a, M[..., 3] / a
    vxx, vyy, vxy = M[..., 4] / a, M[..., 5] / a, M[..., 6] / a
    theta = 0.5 * torch.atan2(2.0 * vxy, vxx - vyy)
    params = torch.stack([cx, cy, torch.cos(theta), torch.sin(theta)], 2).contiguous()
    ext = extents(labels, top_root, params)
    return {
        "valid": region_valid,
        "area": top_area,
        "score": score,
        "center": torch.stack([cx, cy], -1),
        "theta": theta,
        "extent_u": ext[..., 0:2],
        "extent_v": ext[..., 2:4],
    }
