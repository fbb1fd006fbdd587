"""2D-CTC: CTC over a 2-D probability map (arXiv:1907.09705).

A path sits at one of H heights in each of T columns and emits one class
there. The model gives emission log-probs (B, T, H, C) and either

* ``independent`` heights, log q(h | t) (B, T, H): heights marginalize per
  column (``fuse_heights``) and the loss is the 1-D CTC loss of the fused
  (B, T, C) log-probs, which ``ops/ctc.py::ctc_nll`` computes (its CUDA
  kernels on the card); or
* a ``markov`` height chain, log A_t(h_prev -> h) (B, T, H, H) plus the
  initial heights (B, H): a DP over (t, h, s) whose step is the CTC label
  move in each height plane, then a logsumexp contraction over the previous
  height with A_t, then the emission.

The Markov NLL follows the tensor's device: a CPU tensor runs the plain
version ``ctc2d_nll_markov_reference`` (a port of the XLA scan
``megreader_tpu/ops/ctc2d.py::ctc2d_loss_markov``, differentiated by
autograd); any other tensor goes through the hand-written CUDA kernels in
``csrc/ctc2d.cu`` (``ctc2d_nll_markov_cuda``: the alpha kernel forward, the
beta kernel backward, gradients for the emissions, the transitions and the
initial heights).

Both keep the XLA scan's sentinel arithmetic, not the Pallas kernels': the
label move's logsumexp gives ``NEG_INF`` where its maximum lies at or below
``NEG_INF / 2``, the height contraction and the final height marginalization
are plain logsumexps, invalid states are set to ``NEG_INF``, alpha is frozen
from ``t >= logit_length`` on and ``trans[:, 0]`` is never used. A row with
no alignment has a finite loss of about 1e30, and its gradient is -1/(2H) on
the emission of the two terminal states' classes at the row's last step, at
every height, and -1/H^2 on every transition of that step.

Decoding: ``ctc2d_greedy_decode`` (independent heights: the best height per
column, its argmax class, CTC collapse) and ``ctc2d_viterbi_height_decode``
(Markov heights: Viterbi over the chain scored by each cell's best class,
then greedy CTC along the chosen heights).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from .ctc import NEG_INF, _SMEM_LIMIT, _extend_labels, _reduce, ctc_greedy_decode, ctc_nll


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.logsumexp``: the maximum enters as a constant, so the
    gradient is exp(x - max) / sum. ``torch.logsumexp`` differentiates to
    exp(x - result), which differs where the result rounds to the maximum:
    H equal sentinels give 1 each there, 1/H here."""
    m = x.detach().amax(dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (torch.log(torch.exp(x - m).sum(dim, keepdim=True)) + m).squeeze(dim)


def fuse_heights(emit_log_probs: torch.Tensor, height_log_probs: torch.Tensor) -> torch.Tensor:
    """Marginalize heights per column: (B, T, H, C) + (B, T, H) -> (B, T, C)."""
    return _logsumexp(emit_log_probs + height_log_probs.unsqueeze(-1), 2)


def ctc2d_loss_independent(emit_log_probs: torch.Tensor, height_log_probs: torch.Tensor,
                           logit_lengths: torch.Tensor, labels: torch.Tensor,
                           label_lengths: torch.Tensor, blank: int = 0,
                           reduction: str = "mean") -> torch.Tensor:
    """2D-CTC NLL with per-column independent heights: the 1-D CTC NLL of
    the fused log-probs (the 1-D CUDA kernels for a CUDA tensor)."""
    fused = fuse_heights(emit_log_probs, height_log_probs)
    nll = ctc_nll(fused, logit_lengths, labels, label_lengths, blank)
    return _reduce(nll, label_lengths, reduction)


def ctc2d_nll_markov_reference(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                               init_height_log_probs: torch.Tensor,
                               logit_lengths: torch.Tensor, labels: torch.Tensor,
                               label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Plain Markov 2D-CTC forward DP -> (B,) NLL; differentiable by autograd.

    emit (B, T, H, C) log P(c | t, h); trans (B, T, H, H) log A_t with rows
    h_prev and columns h, entry t used on the move into column t (t >= 1);
    init (B, H); labels (B, L) padded, masked by ``label_lengths``."""
    B, T, H, C = emit_log_probs.shape
    S = 2 * labels.shape[1] + 1
    dev = emit_log_probs.device
    labels = labels.long().to(dev)
    label_lengths = label_lengths.long().to(dev)
    logit_lengths = logit_lengths.to(dev)
    ext = _extend_labels(labels, blank)
    ext_shift2 = F.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = ((ext != blank) & (ext != ext_shift2)).view(B, 1, S)
    s_idx = torch.arange(S, device=dev).view(1, S)
    valid = (s_idx < 2 * label_lengths.view(B, 1) + 1).view(B, 1, S)
    emit = emit_log_probs.gather(3, ext.view(B, 1, 1, S).expand(B, T, H, S))  # (B, T, H, S)

    # t = 0: the first blank and the first label, at every height
    start = ((s_idx == 0) | ((s_idx == 1) & (label_lengths > 0).view(B, 1))).view(B, 1, S)
    alpha = torch.where(start & valid, init_height_log_probs.unsqueeze(-1) + emit[:, 0], NEG_INF)

    for t in range(1, T):
        # 1) label moves in each height plane (guarded logsumexp)
        a1 = F.pad(alpha, (1, 0), value=NEG_INF)[..., :S]
        a2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=NEG_INF)[..., :S], NEG_INF)
        stacked = torch.stack([alpha, a1, a2])
        m = stacked.amax(0)
        lbl = torch.where(m <= NEG_INF / 2, NEG_INF, m + torch.log(torch.exp(stacked - m).sum(0)))
        # 2) height move: logsumexp over h_prev of lbl[h_prev] + A_t[h_prev, h]
        moved = _logsumexp(lbl.unsqueeze(2) + trans_log_probs[:, t].unsqueeze(-1), 1)
        new = torch.where(valid, moved + emit[:, t], NEG_INF)
        alpha = torch.where((t < logit_lengths).view(B, 1, 1), new, alpha)

    # marginalize heights, then read the terminal states
    alpha_s = _logsumexp(alpha, 1)  # (B, S)
    s_last = 2 * label_lengths
    a_last = alpha_s.gather(1, s_last.view(B, 1))[:, 0]
    a_prev = alpha_s.gather(1, (s_last - 1).clamp(min=0).view(B, 1))[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, NEG_INF)
    m = torch.maximum(a_last, a_prev)
    return -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))


def _check(emit, trans, init, logit_lengths, labels, label_lengths, blank) -> None:
    if emit.device.type != "cuda":
        raise ValueError(f"the 2D-CTC kernels need a CUDA tensor, got {emit.device}")
    if emit.dtype != torch.float32 or emit.dim() != 4:
        raise TypeError(f"emit_log_probs must be (B, T, H, C) float32, got "
                        f"{tuple(emit.shape)} {emit.dtype}")
    B, T, H, C = emit.shape
    if T < 1 or H < 1 or C < 1:
        raise ValueError(f"emit_log_probs of shape {tuple(emit.shape)} is empty")
    if not 0 <= blank < C:
        raise ValueError(f"blank {blank} is not one of the {C} classes")
    floats = [("trans_log_probs", trans, (B, T, H, H))]
    if init is not None:
        floats.append(("init_height_log_probs", init, (B, H)))
    for name, t, shape in floats:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != emit.device:
            raise TypeError(f"{name} must be float32 of shape {shape} on {emit.device}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t, shape in (("logit_lengths", logit_lengths, (B,)),
                           ("labels", labels, (B, labels.shape[-1])),
                           ("label_lengths", label_lengths, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != emit.device:
            raise TypeError(f"{name} must be int32 of shape {shape} on {emit.device}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("emit_log_probs", emit), ("trans_log_probs", trans),
                    ("init_height_log_probs", init), ("logit_lengths", logit_lengths),
                    ("labels", labels), ("label_lengths", label_lengths)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_limits(lib, H: int, L: int, C: int) -> None:
    """One block per sequence of H x (S rounded up to 32) threads."""
    S = 2 * L + 1
    threads = H * (-(-S // 32) * 32)
    if threads > 1024:
        raise ValueError(f"H = {H} heights x S = 2L+1 = {S} states (padded to a warp) need "
                         f"{threads} threads, more than one block's 1024")
    fn = lib.mr_ctc2d_beta_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_size_t
    smem = fn(H, L, C)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"2D-CTC beta kernel needs {smem} B of shared memory for H={H}, "
                         f"L={L}, C={C} (limit {_SMEM_LIMIT})")


def ctc2d_alpha_cuda(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                     init_height_log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                     labels: torch.Tensor, label_lengths: torch.Tensor, blank: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: -> (nll (B,), alpha (B, T, H, 2L+1))."""
    _check(emit_log_probs, trans_log_probs, init_height_log_probs, logit_lengths, labels,
           label_lengths, blank)
    B, T, H, C = emit_log_probs.shape
    L = labels.shape[1]
    lib = kernels.library("ctc2d")
    _launch_limits(lib, H, L, C)
    dev = emit_log_probs.device
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    alpha = torch.empty((B, T, H, 2 * L + 1), dtype=torch.float32, device=dev)
    if B == 0:
        return nll, alpha
    fn = lib.mr_ctc2d_alpha_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(emit_log_probs.data_ptr(), trans_log_probs.data_ptr(),
                 init_height_log_probs.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
                 label_lengths.data_ptr(), B, T, H, C, L, int(blank), alpha.data_ptr(),
                 nll.data_ptr(), stream)
    kernels.check(err, "ctc2d alpha kernel")
    ctc2d_alpha_cuda.launches += 1
    return nll, alpha


def ctc2d_beta_cuda(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                    logit_lengths: torch.Tensor, labels: torch.Tensor,
                    label_lengths: torch.Tensor, alpha: torch.Tensor, nll: torch.Tensor,
                    grad_nll: torch.Tensor, blank: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: -> d(grad_nll . nll) / d emit (B, T, H, C)
    and / d trans (B, T, H, H)."""
    _check(emit_log_probs, trans_log_probs, None, logit_lengths, labels, label_lengths, blank)
    B, T, H, C = emit_log_probs.shape
    L = labels.shape[1]
    dev = emit_log_probs.device
    for name, t, shape in (("alpha", alpha, (B, T, H, 2 * L + 1)), ("nll", nll, (B,)),
                           ("grad_nll", grad_nll, (B,))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous float32 {shape} on {dev}")
    lib = kernels.library("ctc2d")
    _launch_limits(lib, H, L, C)
    grad_emit = torch.empty_like(emit_log_probs)
    grad_trans = torch.empty_like(trans_log_probs)
    if B == 0:
        return grad_emit, grad_trans
    fn = lib.mr_ctc2d_beta_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(emit_log_probs.data_ptr(), trans_log_probs.data_ptr(), logit_lengths.data_ptr(),
                 labels.data_ptr(), label_lengths.data_ptr(), B, T, H, C, L, int(blank),
                 alpha.data_ptr(), nll.data_ptr(), grad_nll.data_ptr(), grad_emit.data_ptr(),
                 grad_trans.data_ptr(), stream)
    kernels.check(err, "ctc2d beta kernel")
    ctc2d_beta_cuda.launches += 1
    return grad_emit, grad_trans


#: kernel launches since the counts were last set to 0
ctc2d_alpha_cuda.launches = 0
ctc2d_beta_cuda.launches = 0


class _Ctc2dNll(torch.autograd.Function):
    """Forward: the alpha kernel (alpha saved); backward: the beta kernel,
    scaled by the upstream gradient of each row. The initial heights'
    gradient is the emission gradient of column 0 summed over classes."""

    @staticmethod
    def forward(ctx, emit, trans, init, logit_lengths, labels, label_lengths, blank):
        nll, alpha = ctc2d_alpha_cuda(emit, trans, init, logit_lengths, labels, label_lengths,
                                      blank)
        ctx.save_for_backward(emit, trans, logit_lengths, labels, label_lengths, alpha, nll)
        ctx.blank = blank
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        emit, trans, logit_lengths, labels, label_lengths, alpha, nll = ctx.saved_tensors
        grad_emit, grad_trans = ctc2d_beta_cuda(emit, trans, logit_lengths, labels,
                                                label_lengths, alpha, nll,
                                                grad_nll.contiguous(), ctx.blank)
        grad_init = grad_emit[:, 0].sum(-1)
        return grad_emit, grad_trans, grad_init, None, None, None, None


def ctc2d_nll_markov_cuda(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                          init_height_log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                          labels: torch.Tensor, label_lengths: torch.Tensor,
                          blank: int = 0) -> torch.Tensor:
    """(B,) NLL through the CUDA kernels, differentiable with respect to the
    emissions, transitions and initial heights. The counterpart of
    ``_ctc2d_nll_pallas``."""
    return _Ctc2dNll.apply(emit_log_probs, trans_log_probs, init_height_log_probs,
                           logit_lengths, labels, label_lengths, blank)


def ctc2d_nll_markov(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                     init_height_log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                     labels: torch.Tensor, label_lengths: torch.Tensor,
                     blank: int = 0) -> torch.Tensor:
    """(B,) NLL: the plain version for a CPU tensor, else the CUDA kernels."""
    if emit_log_probs.device.type == "cpu":
        return ctc2d_nll_markov_reference(emit_log_probs, trans_log_probs,
                                          init_height_log_probs, logit_lengths, labels,
                                          label_lengths, blank)
    return ctc2d_nll_markov_cuda(emit_log_probs, trans_log_probs, init_height_log_probs,
                                 logit_lengths, labels, label_lengths, blank)


def ctc2d_loss_markov(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                      init_height_log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                      labels: torch.Tensor, label_lengths: torch.Tensor, blank: int = 0,
                      reduction: str = "mean") -> torch.Tensor:
    """2D-CTC loss with a Markov height chain; ``reduction`` as in
    ``ops/ctc.py::ctc_loss``."""
    nll = ctc2d_nll_markov(emit_log_probs, trans_log_probs, init_height_log_probs,
                           logit_lengths, labels, label_lengths, blank)
    return _reduce(nll, label_lengths, reduction)


def ctc2d_greedy_decode(emit_log_probs: torch.Tensor, height_log_probs: torch.Tensor,
                        logit_lengths: torch.Tensor, blank: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Independent heights: each column's best height, the class argmax
    there, then CTC collapse -> (ids (B, T) int32, lengths (B,) int32)."""
    best_h = torch.argmax(height_log_probs, dim=2)  # (B, T)
    B, T, _, C = emit_log_probs.shape
    picked = emit_log_probs.gather(2, best_h.view(B, T, 1, 1).expand(B, T, 1, C))[:, :, 0]
    return ctc_greedy_decode(picked, logit_lengths, blank=blank)


def ctc2d_viterbi_height_decode(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                                init_height_log_probs: torch.Tensor,
                                logit_lengths: torch.Tensor, blank: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Markov heights: Viterbi over the height chain scored by each cell's
    best class, then greedy CTC along the chosen heights -> (ids (B, T)
    int32, lengths (B,) int32). Columns past a row's length keep its score
    frozen but are backtracked like the others, as in the JAX scan."""
    B, T, _, C = emit_log_probs.shape
    col_score = emit_log_probs.amax(3)  # (B, T, H)
    active = torch.arange(T, device=emit_log_probs.device).view(1, T) < \
        logit_lengths.to(emit_log_probs.device).view(B, 1)
    delta = init_height_log_probs + col_score[:, 0]
    backs = []
    for t in range(1, T):
        cand = delta.unsqueeze(2) + trans_log_probs[:, t]  # (B, Hprev, Hnew)
        backs.append(torch.argmax(cand, dim=1))
        delta = torch.where(active[:, t:t + 1], cand.amax(1) + col_score[:, t], delta)
    h = torch.argmax(delta, dim=1)  # (B,)
    heights = [h]
    for back in reversed(backs):
        h = back.gather(1, h.view(B, 1))[:, 0]
        heights.append(h)
    heights = torch.stack(heights[::-1], 1)  # (B, T)
    picked = emit_log_probs.gather(2, heights.view(B, T, 1, 1).expand(B, T, 1, C))[:, :, 0]
    return ctc_greedy_decode(picked, logit_lengths, blank=blank)
