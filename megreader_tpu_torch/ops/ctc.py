"""CTC loss and greedy decoding.

``ctc_loss`` is the CTC negative log-likelihood from unnormalized logits
(B, T, C): ``log_softmax`` in torch, then the NLL, then the reduction. The NLL
follows the tensor's device: a CPU tensor runs the plain version
``ctc_nll_reference``, a time loop that autograd differentiates; any other
tensor goes through the hand-written CUDA kernels in ``csrc/ctc.cu``
(``ctc_nll_cuda``: the alpha kernel forward, the beta kernel backward).

Both keep the JAX package's sentinel arithmetic (``megreader_tpu/ops/ctc.py``):
unreachable states hold ``NEG_INF = -1e30``, a logsumexp whose maximum lies at
or below ``NEG_INF / 2`` gives ``NEG_INF``, alpha is frozen from
``t >= logit_length`` on, and the loss is read at the two terminal states. A
row with no alignment so has a finite loss of about 1e30, where
``torch.nn.functional.ctc_loss`` gives ``inf``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import kernels

NEG_INF = -1e30

#: dynamic shared memory a block may use without opting in
_SMEM_LIMIT = 48 * 1024


def _extend_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, L) -> blank-interleaved (B, 2L+1): [b, l1, b, l2, ..., b]."""
    B, L = labels.shape
    ext = labels.new_full((B, 2 * L + 1), blank)
    ext[:, 1::2] = labels
    return ext


def ctc_nll_reference(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                      labels: torch.Tensor, label_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """Plain CTC forward DP: (B, T, C) log-probs -> (B,) negative log-likelihood.

    A port of ``ctc_alpha_scan``; labels (B, L) are padded (masking is by
    ``label_lengths``). Differentiable by autograd through the time loop."""
    B, T, C = log_probs.shape
    S = 2 * labels.shape[1] + 1
    dev = log_probs.device
    labels = labels.long()
    label_lengths = label_lengths.long().to(dev)
    logit_lengths = logit_lengths.to(dev)
    ext = _extend_labels(labels, blank)
    ext_shift2 = F.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_shift2)
    s_idx = torch.arange(S, device=dev).view(1, S)
    valid_state = s_idx < 2 * label_lengths.view(B, 1) + 1

    emit = log_probs.gather(2, ext.view(B, 1, S).expand(B, T, S))  # (B, T, S)
    # t = 0: the first blank and the first label
    start = (s_idx == 0) | ((s_idx == 1) & (label_lengths > 0).view(B, 1))
    alpha = torch.where(start & valid_state, emit[:, 0], NEG_INF)

    for t in range(1, T):
        a_prev1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :S]
        a_prev2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=NEG_INF)[:, :S], NEG_INF)
        stacked = torch.stack([alpha, a_prev1, a_prev2])
        m = stacked.amax(0)
        summed = m + torch.log(torch.exp(stacked - m).sum(0))
        new = torch.where(m <= NEG_INF / 2, NEG_INF, summed) + emit[:, t]
        new = torch.where(valid_state, new, NEG_INF)
        alpha = torch.where((t < logit_lengths).view(B, 1), new, alpha)

    s_last = 2 * label_lengths
    a_last = alpha.gather(1, s_last.view(B, 1))[:, 0]
    a_prev = alpha.gather(1, (s_last - 1).clamp(min=0).view(B, 1))[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, NEG_INF)
    m = torch.maximum(a_last, a_prev)
    return -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))


def _check(log_probs, logit_lengths, labels, label_lengths, blank) -> None:
    if log_probs.device.type != "cuda":
        raise ValueError(f"the CTC kernels need a CUDA tensor, got {log_probs.device}")
    if log_probs.dtype != torch.float32 or log_probs.dim() != 3:
        raise TypeError(f"log_probs must be (B, T, C) float32, got "
                        f"{tuple(log_probs.shape)} {log_probs.dtype}")
    B, T, C = log_probs.shape
    if T < 1 or C < 1:
        raise ValueError(f"log_probs of shape {tuple(log_probs.shape)} has no step or class")
    if not 0 <= blank < C:
        raise ValueError(f"blank {blank} is not one of the {C} classes")
    for name, t, shape in (("logit_lengths", logit_lengths, (B,)),
                           ("labels", labels, (B, labels.shape[-1])),
                           ("label_lengths", label_lengths, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != log_probs.device:
            raise TypeError(f"{name} must be int32 of shape {shape} on {log_probs.device}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("log_probs", log_probs), ("logit_lengths", logit_lengths),
                    ("labels", labels), ("label_lengths", label_lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_limits(lib, L: int, C: int) -> None:
    S = 2 * L + 1
    if S > 1024:
        raise ValueError(f"S = 2L+1 = {S} extended states exceed one block of 1024 threads")
    fn = lib.mr_ctc_beta_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_size_t
    smem = fn(L, C)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"CTC beta kernel needs {smem} B of shared memory for L={L}, C={C} "
                         f"(limit {_SMEM_LIMIT})")


def ctc_alpha_cuda(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                   label_lengths: torch.Tensor, blank: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: -> (nll (B,), alpha (B, T, 2L+1))."""
    _check(log_probs, logit_lengths, labels, label_lengths, blank)
    B, T, C = log_probs.shape
    L = labels.shape[1]
    lib = kernels.library("ctc")
    _launch_limits(lib, L, C)
    nll = torch.empty((B,), dtype=torch.float32, device=log_probs.device)
    alpha = torch.empty((B, T, 2 * L + 1), dtype=torch.float32, device=log_probs.device)
    if B == 0:
        return nll, alpha
    fn = lib.mr_ctc_alpha_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(log_probs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(log_probs.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
                 label_lengths.data_ptr(), B, T, C, L, int(blank), alpha.data_ptr(),
                 nll.data_ptr(), stream)
    kernels.check(err, "ctc alpha kernel")
    ctc_alpha_cuda.launches += 1
    return nll, alpha


def ctc_beta_cuda(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, alpha: torch.Tensor, nll: torch.Tensor,
                  grad_nll: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Launch the backward kernel: -> d(grad_nll . nll) / d log_probs (B, T, C)."""
    _check(log_probs, logit_lengths, labels, label_lengths, blank)
    B, T, C = log_probs.shape
    L = labels.shape[1]
    for name, t, shape in (("alpha", alpha, (B, T, 2 * L + 1)), ("nll", nll, (B,)),
                           ("grad_nll", grad_nll, (B,))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != log_probs.device or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous float32 {shape} on {log_probs.device}")
    lib = kernels.library("ctc")
    _launch_limits(lib, L, C)
    grad = torch.empty_like(log_probs)
    if B == 0:
        return grad
    fn = lib.mr_ctc_beta_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    with torch.cuda.device(log_probs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(log_probs.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
                 label_lengths.data_ptr(), B, T, C, L, int(blank), alpha.data_ptr(),
                 nll.data_ptr(), grad_nll.data_ptr(), grad.data_ptr(), stream)
    kernels.check(err, "ctc beta kernel")
    ctc_beta_cuda.launches += 1
    return grad


#: kernel launches since the counts were last set to 0
ctc_alpha_cuda.launches = 0
ctc_beta_cuda.launches = 0


class _CtcNll(torch.autograd.Function):
    """Forward: the alpha kernel (alpha saved); backward: the beta kernel,
    scaled by the upstream gradient of each row."""

    @staticmethod
    def forward(ctx, log_probs, logit_lengths, labels, label_lengths, blank):
        nll, alpha = ctc_alpha_cuda(log_probs, logit_lengths, labels, label_lengths, blank)
        ctx.save_for_backward(log_probs, logit_lengths, labels, label_lengths, alpha, nll)
        ctx.blank = blank
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        log_probs, logit_lengths, labels, label_lengths, alpha, nll = ctx.saved_tensors
        grad = ctc_beta_cuda(log_probs, logit_lengths, labels, label_lengths, alpha, nll,
                             grad_nll.contiguous(), ctx.blank)
        return grad, None, None, None, None


def ctc_nll_cuda(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                 label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """(B,) NLL through the CUDA kernels, differentiable with respect to
    ``log_probs``. The counterpart of ``_ctc_nll_pallas``."""
    return _CtcNll.apply(log_probs, logit_lengths, labels, label_lengths, blank)


def ctc_nll(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
            label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """(B,) NLL: the plain version for a CPU tensor, else the CUDA kernels."""
    if log_probs.device.type == "cpu":
        return ctc_nll_reference(log_probs, logit_lengths, labels, label_lengths, blank)
    return ctc_nll_cuda(log_probs, logit_lengths, labels, label_lengths, blank)


def _reduce(nll: torch.Tensor, label_lengths: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return (nll / label_lengths.to(nll.device).clamp(min=1).to(nll.dtype)).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank: int = 0, reduction: str = "mean"
             ) -> torch.Tensor:
    """CTC loss from unnormalized logits (B, T, C). ``'mean'`` divides each
    row by ``max(label_length, 1)`` before the batch mean; also ``'sum'``,
    ``'none'``."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    nll = ctc_nll(log_probs, logit_lengths, labels, label_lengths, blank)
    return _reduce(nll, label_lengths, reduction)


def ctc_loss_reference(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                       label_lengths: torch.Tensor, blank: int = 0, reduction: str = "mean"
                       ) -> torch.Tensor:
    """``ctc_loss`` through the plain version on any device."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    nll = ctc_nll_reference(log_probs, logit_lengths, labels, label_lengths, blank)
    return _reduce(nll, label_lengths, reduction)


def ctc_greedy_decode(logits: torch.Tensor, logit_lengths: torch.Tensor,
                      blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy CTC decode: argmax -> collapse repeats -> strip blanks.

    logits (B, T, C); returns (ids (B, T) int32, left-packed and 0-padded,
    lengths (B,) int32)."""
    B, T, _ = logits.shape
    am = torch.argmax(logits, dim=-1)  # (B, T)
    t_idx = torch.arange(T, device=logits.device).view(1, T)
    in_range = t_idx < logit_lengths.view(B, 1).to(logits.device)
    prev = torch.cat([torch.full_like(am[:, :1], blank), am[:, :-1]], 1)
    keep = (am != blank) & (am != prev) & in_range
    pos = torch.cumsum(keep, 1) - 1
    lengths = keep.sum(1).to(torch.int32)
    slot = torch.where(keep, pos, T)  # discarded ids go to slot T
    out = torch.zeros((B, T + 1), dtype=torch.int32, device=logits.device)
    out.scatter_(1, slot, torch.where(keep, am, 0).to(torch.int32))
    return out[:, :T], lengths
