"""CTC loss and greedy decoding.

``ctc_loss`` is the CTC negative log-likelihood from unnormalized logits
(B, T, C): ``log_softmax`` in torch, then the NLL, then the reduction. The NLL
follows the tensor's device: a CPU tensor runs the plain version
``ctc_nll_reference``, a time loop that autograd differentiates; any other
tensor goes through the hand-written CUDA kernels in ``csrc/ctc.cu``
(``ctc_nll_cuda``: the alpha kernel forward, the beta kernel backward). Each
kernel's own arithmetic has a plain version beside it:
``ctc_alpha_reference`` (the NLL and every alpha plane) and
``ctc_beta_reference`` (the beta planes, then the gradient from alpha, beta
and logZ, without autograd).

Both keep the JAX package's sentinel arithmetic (``megreader_tpu/ops/ctc.py``):
unreachable states hold ``NEG_INF = -1e30``, a logsumexp whose maximum lies at
or below ``NEG_INF / 2`` gives ``NEG_INF``, alpha is frozen from
``t >= logit_length`` on, and the loss is read at the two terminal states. A
row with no alignment so has a finite loss of about 1e30, where
``torch.nn.functional.ctc_loss`` gives ``inf``, and its gradient is -1/2 at
the two terminal states' classes at the row's last step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import kernels

NEG_INF = -1e30


def _extend_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, L) -> blank-interleaved (B, 2L+1): [b, l1, b, l2, ..., b]."""
    B, L = labels.shape
    ext = labels.new_full((B, 2 * L + 1), blank)
    ext[:, 1::2] = labels
    return ext


def _states(labels: torch.Tensor, label_lengths: torch.Tensor, blank: int, dev):
    """(ext (B, S), can_skip (B, S): the s-2 -> s move is allowed, valid (B, S))."""
    B = labels.shape[0]
    S = 2 * labels.shape[1] + 1
    ext = _extend_labels(labels.long().to(dev), blank)
    ext_shift2 = F.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_shift2)
    valid = torch.arange(S, device=dev).view(1, S) < 2 * label_lengths.long().to(dev).view(B, 1) + 1
    return ext, can_skip, valid


def _label_move(x: torch.Tensor, can_skip: torch.Tensor, down: bool) -> torch.Tensor:
    """Guarded logsumexp along the last axis of x at s, s -/+ 1 and (where
    ``can_skip``) s -/+ 2: the label move down the states (alpha) or up them
    (beta); NEG_INF where the maximum lies at or below NEG_INF / 2."""
    S = x.shape[-1]
    if down:
        x1 = F.pad(x, (1, 0), value=NEG_INF)[..., :S]
        x2 = F.pad(x, (2, 0), value=NEG_INF)[..., :S]
    else:
        x1 = F.pad(x, (0, 1), value=NEG_INF)[..., 1:]
        x2 = F.pad(x, (0, 2), value=NEG_INF)[..., 2:]
    stacked = torch.stack([x, x1, torch.where(can_skip, x2, NEG_INF)])
    m = stacked.amax(0)
    return torch.where(m <= NEG_INF / 2, NEG_INF, m + torch.log(torch.exp(stacked - m).sum(0)))


def ctc_alpha_reference(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                        labels: torch.Tensor, label_lengths: torch.Tensor, blank: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain CTC forward DP -> (nll (B,), alpha (B, T, 2L+1)), the alpha
    kernel's outputs; differentiable by autograd through the time loop.

    A port of ``ctc_alpha_scan``: log-probs (B, T, C); labels (B, L) are
    padded (masking is by ``label_lengths``)."""
    B, T, C = log_probs.shape
    S = 2 * labels.shape[1] + 1
    dev = log_probs.device
    label_lengths = label_lengths.long().to(dev)
    logit_lengths = logit_lengths.to(dev)
    ext, can_skip, valid_state = _states(labels, label_lengths, blank, dev)
    s_idx = torch.arange(S, device=dev).view(1, S)

    emit = log_probs.gather(2, ext.view(B, 1, S).expand(B, T, S))  # (B, T, S)
    # t = 0: the first blank and the first label
    start = (s_idx == 0) | ((s_idx == 1) & (label_lengths > 0).view(B, 1))
    alpha = torch.where(start & valid_state, emit[:, 0], NEG_INF)
    planes = [alpha]
    for t in range(1, T):
        a_prev1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :S]
        a_prev2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=NEG_INF)[:, :S], NEG_INF)
        stacked = torch.stack([alpha, a_prev1, a_prev2])
        m = stacked.amax(0)
        summed = m + torch.log(torch.exp(stacked - m).sum(0))
        new = torch.where(m <= NEG_INF / 2, NEG_INF, summed) + emit[:, t]
        new = torch.where(valid_state, new, NEG_INF)
        alpha = torch.where((t < logit_lengths).view(B, 1), new, alpha)
        planes.append(alpha)

    s_last = 2 * label_lengths
    a_last = alpha.gather(1, s_last.view(B, 1))[:, 0]
    a_prev = alpha.gather(1, (s_last - 1).clamp(min=0).view(B, 1))[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, NEG_INF)
    m = torch.maximum(a_last, a_prev)
    nll = -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))
    return nll, torch.stack(planes, 1)


def ctc_nll_reference(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                      labels: torch.Tensor, label_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """Plain CTC forward DP: (B, T, C) log-probs -> (B,) negative
    log-likelihood, differentiable by autograd (arguments as
    ``ctc_alpha_reference``)."""
    return ctc_alpha_reference(log_probs, logit_lengths, labels, label_lengths, blank)[0]


def ctc_beta_reference(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                       labels: torch.Tensor, label_lengths: torch.Tensor, alpha: torch.Tensor,
                       nll: torch.Tensor, grad_nll: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """The beta kernel's arithmetic in plain PyTorch, without autograd ->
    d(grad_nll . nll) / d log_probs (B, T, C).

    Phase A, the chain: beta[t_last] is 0 on the terminal states; beta[t-1]
    is the guarded logsumexp of nx[s], nx[s+1] and (where the s -> s+2 move
    is allowed) nx[s+2], nx = beta[t] + emit[t] on valid states. As in the
    kernel, the recursion runs on beta less an offset kept in float64, the
    sum of the maxima of the values two steps back, so that its float32
    values stay near 0 however long the row. Phase B, with no serial
    dependency: grad[t, c] = -g * the occupancy exp(alpha + beta - logZ)
    (its exponent summed in float64) summed over the valid states of class
    c, in the kernel's order (the blank's even states first, then the label
    positions in order). Frozen steps get 0; a row with no alignment (loss
    about 1e30, or NaN for a bad label) gets the XLA scan's gradient: -1/2 of
    the row's upstream gradient at each of the two terminal states' classes
    at its last step (nothing when that step is t = 0), NaN on every live
    step for a bad label."""
    B, T, C = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    label_lengths = label_lengths.long().to(dev)
    t_last = logit_lengths.long().to(dev).clamp(1, T) - 1
    ext, can_skip, valid = _states(labels, label_lengths, blank, dev)
    cls = ext.clamp(0, C - 1)
    s_idx = torch.arange(S, device=dev).view(1, S)
    skip2 = F.pad(can_skip, (0, 2), value=False)[:, 2:]  # the s -> s+2 move
    emit = log_probs.gather(2, cls.view(B, 1, S).expand(B, T, S))  # (B, T, S)
    terminal = (s_idx == 2 * label_lengths.view(B, 1)) | (
        (label_lengths > 0).view(B, 1) & (s_idx == 2 * label_lengths.view(B, 1) - 1))
    start = torch.where(terminal, 0.0, NEG_INF).to(log_probs.dtype)

    # phase A: the mirrored recursion, every beta plane kept (less its offset)
    planes, offsets = [None] * T, [None] * T
    beta = start  # beta less off
    off = torch.zeros(B, dtype=torch.float64, device=dev)
    q_use = torch.zeros(B, dtype=log_probs.dtype, device=dev)  # subtracted at this step
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            live = (t < t_last).view(B, 1)
            q_new = beta.amax(1)
            nx = torch.where(valid, beta + (emit[:, t + 1] - q_use.view(B, 1)), NEG_INF)
            beta = torch.where(live, _label_move(nx, skip2, down=False), start)
            off = torch.where(live[:, 0], off + q_use, 0.0)
            q_use = torch.where(live[:, 0], q_new, 0.0)
        planes[t], offsets[t] = beta, off
    beta = torch.stack(planes, 1)  # (B, T, S)
    off = torch.stack(offsets, 1)  # (B, T)

    # phase B: the occupancies summed per class, all steps at once
    live = torch.arange(T, device=dev).view(1, T) <= t_last.view(B, 1)  # (B, T)
    exponent = (alpha.double() + beta.double() + (off + nll.double().view(B, 1)).view(B, T, 1)
                ).to(alpha.dtype)
    occ = torch.where(valid.view(B, 1, S) & live.view(B, T, 1), torch.exp(exponent), 0.0)
    per_class = torch.zeros_like(log_probs)
    per_class[:, :, blank] = occ[:, :, 0::2].sum(-1)
    per_class.scatter_add_(2, cls[:, 1::2].view(B, 1, L).expand(B, T, L), occ[:, :, 1::2])
    grad = -per_class * grad_nll.view(B, 1, 1)

    # rows with no alignment: the XLA scan's pattern, scaled by the row's
    # upstream gradient (NaN for a bad label)
    lz = -nll
    none = ~(lz > NEG_INF / 2)
    if bool(none.any()):
        gg = torch.where(torch.isnan(lz), lz, grad_nll)
        at_last = (torch.arange(T, device=dev).view(1, T) == t_last.view(B, 1)) & (
            t_last > 0).view(B, 1)  # (B, T)
        c_idx = torch.arange(C, device=dev).view(1, C)
        c_prev = labels.long().to(dev).gather(1, (label_lengths - 1).clamp(min=0).view(B, 1))
        c_prev = torch.where(label_lengths.view(B, 1) > 0, c_prev, -1)
        pattern = -0.5 * ((c_idx == blank).float() + (c_idx == c_prev).float())  # (B, C)
        pattern = torch.where(at_last.view(B, T, 1), pattern.view(B, 1, C), 0.0)
        pattern = torch.where(live.view(B, T, 1), pattern * gg.view(B, 1, 1), 0.0)
        grad = torch.where(none.view(B, 1, 1), pattern, grad)
    return grad


# The C launchers of csrc/ctc.cu, bound once (``kernels.functions``)
_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "mr_ctc_smem": ([_I] * 5, ctypes.c_size_t),
    "mr_ctc_max_states": ([], _I),
    "mr_ctc_alpha_launch": ([_P] * 4 + [_I] * 6 + [_P] * 3, _I),
    "mr_ctc_beta_launch": ([_P] * 4 + [_I] * 6 + [_P] * 6, _I),
}
_launch = kernels.launch


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CTC kernels need a CUDA tensor, got {t.device}")


def _check(log_probs, logit_lengths, labels, label_lengths, blank) -> None:
    """Raise unless the kernels take these tensors (device type checked apart)."""
    if log_probs.dtype != torch.float32 or log_probs.dim() != 3:
        raise TypeError(f"log_probs must be (B, T, C) float32, got "
                        f"{tuple(log_probs.shape)} {log_probs.dtype}")
    B, T, C = log_probs.shape
    if T < 1 or C < 1:
        raise ValueError(f"log_probs of shape {tuple(log_probs.shape)} has no step or class")
    if not 0 <= blank < C:
        raise ValueError(f"blank {blank} is not one of the {C} classes")
    dev = log_probs.device
    for name, t, shape in (("logit_lengths", logit_lengths, (B,)),
                           ("labels", labels, (B, labels.shape[-1])),
                           ("label_lengths", label_lengths, (B,))):
        if t.dtype != torch.int32 or t.shape != shape or t.device != dev:
            raise TypeError(f"{name} must be int32 of shape {shape} on {dev}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("log_probs", log_probs), ("logit_lengths", logit_lengths),
                    ("labels", labels), ("label_lengths", label_lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=64)
def _plan(T: int, L: int, C: int) -> Tuple[bool, bool]:
    """Whether the (alpha, beta) kernels keep their planes in shared memory
    at this shape (else in device memory), after checking the launchers'
    limits; raises beyond them (nothing is cached then, so every call
    raises)."""
    fns = kernels.functions("ctc", _PROTOTYPES)
    max_states = fns["mr_ctc_max_states"]()
    if 2 * L + 1 > max_states:
        raise ValueError(f"the CTC kernels take at most {max_states} states S = 2L+1, "
                         f"got {2 * L + 1} (L = {L})")
    smem = fns["mr_ctc_smem"]
    need = (smem(0, 0, T, L, C), smem(1, 0, T, L, C))
    if max(need) > kernels.SMEM_LIMIT:
        raise ValueError(f"the CTC kernels need {need} B of shared memory for T={T}, L={L}, "
                         f"C={C} (limit {kernels.SMEM_LIMIT})")
    return smem(0, 1, T, L, C) <= kernels.SMEM_LIMIT, smem(1, 1, T, L, C) <= kernels.SMEM_LIMIT


def ctc_alpha_cuda(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                   label_lengths: torch.Tensor, blank: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: -> (nll (B,), alpha (B, T, 2L+1))."""
    _require_cuda(log_probs)
    _check(log_probs, logit_lengths, labels, label_lengths, blank)
    B, T, C = log_probs.shape
    L = labels.shape[1]
    shared = _plan(T, L, C)[0]
    dev = log_probs.device
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    alpha = torch.empty((B, T, 2 * L + 1), dtype=torch.float32, device=dev)
    if B == 0:
        return nll, alpha
    fn = kernels.functions("ctc", _PROTOTYPES)["mr_ctc_alpha_launch"]
    err = _launch(fn, dev, log_probs.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
                  label_lengths.data_ptr(), B, T, C, L, int(blank), int(shared),
                  alpha.data_ptr(), nll.data_ptr())
    kernels.check(err, "ctc alpha kernel")
    ctc_alpha_cuda.launches += 1
    return nll, alpha


def ctc_beta_cuda(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, alpha: torch.Tensor, nll: torch.Tensor,
                  grad_nll: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Launch the backward kernel: -> d(grad_nll . nll) / d log_probs (B, T, C).
    Where its planes do not fit in shared memory, the beta planes go to a
    (B, T, 2L+1) scratch buffer allocated here."""
    _require_cuda(log_probs)
    _check(log_probs, logit_lengths, labels, label_lengths, blank)
    B, T, C = log_probs.shape
    L = labels.shape[1]
    dev = log_probs.device
    for name, t, shape in (("alpha", alpha, (B, T, 2 * L + 1)), ("nll", nll, (B,)),
                           ("grad_nll", grad_nll, (B,))):
        if (t.dtype != torch.float32 or t.shape != shape or t.device != dev
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous float32 {shape} on {dev}")
    shared = _plan(T, L, C)[1]
    grad = torch.empty_like(log_probs)
    if B == 0:
        return grad
    scratch = None if shared else torch.empty_like(alpha)
    fn = kernels.functions("ctc", _PROTOTYPES)["mr_ctc_beta_launch"]
    err = _launch(fn, dev, log_probs.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
                  label_lengths.data_ptr(), B, T, C, L, int(blank), int(shared),
                  alpha.data_ptr(), nll.data_ptr(), grad_nll.data_ptr(), grad.data_ptr(),
                  None if scratch is None else scratch.data_ptr())
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
