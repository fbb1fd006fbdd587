"""CTC loss, greedy decoding and prefix beam search.

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

``ctc_beam_decode`` (with ``blank_collapse_frames``) is PyTorch code on
either device, as its JAX counterpart is jnp: the same sentinel, wrapping
int32 prefix hashes and lower-index-first tie order, so that the same logits
give the same ids.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from ..parallel.mesh import batch_mean, batch_sum

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
        return batch_sum(nll.sum())
    if reduction == "mean":
        return batch_mean(nll / label_lengths.to(nll.device).clamp(min=1).to(nll.dtype))
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


# --------------------------------------------------------------------------
# CTC prefix beam search (fixed width), a port of the JAX package's
# ``ctc_beam_decode``: the same candidates, hashes, sentinel and tie order, so
# the same logits give the same best prefix.
# --------------------------------------------------------------------------

#: rolling-hash multipliers of a prefix's identity, in wrapping int32 arithmetic
H1, H2 = 1000003, 1000033


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to signed 32 bits (int32 overflow, made explicit)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b), NEG_INF where the larger lies at or below NEG_INF / 2."""
    m = torch.maximum(a, b)
    return torch.where(m <= NEG_INF / 2, NEG_INF,
                       m + torch.log(torch.exp(a - m) + torch.exp(b - m)))


def _logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis as ``jax.nn.logsumexp`` computes it (the
    maximum added after the log); the entries here are finite."""
    m = x.amax(-1)
    return torch.log(torch.exp(x - m.unsqueeze(-1)).sum(-1)) + m


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, lower index first among equal
    values (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def blank_collapse_frames(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                          blank: int = 0, threshold: float = 0.999
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Drop blank-dominated frames before the beam (Lee et al. 2022,
    arXiv:2210.17017).

    A frame whose blank log-prob is at least log(``threshold``) only extends
    every beam with blank; a run of such frames folds into one update with the
    run's summed blank log-prob, applied before the next kept frame.

    Returns (the kept frames' log-probs (B, T, C), left-packed and zero after
    them, kept lengths (B,) int32, pre_blank (B, T): the summed blank log-prob
    of the run before each kept frame, NEG_INF where the frame before was
    kept)."""
    B, T, C = log_probs.shape
    dev = log_probs.device
    lengths = logit_lengths.to(dev).long().view(B, 1)
    in_range = torch.arange(T, device=dev).view(1, T) < lengths
    log_thresh = torch.log(torch.tensor(threshold, dtype=log_probs.dtype, device=dev))
    dom = (log_probs[:, :, blank] >= log_thresh) & in_range
    keep = ~dom & in_range
    lp_blank = torch.where(dom, log_probs[:, :, blank], 0.0)
    # the summed blank log-prob of the dominated run that ends at each frame
    run = log_probs.new_zeros(B)
    runs = []
    for t in range(T):
        run = torch.where(dom[:, t], run + lp_blank[:, t], 0.0)
        runs.append(run)
    run_sums = torch.stack(runs, 1)
    prev_dom = F.pad(dom, (1, 0))[:, :T]
    prev_run = F.pad(run_sums, (1, 0))[:, :T]
    pre = torch.where(prev_dom, prev_run, NEG_INF)
    pos = torch.cumsum(keep, 1) - 1
    kept = keep.sum(1).to(torch.int32)
    slot = torch.where(keep, pos, T)  # dropped frames go to slot T
    out = log_probs.new_zeros((B, T + 1, C))
    out.scatter_(1, slot.unsqueeze(-1).expand(B, T, C), log_probs)
    pre_out = log_probs.new_full((B, T + 1), NEG_INF)
    pre_out.scatter_(1, slot, pre)
    return out[:, :T], kept, pre_out[:, :T]


def ctc_beam_decode(logits: torch.Tensor, logit_lengths: torch.Tensor, beam_width: int = 8,
                    blank: int = 0, blank_collapse: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search of fixed width W.

    Per beam: the prefix (a (T,) buffer), its length, the log-probs p_b (paths
    ending in blank) and p_nb (ending in the last symbol), its last symbol and
    two rolling hashes. Each frame builds W stay candidates (blank, or the
    last symbol repeated) and W*C extend candidates, keeps the best 4W, merges
    those with equal (hash 1, hash 2, length) into the first of them (an
    O(P^2) masked fold), and keeps the best W. The loop runs to the batch's
    longest length, read from the host once; a row past its own length is
    frozen. ``blank_collapse`` < 1 first drops the frames whose blank
    probability exceeds it (``blank_collapse_frames``); 1.0 is the exact
    beam over every frame.

    logits (B, T, C) -> (ids (B, T) int32, lengths (B,) int32) of the best beam."""
    B, T, C = logits.shape
    W = beam_width
    dev = logits.device
    log_probs = torch.log_softmax(logits, -1)
    if blank_collapse < 1.0:
        log_probs, logit_lengths, pre_blank = blank_collapse_frames(
            log_probs, logit_lengths, blank, blank_collapse)
    else:
        pre_blank = None
    lengths = logit_lengths.to(dev).long()
    max_t = int(lengths.max()) if B else 0

    prefixes = torch.zeros((B, W, T), dtype=torch.int64, device=dev)
    lens = torch.zeros((B, W), dtype=torch.int64, device=dev)
    p_b = log_probs.new_full((B, W), NEG_INF)
    p_b[:, 0] = 0.0
    p_nb = log_probs.new_full((B, W), NEG_INF)
    h1 = torch.zeros((B, W), dtype=torch.int64, device=dev)
    h2 = torch.zeros_like(h1)
    last = torch.full((B, W), -1, dtype=torch.int64, device=dev)

    P = 4 * W
    classes = torch.arange(C, device=dev)
    fold = torch.ones((P, P), dtype=torch.bool, device=dev).triu()  # j >= i
    earlier = torch.ones((P, P), dtype=torch.bool, device=dev).tril(-1)  # j < i

    for t in range(max_t):
        lp = log_probs[:, t]  # (B, C)
        if pre_blank is not None:  # the collapsed blank run before this frame
            run = pre_blank[:, t].unsqueeze(1)
            has_run = run > NEG_INF / 2
            p_b = torch.where(has_run, _logaddexp(p_b, p_nb) + run, p_b)
            p_nb = torch.where(has_run, NEG_INF, p_nb)
        p_tot = _logaddexp(p_b, p_nb)
        # stay: blank extends the prefix's every path; the last symbol
        # repeated extends its paths that end in that symbol
        stay_pb = p_tot + lp[:, blank].unsqueeze(1)
        lp_last = torch.gather(lp, 1, last.clamp(0, C - 1))
        stay_pnb = torch.where(last >= 0, p_nb + lp_last, NEG_INF)
        # extend by class c: only blank-ending paths where c repeats the last
        ext_base = torch.where(classes.view(1, 1, C) == last.unsqueeze(-1),
                               p_b.unsqueeze(-1), p_tot.unsqueeze(-1))
        ext_pnb = ext_base + lp.unsqueeze(1)
        ext_pnb[:, :, blank] = NEG_INF
        ext_flat = ext_pnb.reshape(B, W * C)
        pool = torch.cat([_logaddexp(stay_pb, stay_pnb), ext_flat], 1)

        _, top_idx = stable_top_k(pool, P)  # (B, P)
        is_stay = top_idx < W
        ext_i = (top_idx - W).clamp(0, W * C - 1)
        ext_c = ext_i % C
        src = torch.where(is_stay, top_idx.clamp(0, W - 1), ext_i // C)
        s_h1, s_h2 = torch.gather(h1, 1, src), torch.gather(h2, 1, src)
        s_len = torch.gather(lens, 1, src)
        n_h1 = torch.where(is_stay, s_h1, _wrap_int32(s_h1 * H1 + ext_c + 1))
        n_h2 = torch.where(is_stay, s_h2, _wrap_int32(s_h2 * H2 + ext_c + 1))
        n_len = torch.where(is_stay, s_len, s_len + 1)
        n_last = torch.where(is_stay, torch.gather(last, 1, src), ext_c)
        n_pb = torch.where(is_stay, torch.gather(stay_pb, 1, src), NEG_INF)
        n_pnb = torch.where(is_stay, torch.gather(stay_pnb, 1, src),
                            torch.gather(ext_flat, 1, ext_i))

        # equal prefixes: fold the mass of each into its first occurrence
        same = ((n_h1.unsqueeze(2) == n_h1.unsqueeze(1))
                & (n_h2.unsqueeze(2) == n_h2.unsqueeze(1))
                & (n_len.unsqueeze(2) == n_len.unsqueeze(1)))  # (B, P, P)
        dup = (same & earlier).any(2)
        mask = same & fold
        n_pb = _logsumexp_last(torch.where(mask, n_pb.unsqueeze(1), NEG_INF))
        n_pnb = _logsumexp_last(torch.where(mask, n_pnb.unsqueeze(1), NEG_INF))
        score = torch.where(dup, NEG_INF, _logaddexp(n_pb, n_pnb))

        _, best = stable_top_k(score, W)  # (B, W)
        f_src = torch.gather(src, 1, best)
        f_len = torch.gather(n_len, 1, best)
        f_stay = torch.gather(is_stay, 1, best)
        f_c = torch.gather(torch.where(is_stay, -1, ext_c), 1, best)
        new_prefix = torch.gather(prefixes, 1, f_src.unsqueeze(-1).expand(B, W, T)).clone()
        appended = new_prefix.scatter(2, (f_len - 1).clamp(0, T - 1).unsqueeze(-1),
                                      f_c.clamp(min=0).unsqueeze(-1))
        new_prefix = torch.where(f_stay.unsqueeze(-1), new_prefix, appended)

        active = (t < lengths).unsqueeze(1)  # rows past their length stay frozen
        prefixes = torch.where(active.unsqueeze(-1), new_prefix, prefixes)
        lens = torch.where(active, f_len, lens)
        p_b = torch.where(active, torch.gather(n_pb, 1, best), p_b)
        p_nb = torch.where(active, torch.gather(n_pnb, 1, best), p_nb)
        h1 = torch.where(active, torch.gather(n_h1, 1, best), h1)
        h2 = torch.where(active, torch.gather(n_h2, 1, best), h2)
        last = torch.where(active, torch.gather(n_last, 1, best), last)

    top = torch.argmax(_logaddexp(p_b, p_nb), 1)  # the first best
    ids = torch.gather(prefixes, 1, top.view(B, 1, 1).expand(B, 1, T))[:, 0]
    out_len = torch.gather(lens, 1, top.view(B, 1))[:, 0]
    return ids.to(torch.int32), out_len.to(torch.int32)
