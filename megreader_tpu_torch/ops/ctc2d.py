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
initial heights). Each kernel's own arithmetic has a plain version beside
it: ``ctc2d_alpha_reference`` (the NLL and every alpha plane) and
``ctc2d_beta_reference`` (the beta planes, then the gradients from alpha,
beta and logZ, without autograd).

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
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from .ctc import NEG_INF, _label_move, _reduce, _states, ctc_greedy_decode, ctc_nll


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


def ctc2d_alpha_reference(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                          init_height_log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                          labels: torch.Tensor, label_lengths: torch.Tensor, blank: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain Markov 2D-CTC forward DP -> (nll (B,), alpha (B, T, H, 2L+1)),
    the alpha kernel's outputs; differentiable by autograd.

    emit (B, T, H, C) log P(c | t, h); trans (B, T, H, H) log A_t with rows
    h_prev and columns h, entry t used on the move into column t (t >= 1);
    init (B, H); labels (B, L) padded, masked by ``label_lengths``."""
    B, T, H, C = emit_log_probs.shape
    S = 2 * labels.shape[1] + 1
    dev = emit_log_probs.device
    label_lengths = label_lengths.long().to(dev)
    logit_lengths = logit_lengths.to(dev)
    ext, can_skip, valid = _states(labels, label_lengths, blank, dev)
    can_skip, valid = can_skip.view(B, 1, S), valid.view(B, 1, S)
    s_idx = torch.arange(S, device=dev).view(1, S)
    emit = emit_log_probs.gather(3, ext.view(B, 1, 1, S).expand(B, T, H, S))  # (B, T, H, S)

    # t = 0: the first blank and the first label, at every height
    start = ((s_idx == 0) | ((s_idx == 1) & (label_lengths > 0).view(B, 1))).view(B, 1, S)
    alpha = torch.where(start & valid, init_height_log_probs.unsqueeze(-1) + emit[:, 0], NEG_INF)
    planes = [alpha]
    for t in range(1, T):
        # 1) label moves in each height plane (guarded logsumexp)
        lbl = _label_move(alpha, can_skip, down=True)
        # 2) height move: logsumexp over h_prev of lbl[h_prev] + A_t[h_prev, h]
        moved = _logsumexp(lbl.unsqueeze(2) + trans_log_probs[:, t].unsqueeze(-1), 1)
        new = torch.where(valid, moved + emit[:, t], NEG_INF)
        alpha = torch.where((t < logit_lengths).view(B, 1, 1), new, alpha)
        planes.append(alpha)

    # marginalize heights, then read the terminal states
    alpha_s = _logsumexp(alpha, 1)  # (B, S)
    s_last = 2 * label_lengths
    a_last = alpha_s.gather(1, s_last.view(B, 1))[:, 0]
    a_prev = alpha_s.gather(1, (s_last - 1).clamp(min=0).view(B, 1))[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, NEG_INF)
    m = torch.maximum(a_last, a_prev)
    return -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m))), torch.stack(planes, 1)


def ctc2d_nll_markov_reference(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                               init_height_log_probs: torch.Tensor,
                               logit_lengths: torch.Tensor, labels: torch.Tensor,
                               label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Plain Markov 2D-CTC forward DP -> (B,) NLL; differentiable by autograd
    (arguments as ``ctc2d_alpha_reference``)."""
    return ctc2d_alpha_reference(emit_log_probs, trans_log_probs, init_height_log_probs,
                                 logit_lengths, labels, label_lengths, blank)[0]


def ctc2d_beta_reference(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                         logit_lengths: torch.Tensor, labels: torch.Tensor,
                         label_lengths: torch.Tensor, alpha: torch.Tensor, nll: torch.Tensor,
                         grad_nll: torch.Tensor, blank: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The beta kernel's arithmetic in plain PyTorch, without autograd ->
    d(grad_nll . nll) / d (emit (B, T, H, C), trans (B, T, H, H), init (B, H)).

    Phase A, the chain: beta[t_last] is 0 on the terminal states; beta[t-1]
    is the guarded logsumexp over h'' of mv[h''] + A_t[h, h''], mv the
    backward label move of beta[t] + emit[t] on valid states. Phase B, with
    no serial dependency: the occupancy exp(alpha + beta - logZ) summed per
    class, and the transition terms exp(lblmove(alpha[t-1])[h'] + A_t[h', h]
    + emit[t, h] + beta[t, h] - logZ) summed over states. Frozen steps and
    ``trans[:, 0]`` get 0; a row with no alignment (loss about 1e30, or NaN
    for a bad label) gets the XLA scan's gradient (see the module's notes)."""
    B, T, H, C = emit_log_probs.shape
    S = 2 * labels.shape[1] + 1
    dev = emit_log_probs.device
    label_lengths = label_lengths.long().to(dev)
    t_last = logit_lengths.long().to(dev).clamp(1, T) - 1
    ext, can_skip, valid = _states(labels, label_lengths, blank, dev)
    cls = ext.clamp(0, C - 1)
    s_idx = torch.arange(S, device=dev).view(1, S)
    skip2 = F.pad(can_skip, (0, 2), value=False)[:, 2:].view(B, 1, S)  # the s -> s+2 move
    valid3 = valid.view(B, 1, S)
    emit = emit_log_probs.gather(3, cls.view(B, 1, 1, S).expand(B, T, H, S))  # (B, T, H, S)
    terminal = (s_idx == 2 * label_lengths.view(B, 1)) | (
        (label_lengths > 0).view(B, 1) & (s_idx == 2 * label_lengths.view(B, 1) - 1))
    start = torch.where(terminal, 0.0, NEG_INF).view(B, 1, S).expand(B, H, S)

    # phase A: the mirrored recursion, every beta plane kept
    planes = [None] * T
    beta = start
    for t in range(T - 1, -1, -1):
        if t < T - 1:
            nx = torch.where(valid3, beta + emit[:, t + 1], NEG_INF)
            mv = _label_move(nx, skip2, down=False)
            x = mv.unsqueeze(1) + trans_log_probs[:, t + 1].unsqueeze(-1)  # (B, H, H'', S)
            m = x.amax(2)
            stepped = torch.where(m <= NEG_INF / 2, NEG_INF,
                                  m + torch.log(torch.exp(x - m.unsqueeze(2)).sum(2)))
            beta = torch.where((t < t_last).view(B, 1, 1), stepped, start)
        planes[t] = beta
    beta = torch.stack(planes, 1)  # (B, T, H, S)

    # phase B: occupancies and transition terms, all steps at once
    logz = -nll.view(B, 1, 1, 1)
    g = grad_nll.view(B, 1, 1)
    live = torch.arange(T, device=dev).view(1, T) <= t_last.view(B, 1)  # (B, T)
    occ = torch.where(valid.view(B, 1, 1, S) & live.view(B, T, 1, 1),
                      torch.exp(alpha + beta - logz), 0.0)
    grad_emit = torch.zeros_like(emit_log_probs).scatter_add_(
        3, cls.view(B, 1, 1, S).expand(B, T, H, S), occ)
    grad_emit = -grad_emit * g.view(B, 1, 1, 1)
    lm = _label_move(alpha[:, :-1], can_skip.view(B, 1, 1, S), down=True)  # (B, T-1, H', S)
    nx = beta[:, 1:] + emit[:, 1:]  # (B, T-1, H, S)
    terms = torch.exp(lm.unsqueeze(3) + trans_log_probs[:, 1:].unsqueeze(-1)
                      + nx.unsqueeze(2) - logz.unsqueeze(-1))  # (B, T-1, H', H, S)
    terms = torch.where(valid.view(B, 1, 1, 1, S) & live[:, 1:].view(B, T - 1, 1, 1, 1),
                        terms, 0.0)
    grad_trans = torch.zeros_like(trans_log_probs)
    grad_trans[:, 1:] = -terms.sum(-1) * g.view(B, 1, 1, 1)

    # rows with no alignment: the XLA scan's pattern, scaled by the row's
    # upstream gradient (NaN for a bad label)
    lz = -nll
    none = ~(lz > NEG_INF / 2)
    if bool(none.any()):
        gg = torch.where(torch.isnan(lz), lz, grad_nll)
        w = 0.5 / H
        at_last = (torch.arange(T, device=dev).view(1, T) == t_last.view(B, 1)) & (
            t_last > 0).view(B, 1)  # (B, T)
        c_idx = torch.arange(C, device=dev).view(1, C)
        c_prev = labels.long().to(dev).gather(
            1, (label_lengths - 1).clamp(min=0).view(B, 1))
        c_prev = torch.where(label_lengths.view(B, 1) > 0, c_prev, -1)
        per_class = -w * ((c_idx == blank).float() + (c_idx == c_prev).float())  # (B, C)
        pe = torch.where(at_last.view(B, T, 1, 1), per_class.view(B, 1, 1, C), 0.0)
        pe = torch.where(live.view(B, T, 1, 1), pe * gg.view(B, 1, 1, 1), 0.0)
        per_trans = -torch.where(label_lengths > 0, 2.0, 1.0) * w / H  # (B,)
        pt = torch.where(at_last.view(B, T, 1, 1), per_trans.view(B, 1, 1, 1), 0.0)
        pt = torch.where(live.view(B, T, 1, 1), pt * gg.view(B, 1, 1, 1), 0.0)
        pt[:, 0] = 0.0
        grad_emit = torch.where(none.view(B, 1, 1, 1), pe, grad_emit)
        grad_trans = torch.where(none.view(B, 1, 1, 1), pt, grad_trans)
    return grad_emit, grad_trans, grad_emit[:, 0].sum(-1)


_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    "mr_ctc2d_smem": ([_I] * 5, ctypes.c_size_t),
    "mr_ctc2d_max_heights": ([], _I),
    "mr_ctc2d_max_states": ([], _I),
    "mr_ctc2d_alpha_launch": ([_P] * 6 + [_I] * 6 + [_P] * 3, _I),
    "mr_ctc2d_beta_launch": ([_P] * 5 + [_I] * 6 + [_P] * 7, _I),
}
_launch = kernels.launch


def _check(emit, trans, init, logit_lengths, labels, label_lengths, blank) -> None:
    """Raise unless the kernels take these tensors (device checked apart)."""
    if emit.dtype != torch.float32 or emit.dim() != 4:
        raise TypeError(f"emit_log_probs must be (B, T, H, C) float32, got "
                        f"{tuple(emit.shape)} {emit.dtype}")
    B, T, H, C = emit.shape
    if T < 1 or H < 1 or C < 1:
        raise ValueError(f"emit_log_probs of shape {tuple(emit.shape)} is empty")
    if not 0 <= blank < C:
        raise ValueError(f"blank {blank} is not one of the {C} classes")
    dev = emit.device
    for name, t, shape in (("trans_log_probs", trans, (B, T, H, H)),
                           ("init_height_log_probs", init, (B, H))):
        if t is not None and (t.dtype != torch.float32 or t.shape != shape or t.device != dev):
            raise TypeError(f"{name} must be float32 of shape {shape} on {dev}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t, shape in (("logit_lengths", logit_lengths, (B,)),
                           ("labels", labels, (B, labels.shape[-1])),
                           ("label_lengths", label_lengths, (B,))):
        if t.dtype != torch.int32 or t.shape != shape or t.device != dev:
            raise TypeError(f"{name} must be int32 of shape {shape} on {dev}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("emit_log_probs", emit), ("trans_log_probs", trans),
                    ("init_height_log_probs", init), ("logit_lengths", logit_lengths),
                    ("labels", labels), ("label_lengths", label_lengths)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the 2D-CTC kernels need a CUDA tensor, got {t.device}")


@functools.lru_cache(maxsize=64)
def _shared_bytes(T: int, H: int, L: int, C: int) -> Tuple[int, int]:
    """Dynamic shared memory of the (alpha, beta) kernels at this shape, after
    checking the launchers' limits; raises beyond them (nothing is cached
    then, so every call raises)."""
    fns = kernels.functions("ctc2d", _PROTOTYPES)
    max_h, max_states = fns["mr_ctc2d_max_heights"](), fns["mr_ctc2d_max_states"]()
    if H > max_h:
        raise ValueError(f"the 2D-CTC kernels take at most {max_h} heights, got {H}")
    if 2 * L + 1 > max_states:
        raise ValueError(f"the 2D-CTC kernels take at most {max_states} states S = 2L+1, "
                         f"got {2 * L + 1} (L = {L})")
    smem = fns["mr_ctc2d_smem"]
    need = (smem(0, T, H, L, C), smem(1, T, H, L, C))
    if max(need) > kernels.SMEM_LIMIT:
        raise ValueError(f"the 2D-CTC kernels need {need} B of shared memory for T={T}, H={H}, "
                         f"L={L}, C={C} (limit {kernels.SMEM_LIMIT})")
    return need


def ctc2d_alpha_cuda(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                     init_height_log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                     labels: torch.Tensor, label_lengths: torch.Tensor, blank: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: -> (nll (B,), alpha (B, T, H, 2L+1))."""
    _require_cuda(emit_log_probs)
    _check(emit_log_probs, trans_log_probs, init_height_log_probs, logit_lengths, labels,
           label_lengths, blank)
    B, T, H, C = emit_log_probs.shape
    L = labels.shape[1]
    _shared_bytes(T, H, L, C)
    dev = emit_log_probs.device
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    alpha = torch.empty((B, T, H, 2 * L + 1), dtype=torch.float32, device=dev)
    if B == 0:
        return nll, alpha
    fn = kernels.functions("ctc2d", _PROTOTYPES)["mr_ctc2d_alpha_launch"]
    err = _launch(fn, dev, emit_log_probs.data_ptr(), trans_log_probs.data_ptr(),
                  init_height_log_probs.data_ptr(), logit_lengths.data_ptr(), labels.data_ptr(),
                  label_lengths.data_ptr(), B, T, H, C, L, int(blank), alpha.data_ptr(),
                  nll.data_ptr())
    kernels.check(err, "ctc2d alpha kernel")
    ctc2d_alpha_cuda.launches += 1
    return nll, alpha


def ctc2d_beta_cuda(emit_log_probs: torch.Tensor, trans_log_probs: torch.Tensor,
                    logit_lengths: torch.Tensor, labels: torch.Tensor,
                    label_lengths: torch.Tensor, alpha: torch.Tensor, nll: torch.Tensor,
                    grad_nll: torch.Tensor, blank: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: -> d(grad_nll . nll) / d emit (B, T, H, C),
    / d trans (B, T, H, H) and / d init (B, H)."""
    _require_cuda(emit_log_probs)
    _check(emit_log_probs, trans_log_probs, None, logit_lengths, labels, label_lengths, blank)
    B, T, H, C = emit_log_probs.shape
    L = labels.shape[1]
    dev = emit_log_probs.device
    for name, t, shape in (("alpha", alpha, (B, T, H, 2 * L + 1)), ("nll", nll, (B,)),
                           ("grad_nll", grad_nll, (B,))):
        if (t.dtype != torch.float32 or t.shape != shape or t.device != dev
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous float32 {shape} on {dev}")
    _shared_bytes(T, H, L, C)
    grad_emit = torch.empty_like(emit_log_probs)
    grad_trans = torch.empty_like(trans_log_probs)
    grad_init = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B == 0:
        return grad_emit, grad_trans, grad_init
    fn = kernels.functions("ctc2d", _PROTOTYPES)["mr_ctc2d_beta_launch"]
    err = _launch(fn, dev, emit_log_probs.data_ptr(), trans_log_probs.data_ptr(),
                  logit_lengths.data_ptr(), labels.data_ptr(), label_lengths.data_ptr(), B, T, H,
                  C, L, int(blank), alpha.data_ptr(), nll.data_ptr(), grad_nll.data_ptr(),
                  grad_emit.data_ptr(), grad_trans.data_ptr(), grad_init.data_ptr())
    kernels.check(err, "ctc2d beta kernel")
    ctc2d_beta_cuda.launches += 1
    return grad_emit, grad_trans, grad_init


#: kernel launches since the counts were last set to 0
ctc2d_alpha_cuda.launches = 0
ctc2d_beta_cuda.launches = 0


class _Ctc2dNll(torch.autograd.Function):
    """Forward: the alpha kernel (alpha saved); backward: the beta kernel,
    scaled by the upstream gradient of each row, which also gives the
    initial heights' gradient."""

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
        grad_emit, grad_trans, grad_init = ctc2d_beta_cuda(
            emit, trans, logit_lengths, labels, label_lengths, alpha, nll,
            grad_nll.contiguous(), ctx.blank)
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
