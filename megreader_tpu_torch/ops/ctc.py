"""CTC decoding."""

from __future__ import annotations

from typing import Tuple

import torch


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
