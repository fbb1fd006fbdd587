"""LSTM sequence encoders with torch gate order [i, f, g, o].

Parameters are named ``w_ih`` (4H, D), ``w_hh`` (4H, H), ``b_ih``, ``b_hh``, as
in the JAX package, whose scan-based LSTM this time loop reproduces, with its
dtype rule: under a ``compute_dtype`` (mixed precision) the matmuls run in
that dtype and the gates and cell state in float32; without one the matmuls
promote their operands and the cell follows the input (so a bf16-cast serving
copy runs its whole loop in bf16).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.precision import op_dtype


class LSTM(nn.Module):
    """Unidirectional LSTM over (B, T, D). ``reverse`` runs back-to-front and
    returns outputs in forward order (the backward half of a BiLSTM)."""

    def __init__(self, input_size: int, hidden: int, reverse: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        self.compute_dtype = compute_dtype
        self.w_ih = nn.Parameter(torch.empty(4 * hidden, input_size))
        self.w_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.b_ih = nn.Parameter(torch.zeros(4 * hidden))
        self.b_hh = nn.Parameter(torch.zeros(4 * hidden))
        nn.init.xavier_uniform_(self.w_ih)
        nn.init.orthogonal_(self.w_hh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        mm = op_dtype(x, self.w_ih, dtype=self.compute_dtype)
        acc = x.dtype if self.compute_dtype is None else torch.float32
        x = x.to(mm)
        w_hh_t = (self.w_hh if self.compute_dtype is None else self.w_hh.to(mm)).T
        # input projections of every step in one matmul (biases added in
        # their own dtype); only h @ w_hh per step
        x_proj = (x @ self.w_ih.to(mm).T + self.b_ih + self.b_hh).to(acc)  # (B, T, 4H)
        h = x_proj.new_zeros(B, self.hidden)
        c = x_proj.new_zeros(B, self.hidden)
        out = [None] * T
        for t in (range(T - 1, -1, -1) if self.reverse else range(T)):
            if w_hh_t.dtype == acc:
                gates = torch.addmm(x_proj[:, t], h, w_hh_t)
            else:  # the bf16 product, added in float32 (torch promotes the sum)
                gates = x_proj[:, t] + h.to(w_hh_t.dtype) @ w_hh_t
            i, f, g, o = gates.chunk(4, 1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[t] = h
        return torch.stack(out, 1)


class BiLSTM(nn.Module):
    """Concat of forward and backward LSTMs: (B, T, D) -> (B, T, 2H)."""

    def __init__(self, input_size: int, hidden: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fwd = LSTM(input_size, hidden, reverse=False, compute_dtype=compute_dtype)
        self.bwd = LSTM(input_size, hidden, reverse=True, compute_dtype=compute_dtype)

    def forward(self, x):
        return torch.cat([self.fwd(x), self.bwd(x)], -1)


class StackedBiLSTM(nn.Module):
    """``num_layers`` BiLSTMs, named layer0, layer1, ..."""

    def __init__(self, input_size: int, hidden: int, num_layers: int = 2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", BiLSTM(input_size if i == 0 else 2 * hidden, hidden,
                                                compute_dtype))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        return x
