"""LSTM sequence encoders with torch gate order [i, f, g, o].

Parameters are named ``w_ih`` (4H, D), ``w_hh`` (4H, H), ``b_ih``, ``b_hh``, as
in the JAX package, whose scan-based LSTM this time loop reproduces.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class LSTM(nn.Module):
    """Unidirectional LSTM over (B, T, D). ``reverse`` runs back-to-front and
    returns outputs in forward order (the backward half of a BiLSTM)."""

    def __init__(self, input_size: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        self.w_ih = nn.Parameter(torch.empty(4 * hidden, input_size))
        self.w_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.b_ih = nn.Parameter(torch.zeros(4 * hidden))
        self.b_hh = nn.Parameter(torch.zeros(4 * hidden))
        nn.init.xavier_uniform_(self.w_ih)
        nn.init.orthogonal_(self.w_hh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        # input projections of every step in one matmul; only h @ w_hh per step
        x_proj = x @ self.w_ih.T + self.b_ih + self.b_hh  # (B, T, 4H)
        w_hh_t = self.w_hh.T
        h = x.new_zeros(B, self.hidden)
        c = x.new_zeros(B, self.hidden)
        out = [None] * T
        for t in (range(T - 1, -1, -1) if self.reverse else range(T)):
            i, f, g, o = torch.addmm(x_proj[:, t], h, w_hh_t).chunk(4, 1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[t] = h
        return torch.stack(out, 1)


class BiLSTM(nn.Module):
    """Concat of forward and backward LSTMs: (B, T, D) -> (B, T, 2H)."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.fwd = LSTM(input_size, hidden, reverse=False)
        self.bwd = LSTM(input_size, hidden, reverse=True)

    def forward(self, x):
        return torch.cat([self.fwd(x), self.bwd(x)], -1)


class StackedBiLSTM(nn.Module):
    """``num_layers`` BiLSTMs, named layer0, layer1, ..."""

    def __init__(self, input_size: int, hidden: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", BiLSTM(input_size if i == 0 else 2 * hidden, hidden))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        return x
