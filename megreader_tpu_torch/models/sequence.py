"""Sequence encoders: LSTMs with torch gate order [i, f, g, o], and a pre-LN
transformer encoder.

Parameters are named ``w_ih`` (4H, D), ``w_hh`` (4H, H), ``b_ih``, ``b_hh``, as
in the JAX package, whose scan-based LSTM this time loop reproduces, with its
dtype rule: under a ``compute_dtype`` (mixed precision) the matmuls run in
that dtype and the gates and cell state in float32; without one the matmuls
promote their operands and the cell follows the input (so a bf16-cast serving
copy runs its whole loop in bf16).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.precision import Linear, op_dtype


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


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm``: epsilon 1e-6, statistics in at least float32
    as E[x²] - E[x]² (clipped at 0), ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in the statistics' dtype, the result in the promoted dtype
    of the input and the parameters. Parameters ``weight`` / ``bias`` are
    flax's ``scale`` / ``bias``."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(st)
        mean = xs.mean(-1, keepdim=True)
        var = torch.clamp((xs * xs).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xs - mean) * (torch.rsqrt(var + self.eps) * self.weight.to(st)) + self.bias.to(st)
        return y.to(op_dtype(x, self.weight, self.bias))


class DenseGeneral(nn.Module):
    """flax's ``DenseGeneral`` with its parameters in flax's layout: ``kernel``
    (*in_shape, *out_shape) and ``bias`` (*out_shape), contracting the last
    ``len(in_shape)`` axes of the input; the dtype is the promotion of the
    input's and the parameters'."""

    def __init__(self, in_shape, out_shape):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        n_in = math.prod(self.in_shape)
        self.kernel = nn.Parameter(torch.randn(*self.in_shape, *self.out_shape) / math.sqrt(n_in))
        self.bias = nn.Parameter(torch.zeros(*self.out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = op_dtype(x, self.kernel, self.bias)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        w = self.kernel.to(dt).reshape(math.prod(self.in_shape), -1)
        y = x.to(dt).reshape(*lead, -1) @ w + self.bias.to(dt).reshape(-1)
        return y.reshape(*lead, *self.out_shape)


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` as self-attention without a
    mask or dropout: ``query``/``key``/``value`` (D, heads, head_dim), the
    query divided by sqrt(head_dim), a softmax over the keys, ``out``
    (heads, head_dim, D). The products are written out (no fused attention),
    so float64 stays float64."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        hd = dim // num_heads
        self.query = DenseGeneral((dim,), (num_heads, hd))
        self.key = DenseGeneral((dim,), (num_heads, hd))
        self.value = DenseGeneral((dim,), (num_heads, hd))
        self.out = DenseGeneral((num_heads, hd), (dim,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)  # (B, T, heads, hd)
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), -1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class TransformerEncoder(nn.Module):
    """Pre-LN transformer encoder over the sequence (width) axis, with flax's
    names: an optional ``in_proj`` (when the input width is not ``dim``), a
    learned ``pos_embed`` (1, T, dim), ``num_layers`` blocks of ``ln1_i`` ->
    ``attn_i`` -> residual -> ``ln2_i`` -> ``mlp1_i`` (4 dim) -> tanh gelu ->
    ``mlp2_i`` -> residual, then ``ln_out``.

    flax fixes T at its first call; the port takes it at construction and
    raises on another length. It takes no compute dtype, as the JAX module
    takes none: every op promotes its input with its parameters, so a bf16
    input meets the float32 ``pos_embed`` and runs in float32 under mixed
    precision. ``dropout`` is kept for the signature; the recognizer always
    passes 0.0, and a nonzero value raises."""

    def __init__(self, input_size: int, seq_len: int, dim: int = 256, num_layers: int = 2,
                 num_heads: int = 8, mlp_ratio: int = 4, dropout: float = 0.0):
        super().__init__()
        if dropout:
            raise ValueError("dropout is not ported: the recognizer builds the encoder "
                             "with dropout 0.0")
        self.seq_len, self.num_layers = seq_len, num_layers
        self.in_proj = Linear(input_size, dim) if input_size != dim else None
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, seq_len, dim))
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", LayerNorm(dim))
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(dim, num_heads))
            self.add_module(f"ln2_{i}", LayerNorm(dim))
            self.add_module(f"mlp1_{i}", Linear(dim, dim * mlp_ratio))
            self.add_module(f"mlp2_{i}", Linear(dim * mlp_ratio, dim))
        self.ln_out = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.seq_len:
            raise ValueError(f"sequence of {x.shape[1]} steps, but the encoder was built for "
                             f"{self.seq_len}: build it with the crop_hw it is fed")
        if self.in_proj is not None:
            x = self.in_proj(x)
        x = x + self.pos_embed
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            x = x + layer("attn")(layer("ln1")(x))
            y = F.gelu(layer("mlp1")(layer("ln2")(x)), approximate="tanh")
            x = x + layer("mlp2")(y)
        return self.ln_out(x)
