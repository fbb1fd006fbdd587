"""2-D attentional recognizer (judged config #3) with greedy and beam decode.

A port of ``megreader_tpu/models/attention.py``:

    NHWC crops -> resnet rec2d trunk -> (B, C, H', W') -> (B, H', W', C)
    -> mem_proj + learned 2-D position ``pos2d`` (1, H', W', D) -> memory
    (B, H'W', D) and its attention keys attn_mem(memory)
    decoder step: additive attention of the state over the memory -> context;
    GRU cell on [embed(y_prev), context]; logits = out([state, context]).

Training is teacher-forced on the GO-shifted targets with a masked mean
cross entropy (the mask includes the EOS). Greedy decode freezes a row after
its EOS; the beam keeps W hypotheses a crop, continues a finished one with
PAD at no cost, and ranks by score (length-normalised when
``length_penalty > 0``). Charset: ``AttentionCharset`` (PAD 0, GO 1, EOS 2).

flax builds ``pos2d`` at the first call, from the feature map it sees; the
port's net takes H' and W' from ``crop_hw`` at construction and raises at
forward if the feature map disagrees.

``compute_dtype='bfloat16'`` runs the trunk in bf16 (mixed precision,
float32 parameters). ``mem_proj`` takes the features in float32, as flax casts
them, and the decoder (attention, GRU, ``out``) computes in float32 under
mixed precision and under the bf16 serving cast alike: every op promotes its
input with its weights (``ops/precision.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..core.charset import AttentionCharset
from ..ops.ctc import NEG_INF, stable_top_k
from ..ops.precision import Linear, at_least_float32, matmul_t, parse_compute_dtype
from ..parallel.mesh import batch_sum
from .recognizer2d import rec2d_feature_height
from .resnet import resnet_variant


def rec2d_feature_width(crop_w: int) -> int:
    """Columns of the rec2d feature map: the 2x2 pool, then stage 2's
    stride-2 conv (padding 1: ceil)."""
    return -(-(crop_w // 2) // 2)


class GRUCellTorchlike(nn.Module):
    """GRU cell with torch's gate order (r, z, n): ``w_ih`` (3H, in), ``w_hh``
    (3H, H), ``b_ih``, ``b_hh`` (3H,)."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(3 * hidden, input_size))
        self.w_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.b_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.b_hh = nn.Parameter(torch.zeros(3 * hidden))
        nn.init.xavier_uniform_(self.w_ih)
        nn.init.orthogonal_(self.w_hh)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = matmul_t(x, self.w_ih, self.b_ih).chunk(3, -1)
        h_r, h_z, h_n = matmul_t(h, self.w_hh, self.b_hh).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1 - z) * n + z * h


class AttentionRecognizerNet(nn.Module):
    """Encoder and one decoder step; ``forward`` is the teacher-forced loop."""

    def __init__(self, num_classes: int, backbone: str = "resnet18", dim: int = 256,
                 max_len: int = 32, width: int = 64, crop_hw=(32, 100), dtype=None):
        super().__init__()
        self.dim = dim
        self.max_len = max_len
        self.trunk = resnet_variant(backbone, "rec2d", width, dtype=dtype)
        self.grid = (rec2d_feature_height(crop_hw[0]), rec2d_feature_width(crop_hw[1]))
        self.pos2d = nn.Parameter(0.02 * torch.randn(1, *self.grid, dim))
        self.mem_proj = Linear(self.trunk.out_channels[-1], dim)
        self.embed = nn.Embedding(num_classes, dim)
        self.gru = GRUCellTorchlike(2 * dim, dim)
        self.attn_mem = Linear(dim, dim, bias=False)
        self.attn_state = Linear(dim, dim, bias=False)
        self.attn_v = Linear(dim, 1, bias=False)
        self.out = Linear(2 * dim, num_classes)

    def encode(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC crops -> (memory (B, H'W', D), keys (B, H'W', D)) in float32
        (float64 in the tests)."""
        feat = self.trunk(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # (B, H', W', C)
        if tuple(feat.shape[1:3]) != self.grid:
            raise ValueError(f"feature map of {tuple(feat.shape[1:3])}, but the net was built "
                             f"for {self.grid} (crops {tuple(images.shape[1:3])}): build it "
                             "with the crop_hw it is fed")
        mem = self.mem_proj(at_least_float32(feat)) + self.pos2d
        mem = mem.reshape(feat.shape[0], -1, self.dim)
        return mem, self.attn_mem(mem)

    def attend(self, keys: torch.Tensor, mem: torch.Tensor, state: torch.Tensor):
        """Additive attention of (B, D) ``state`` over (B, N, D) ``keys`` ->
        (context (B, D), weights (B, N))."""
        score = self.attn_v(torch.tanh(keys + self.attn_state(state).unsqueeze(1)))[..., 0]
        w = torch.softmax(score, 1)
        return torch.bmm(w.unsqueeze(1), mem)[:, 0], w

    def decode_step(self, keys, mem, state, y_prev):
        """(state (B, D), previous ids (B,)) -> (new state, logits (B, V))."""
        ctx, _ = self.attend(keys, mem, state)
        new_state = self.gru(torch.cat([self.embed(y_prev), ctx], -1), state)
        return new_state, self.out(torch.cat([new_state, ctx], -1))

    def forward(self, images: torch.Tensor, targets_in: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (B, T, V) for ``targets_in`` (B, T), which
        starts with GO."""
        mem, keys = self.encode(images)
        state = mem.new_zeros(mem.shape[0], self.dim)
        logits = []
        for t in range(targets_in.shape[1]):
            state, step_logits = self.decode_step(keys, mem, state, targets_in[:, t])
            logits.append(step_logits)
        return torch.stack(logits, 1)


def _lengths(ids: torch.Tensor, max_len: int) -> torch.Tensor:
    """Position of the first EOS + 1 along the last axis, or ``max_len``."""
    is_eos = ids == AttentionCharset.EOS
    first = torch.argmax(is_eos.to(torch.uint8), -1)
    return torch.where(is_eos.any(-1), first + 1, max_len).to(torch.int32)


class AttentionRecognizer:
    """Task wrapper: the net on ``device``, the teacher-forced loss, greedy
    and beam decode. ``loss`` and the decodes put the net in train or eval
    mode themselves; a decode's ``net`` overrides the wrapper's own module
    (same architecture)."""

    def __init__(self, num_classes: int = 39, backbone: str = "resnet18", dim: int = 256,
                 max_len: int = 32, width: int = 64, compute_dtype: str = "float32",
                 crop_hw=(32, 100), device="cuda"):
        self.net = AttentionRecognizerNet(num_classes, backbone, dim, max_len, width, crop_hw,
                                          parse_compute_dtype(compute_dtype)).to(device).eval()
        self.num_classes = num_classes
        self.max_len = max_len

    def loss(self, batch, train: bool = True):
        """batch: {image (B, H, W, 3), label (B, T) EOS-ended and PAD-padded,
        label_length (B,) counting the EOS} on the net's device -> (masked
        mean cross entropy, {"loss": detached}). ``train`` runs BatchNorm on
        batch statistics and updates its running statistics."""
        labels = batch["label"].long()
        B, T = labels.shape
        go = labels.new_full((B, 1), AttentionCharset.GO)
        self.net.train(train)
        logits = self.net(batch["image"], torch.cat([go, labels[:, :T - 1]], 1))
        logp = torch.log_softmax(logits, -1)
        tok_ll = torch.gather(logp, 2, labels.unsqueeze(-1))[..., 0]
        mask = (torch.arange(T, device=labels.device).view(1, T)
                < batch["label_length"].view(B, 1)).to(logp.dtype)
        num, den = batch_sum(torch.stack([(tok_ll * mask).sum(), mask.sum()]))
        loss = -num / den.clamp(min=1.0)
        return loss, {"loss": loss.detach()}

    def decode(self, images: torch.Tensor, mode: str = "greedy", net: nn.Module = None,
               beam_width: int = 5):
        """The family's decode by name, as the other recognizers' ``decode``:
        ``decode_greedy``, or ``decode_beam`` of width ``beam_width``."""
        if mode == "greedy":
            return self.decode_greedy(images, net)
        if mode == "beam":
            return self.decode_beam(images, beam_width, net=net)
        raise ValueError(f"unknown decode mode {mode!r}")

    @torch.no_grad()
    def decode_greedy(self, images: torch.Tensor, net: nn.Module = None):
        """NHWC crops -> (ids (B, max_len) int32, PAD after the first EOS;
        lengths (B,) int32: the first EOS + 1, or max_len)."""
        net = (self.net if net is None else net).eval()
        mem, keys = net.encode(images)
        B = mem.shape[0]
        state = mem.new_zeros(B, net.dim)
        y = torch.full((B,), AttentionCharset.GO, dtype=torch.int64, device=mem.device)
        done = torch.zeros(B, dtype=torch.bool, device=mem.device)
        ys = []
        for _ in range(self.max_len):
            new_state, logits = net.decode_step(keys, mem, state, y)
            y = torch.where(done, AttentionCharset.PAD, torch.argmax(logits, -1))
            state = torch.where(done.unsqueeze(1), state, new_state)
            done = done | (y == AttentionCharset.EOS)
            ys.append(y)
        ids = torch.stack(ys, 1)
        return ids.to(torch.int32), _lengths(ids, self.max_len)

    @torch.no_grad()
    def decode_beam(self, images: torch.Tensor, beam_width: int = 5,
                    length_penalty: float = 0.0, net: nn.Module = None):
        """Batched beam search of fixed width W -> the best hypothesis's (ids
        (B, max_len) int32, lengths (B,) int32). Beam 0 alone is live at the
        start; a finished hypothesis continues with PAD at no cost; each step
        keeps the best W of W*V (lower index first among equal scores)."""
        net = (self.net if net is None else net).eval()
        mem, keys = net.encode(images)
        B, N, D = mem.shape
        W, V, T = beam_width, self.num_classes, self.max_len
        dev = mem.device
        mem_t = mem.repeat_interleave(W, 0)
        keys_t = keys.repeat_interleave(W, 0)
        state = mem.new_zeros(B * W, D)
        y = torch.full((B * W,), AttentionCharset.GO, dtype=torch.int64, device=dev)
        scores = mem.new_full((B, W), NEG_INF)
        scores[:, 0] = 0.0
        done = torch.zeros((B, W), dtype=torch.bool, device=dev)
        seqs = torch.zeros((B, W, T), dtype=torch.int64, device=dev)
        pad_only = mem.new_full((V,), NEG_INF)
        pad_only[AttentionCharset.PAD] = 0.0
        rows = torch.arange(B, device=dev).view(B, 1)
        for t in range(T):
            new_state, logits = net.decode_step(keys_t, mem_t, state, y)
            logp = torch.log_softmax(logits, -1).view(B, W, V)
            logp = torch.where(done.unsqueeze(-1), pad_only, logp)
            scores, top = stable_top_k((scores.unsqueeze(-1) + logp).view(B, W * V), W)
            src, tok = top // V, top % V
            flat_src = (rows * W + src).view(-1)
            state = torch.where(done.view(-1)[flat_src].unsqueeze(1), state[flat_src],
                                new_state[flat_src])
            seqs = seqs[rows, src]
            seqs[:, :, t] = tok
            done = done[rows, src] | (tok == AttentionCharset.EOS)
            y = tok.view(-1)
        lengths = _lengths(seqs, T)  # (B, W)
        ranked = scores
        if length_penalty > 0:
            ranked = scores / ((5.0 + lengths.to(scores.dtype)) / 6.0) ** length_penalty
        best = torch.argmax(ranked, 1).view(B, 1)
        ids = torch.gather(seqs, 1, best.view(B, 1, 1).expand(B, 1, T))[:, 0]
        return ids.to(torch.int32), torch.gather(lengths, 1, best)[:, 0]
