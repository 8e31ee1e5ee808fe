"""The T5 v1.1 encoder (HF T5EncoderModel) that conditions SD3, and its
word-hash tokenizer.

Key names are the HF checkpoint's (shared, encoder.block.i.layer.0.
SelfAttention.{q,k,v,o}, .relative_attention_bias in block 0,
layer.0/1.layer_norm, layer.1.DenseReluDense.{wi_0,wi_1,wo},
encoder.final_layer_norm); the tied encoder.embed_tokens is `shared`.
What makes it T5: RMS layer norms (no mean, no bias), no 1/√d score
scale, a bidirectional relative-position bias (log-spaced buckets up to
a maximum distance) computed by block 0 and added in every block, and a
gated GELU (tanh) feed-forward. SD3 runs it without an attention mask:
the pipeline pads its tokens to max_sequence_length and attends to all.

The weights stay in the module's dtype (bf16 on the card, as the model
card's pipeline loads them); every product, the residual stream, the
scores, softmax and norms compute in COMPUTE_DTYPE, float32, on cuBLAS
(each weight is widened for its product). This is for random weights: T5
has no 1/√d score scale, and a trained T5 carries it in q's weights, where
weights drawn at fan_in^-1/2 give scores of std √d = 8. Softmax is then
close to an argmax and the encoder amplifies rounding layer by layer: in
bf16 its output is 0.57 relative off by layer 24, against 0.013 with q at
the trained scale (PERF.md §6). T5 runs twice a transition, 0.1-0.2 s in
float32. The attention stays on plain torch ops: K2 takes no bias.
"""
from __future__ import annotations

import hashlib
import math
import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from latentblending_tpu_torch.models.layers import RMSNorm
from latentblending_tpu_torch.models.sd3_configs import T5Config


class T5HashTokenizer:
    """Deterministic stand-in for T5's SentencePiece tokenizer where no
    vocabulary is at hand: per lowercase whitespace-separated word the first
    4 bytes of its SHA-256 (little endian) mod vocab_size - 3, then eos,
    then pad, to `length`; no bos (T5 has none). NOT T5-compatible ids; the
    shapes and the eos/pad contract are."""

    def __init__(self, vocab_size: int = 32128, eos_token_id: int = 1, pad_token_id: int = 0, length: int = 256):
        self.vocab_size, self.eos_token_id, self.pad_token_id, self.length = (
            vocab_size, eos_token_id, pad_token_id, length)

    def __call__(self, texts: list[str]) -> np.ndarray:
        out = np.full((len(texts), self.length), self.pad_token_id, np.int64)
        for i, t in enumerate(texts):
            words = re.sub(r"\s+", " ", t).strip().lower().split()
            ids = [int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little") % (self.vocab_size - 3)
                   for w in words][: self.length - 1]
            row = ids + [self.eos_token_id]
            out[i, : len(row)] = row
        return out


def relative_position_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF T5's bidirectional bucket of each relative position (key - query):
    half the buckets per direction, exact below a quarter of the buckets,
    log-spaced up to max_distance, the last bucket beyond it."""
    half = num_buckets // 2
    buckets = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    exact = half // 2
    large = exact + (torch.log(rel.float().clamp(min=1) / exact) / math.log(max_distance / exact)
                     * (half - exact)).to(torch.long)
    large = torch.clamp(large, max=half - 1)
    return buckets + torch.where(rel < exact, rel, large)


COMPUTE_DTYPE = torch.float32


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x Wᵀ in COMPUTE_DTYPE whatever the weight's dtype."""
    return F.linear(x, layer.weight.to(COMPUTE_DTYPE))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q, self.k, self.v = (nn.Linear(cfg.d_model, inner, bias=False) for _ in range(3))
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)

    def position_bias(self, length: int, device) -> torch.Tensor:
        """[1, heads, L, L] in COMPUTE_DTYPE, from this layer's bias table."""
        pos = torch.arange(length, dtype=torch.long, device=device)
        rel = pos[None, :] - pos[:, None]
        b = relative_position_bucket(rel, self.cfg.relative_attention_num_buckets,
                                     self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(b).to(COMPUTE_DTYPE).permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        h, d = self.cfg.num_heads, self.cfg.d_kv

        def split(t):
            return t.view(b, l, h, d).transpose(1, 2)

        s = torch.matmul(split(_linear(self.q, x)), split(_linear(self.k, x)).transpose(-1, -2)) + bias
        out = torch.matmul(torch.softmax(s, dim=-1), split(_linear(self.v, x)))
        return _linear(self.o, out.transpose(1, 2).reshape(b, l, h * d))


class _Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        attn = nn.Module()
        attn.SelfAttention = T5Attention(cfg, has_bias)
        attn.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        ff = nn.Module()
        ff.DenseReluDense = nn.Module()
        ff.DenseReluDense.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        ff.DenseReluDense.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        ff.DenseReluDense.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)
        ff.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.layer = nn.ModuleList([attn, ff])

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), bias)
        d = ff.DenseReluDense
        y = ff.layer_norm(x)
        return x + _linear(d.wo, F.gelu(_linear(d.wi_0, y), approximate="tanh") * _linear(d.wi_1, y))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([_Block(cfg, i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """forward(input_ids [B, L]) → the last hidden state [B, L, d_model],
    final-normed, in COMPUTE_DTYPE."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids).to(COMPUTE_DTYPE)
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(input_ids.shape[1], x.device)
        for blk in blocks:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)
