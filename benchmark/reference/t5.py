"""A plain T5 v1.1 encoder (HF transformers' T5EncoderModel), float32, HF key
names (shared, encoder.block.i.layer.{0,1}, encoder.final_layer_norm),
written from transformers' published model: RMS layer norms (eps from the
configuration), self-attention with no score scale plus a bidirectional
relative-position bias from block 0's table (buckets of
_relative_position_bucket), shared by every block, and a gated GELU (tanh,
"gelu_new") feed-forward; no attention mask, as SD3's pipeline calls it.
The word-hash tokenizer the configuration assumes is `hash_tokenize`.
"""
from __future__ import annotations

import hashlib
import math
import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Linear, Precision


def hash_tokenize(text: str, vocab_size: int, eos: int, pad: int, length: int) -> np.ndarray:
    """Word-hash token ids [length]: per whitespace-separated lowercase word
    the first 4 bytes of its SHA-256 (little endian) mod vocab_size - 3,
    then eos, then pad; no bos; words beyond length - 1 are dropped."""
    words = re.sub(r"\s+", " ", text).strip().lower().split()
    ids = [int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little") % (vocab_size - 3) for w in words]
    row = ids[: length - 1] + [eos]
    out = np.full((length,), pad, np.int64)
    out[: len(row)] = row
    return out


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """transformers' T5Attention._relative_position_bucket, bidirectional."""
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = max_exact + (torch.log(n.float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.minimum(large, torch.full_like(large, num_buckets - 1))
    return out + torch.where(is_small, n, large)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device="meta"))

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


class _SelfAttention(nn.Module):
    def __init__(self, cfg: dict, has_bias: bool, p: Precision):
        super().__init__()
        d, inner = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"]
        self.h, self.dk = cfg["num_heads"], cfg["d_kv"]
        self.q, self.k, self.v = (Linear(d, inner, bias=False, prec=p) for _ in range(3))
        self.o = Linear(inner, d, bias=False, prec=p)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg["relative_attention_num_buckets"], self.h, device="meta")

    def forward(self, x, bias):
        b, l, _ = x.shape

        def split(t):
            return t.view(b, l, self.h, self.dk).transpose(1, 2)

        s = torch.matmul(split(self.q(x)), split(self.k(x)).transpose(-1, -2)) + bias
        out = torch.matmul(torch.softmax(s, dim=-1), split(self.v(x)))
        return self.o(out.transpose(1, 2).reshape(b, l, self.h * self.dk))


class _Block(nn.Module):
    def __init__(self, cfg: dict, has_bias: bool, p: Precision):
        super().__init__()
        d, ff, eps = cfg["d_model"], cfg["d_ff"], cfg["layer_norm_epsilon"]
        self.layer = nn.ModuleList([
            nn.ModuleDict({"SelfAttention": _SelfAttention(cfg, has_bias, p), "layer_norm": RMSNorm(d, eps)}),
            nn.ModuleDict({"DenseReluDense": nn.ModuleDict({"wi_0": Linear(d, ff, bias=False, prec=p),
                                                            "wi_1": Linear(d, ff, bias=False, prec=p),
                                                            "wo": Linear(ff, d, bias=False, prec=p)}),
                           "layer_norm": RMSNorm(d, eps)}),
        ])

    def forward(self, x, bias):
        a, f = self.layer
        x = x + a["SelfAttention"](a["layer_norm"](x), bias)
        dr = f["DenseReluDense"]
        y = f["layer_norm"](x)
        return x + dr["wo"](F.gelu(dr["wi_0"](y), approximate="tanh") * dr["wi_1"](y))


class T5Encoder(nn.Module):
    """forward(ids [B, L]) → the final-normed last hidden state [B, L, d]."""

    def __init__(self, cfg: dict, prec: Precision | None = None):
        super().__init__()
        p = prec or Precision()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg["vocab_size"], cfg["d_model"], device="meta")
        self.encoder = nn.Module()
        self.encoder.block = nn.ModuleList([_Block(cfg, i == 0, p) for i in range(cfg["num_layers"])])
        self.encoder.final_layer_norm = RMSNorm(cfg["d_model"], cfg["layer_norm_epsilon"])

    def position_bias(self, length: int, device) -> torch.Tensor:
        pos = torch.arange(length, device=device)
        rel = pos[None, :] - pos[:, None]  # key - query
        b = bucket(rel, self.cfg["relative_attention_num_buckets"], self.cfg["relative_attention_max_distance"])
        table = self.encoder.block[0].layer[0]["SelfAttention"].relative_attention_bias
        return table(b).permute(2, 0, 1)[None]

    def forward(self, ids):
        x = self.shared(ids)
        bias = self.position_bias(ids.shape[1], x.device)
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)
