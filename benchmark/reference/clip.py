"""Plain CLIP text towers (HF CLIPTextModel / CLIPTextModelWithProjection
semantics), float32, HF key names, and the word-hash tokenizer the
configurations assume.

SDXL conditions on the penultimate hidden state of both towers,
concatenated, and on the projected pooled feature of the second tower, at
the first end-of-text token.
"""
from __future__ import annotations

import hashlib
import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Linear, Precision, attention, layer_norm


def hash_tokenize(text: str, vocab_size: int, bos: int, eos: int, pad: int, length: int = 77) -> np.ndarray:
    """Word-hash token ids [length]: bos, per whitespace-separated lowercase
    word the first 4 bytes of its SHA-256 (little endian) mod vocab_size - 3,
    eos, then pad; words beyond length - 2 are dropped."""
    words = re.sub(r"\s+", " ", text).strip().lower().split()
    ids = [int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little") % (vocab_size - 3) for w in words]
    row = [bos] + ids[: length - 2] + [eos]
    out = np.full((length,), pad, np.int64)
    out[: len(row)] = row
    return out


class _Attn(nn.Module):
    def __init__(self, c, heads, p):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(c, c, prec=p) for _ in range(4))

    def forward(self, x, mask):
        b, l, c = x.shape

        def split(t):
            return t.view(b, l, self.heads, c // self.heads).transpose(1, 2)

        out = attention(split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x)), mask, chunk=b)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, c))


class _Layer(nn.Module):
    def __init__(self, cfg, p):
        super().__init__()
        c = cfg["hidden_size"]
        self.act = cfg["hidden_act"]
        self.self_attn = _Attn(c, cfg["num_attention_heads"], p)
        self.layer_norm1 = layer_norm(c, cfg["layer_norm_eps"])
        self.mlp = nn.ModuleDict({"fc1": Linear(c, cfg["intermediate_size"], prec=p),
                                  "fc2": Linear(cfg["intermediate_size"], c, prec=p)})
        self.layer_norm2 = layer_norm(c, cfg["layer_norm_eps"])

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        h = self.mlp["fc1"](self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp["fc2"](h)


class TextEncoder(nn.Module):
    """forward(ids [B, L]) → (penultimate hidden state, pooled feature)."""

    def __init__(self, cfg: dict, prec: Precision | None = None):
        super().__init__()
        p = prec or Precision()
        self.cfg = cfg
        c = cfg["hidden_size"]
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], c, device="meta")
        tm.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], c, device="meta")
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([_Layer(cfg, p) for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = layer_norm(c, cfg["layer_norm_eps"])
        self.text_model = tm
        if cfg.get("projection", False):
            self.text_projection = Linear(c, cfg["projection_dim"], bias=False, prec=p)

    def forward(self, ids: torch.Tensor):
        tm = self.text_model
        b, l = ids.shape
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[None, :l]
        mask = torch.triu(torch.full((l, l), float("-inf"), device=x.device), diagonal=1)
        layers = tm.encoder.layers
        for layer in layers[:-1]:
            x = layer(x, mask)
        penultimate = x
        last = tm.final_layer_norm(layers[-1](x, mask))
        eos_pos = torch.argmax((ids == self.cfg["eos_token_id"]).to(torch.int64), dim=-1)
        pooled = last[torch.arange(b, device=x.device), eos_pos]
        if hasattr(self, "text_projection"):
            pooled = self.text_projection(pooled)
        return penultimate, pooled
