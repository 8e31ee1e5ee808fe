"""CLIP text encoders (ViT-L/14 and OpenCLIP bigG towers) as torch modules.

Counterpart of latentblending_tpu/models/clip.py with HF transformers'
CLIPTextModel(WithProjection) key names (text_model.embeddings…,
text_model.encoder.layers.i…, text_model.final_layer_norm, text_projection).
Returns the PENULTIMATE hidden state (what SDXL conditions on), the final
normed hidden state, and the pooled EOS feature (projected when
cfg.projection_dim is set: text_encoder_2). ViT-L uses quick_gelu, bigG the
exact erf GELU.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentblending_tpu_torch.models.configs import CLIPTextConfig
from latentblending_tpu_torch.models.layers import LayerNorm
from latentblending_tpu_torch.ops.attention import attention_reference


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        shape = (b, l, self.heads, c // self.heads)
        out = attention_reference(
            self.q_proj(x).view(shape), self.k_proj(x).view(shape), self.v_proj(x).view(shape), bias=causal_bias
        )
        return self.out_proj(out.reshape(b, l, c))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, causal_bias):
        x = x + self.self_attn(self.layer_norm1(x), causal_bias)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class _TextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    """forward(input_ids [B, L] int) → (penultimate, last_hidden, pooled)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextModel(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor):
        c = self.cfg
        tm = self.text_model
        b, l = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[None, :l]
        neg = torch.finfo(torch.float32).min
        causal_bias = torch.triu(torch.full((l, l), neg, device=x.device), diagonal=1)[None, None]

        penultimate = x
        for i, layer in enumerate(tm.encoder.layers):
            if i == c.num_layers - 1:
                penultimate = x
            x = layer(x, causal_bias)
        last_hidden = tm.final_layer_norm(x)

        # first EOS position (HF's eos_token_id-aware pooling)
        is_eos = (input_ids == c.eos_token_id).to(torch.int32)
        has_eos = is_eos.any(dim=-1)
        eos_pos = torch.where(has_eos, torch.argmax(is_eos, dim=-1), torch.argmax(input_ids, dim=-1))
        pooled = last_hidden[torch.arange(b, device=x.device), eos_pos]
        if c.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return penultimate, last_hidden, pooled
