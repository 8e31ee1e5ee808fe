"""The SD3 denoiser: an MMDiT (multimodal diffusion transformer), diffusers'
SD3Transformer2DModel without dual-attention layers, in PyTorch.

Key names are the HF checkpoint's (pos_embed.proj, time_text_embed.*,
context_embedder, transformer_blocks.i.{norm1,norm1_context}.linear,
.attn.{to_q,...,add_q_proj,...,norm_q,norm_added_q,...}, .ff.net.0.proj,
.ff_context.net.2, norm_out.linear, proj_out). The 2-D sin-cos position
table is computed, not stored (diffusers keeps it as a buffer), so a state
dict holds weights only.

A block keeps separate weights for the image and the text tokens; each
stream is modulated by adaLN-Zero vectors from the time and pooled-text
embedding, Q and K of both pass a per-head RMSNorm, and ONE attention runs
over the joint sequence, image tokens first: at 1024² 4096 image + 333
text tokens = 4429, which K2 (ops/attention.py) takes at any length. The
last block is `context_pre_only`: its text stream ends at the attention.

Numerics: the weights in the module's dtype (bf16 on the card), norms,
modulation and softmax statistics in float32, results in the stream's
dtype. Each adaLN norm and gated residual is one pass of M1
(ops/adaln.py) on the card, which takes a bf16 stream only (it raises on
anything else), and the unfused float32 expressions on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from latentblending_tpu_torch.models.layers import RMSNorm, TimestepEmbedding, timestep_embedding
from latentblending_tpu_torch.models.sd3_configs import MMDiTConfig
from latentblending_tpu_torch.ops import adaln
from latentblending_tpu_torch.ops.attention import flash_attention

_EPS = 1e-6


def sincos_table(dim: int, grid: int, base: int) -> np.ndarray:
    """diffusers' get_2d_sincos_pos_embed(dim, grid, base_size=base,
    interpolation_scale=1): [grid², dim] float64, the first half of each row
    the sin/cos of the column coordinate, the second of the row
    coordinate, coordinates arange(grid) / (grid / base)."""
    coords = np.arange(grid, dtype=np.float64) / (grid / base)
    gw, gh = np.meshgrid(coords, coords)  # gw varies along a row

    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([one_d(dim // 2, gw), one_d(dim // 2, gh)], axis=1)


class _AdaNormLinear(nn.Module):
    """The modulation vectors of a norm: linear(silu(temb)), chunked."""

    def __init__(self, dim: int, n: int):
        super().__init__()
        self.n = n
        self.linear = nn.Linear(dim, n * dim)

    def forward(self, temb: torch.Tensor) -> tuple:
        return self.linear(F.silu(temb)).chunk(self.n, dim=1)


class JointAttention(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, context_pre_only: bool):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.to_q, self.to_k, self.to_v = (nn.Linear(dim, inner) for _ in range(3))
        self.add_q_proj, self.add_k_proj, self.add_v_proj = (nn.Linear(dim, inner) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(head_dim, _EPS), RMSNorm(head_dim, _EPS)
        self.norm_added_q, self.norm_added_k = RMSNorm(head_dim, _EPS), RMSNorm(head_dim, _EPS)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])
        if not context_pre_only:
            self.to_add_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> tuple:
        b, lx, lc = x.shape[0], x.shape[1], c.shape[1]

        def heads(t, n):
            return t.view(b, n, self.heads, self.head_dim)

        q = torch.cat([self.norm_q(heads(self.to_q(x), lx)), self.norm_added_q(heads(self.add_q_proj(c), lc))], 1)
        k = torch.cat([self.norm_k(heads(self.to_k(x), lx)), self.norm_added_k(heads(self.add_k_proj(c), lc))], 1)
        v = torch.cat([heads(self.to_v(x), lx), heads(self.add_v_proj(c), lc)], 1)
        out = flash_attention(q, k, v).reshape(b, lx + lc, self.heads * self.head_dim)
        ox = self.to_out[0](out[:, :lx])
        oc = self.to_add_out(out[:, lx:]) if hasattr(self, "to_add_out") else None
        return ox, oc


class FeedForward(nn.Module):
    """net.0.proj (dim → mult·dim, tanh GELU), net.2 (→ dim); net.1 is
    diffusers' dropout slot."""

    def __init__(self, dim: int, mult: int):
        super().__init__()
        proj = nn.Module()
        proj.proj = nn.Linear(dim, mult * dim)
        self.net = nn.ModuleList([proj, nn.Identity(), nn.Linear(mult * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](F.gelu(self.net[0].proj(x), approximate="tanh"))


class JointTransformerBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool):
        super().__init__()
        dim = cfg.inner_dim
        self.context_pre_only = context_pre_only
        self.norm1 = _AdaNormLinear(dim, 6)
        self.norm1_context = _AdaNormLinear(dim, 2 if context_pre_only else 6)
        self.attn = JointAttention(dim, cfg.num_attention_heads, cfg.attention_head_dim, context_pre_only)
        self.ff = FeedForward(dim, cfg.mlp_ratio)
        if not context_pre_only:
            self.ff_context = FeedForward(dim, cfg.mlp_ratio)

    def forward(self, x: torch.Tensor, c: torch.Tensor, temb: torch.Tensor) -> tuple:
        """(x image tokens, c text tokens) → (x, c), c None after a
        context_pre_only block."""
        shift, scale, gate, shift_m, scale_m, gate_m = self.norm1(temb)
        if self.context_pre_only:
            # AdaLayerNormContinuous: scale first, then shift
            c_scale, c_shift = self.norm1_context(temb)
        else:
            c_shift, c_scale, c_gate, c_shift_m, c_scale_m, c_gate_m = self.norm1_context(temb)
        ax, ac = self.attn(adaln.ln_modulate(x, shift, scale), adaln.ln_modulate(c, c_shift, c_scale))
        x, nx = adaln.gated_residual(x, gate, ax, shift_m, scale_m)
        x = adaln.gated_residual(x, gate_m, self.ff(nx))
        if self.context_pre_only:
            return x, None
        c, nc = adaln.gated_residual(c, c_gate, ac, c_shift_m, c_scale_m)
        c = adaln.gated_residual(c, c_gate_m, self.ff_context(nc))
        return x, c


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.inner_dim, p, stride=p)
        self._tables: dict = {}

    def table(self, h: int, w: int, device) -> torch.Tensor:
        """The position table centre-cropped to h x w patches, float32
        [h·w, dim] on `device` (computed once per size and device)."""
        key = (h, w, str(device))
        if key not in self._tables:
            c = self.cfg
            m = c.pos_embed_max_size
            if h > m or w > m:
                raise ValueError(f"MMDiT: {h}x{w} patches exceed pos_embed_max_size {m}")
            full = sincos_table(c.inner_dim, m, c.sample_size // c.patch_size).reshape(m, m, -1)
            top, left = (m - h) // 2, (m - w) // 2
            crop = full[top:top + h, left:left + w].reshape(h * w, -1)
            self._tables[key] = torch.from_numpy(crop).float().to(device)
        return self._tables[key]

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        y = self.proj(sample.to(self.proj.weight.dtype))
        b, d, h, w = y.shape
        # token rows contiguous: the blocks' residual stream keeps this layout,
        # and M1 takes contiguous rows
        y = y.flatten(2).transpose(1, 2).contiguous()
        return (y.float() + self.table(h, w, y.device)).to(y.dtype)


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.dim = cfg.time_proj_dim
        self.timestep_embedder = TimestepEmbedding(cfg.time_proj_dim, cfg.inner_dim)
        self.text_embedder = TimestepEmbedding(cfg.pooled_projection_dim, cfg.inner_dim)

    def forward(self, t: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        dt = self.timestep_embedder.linear_1.weight.dtype
        tp = timestep_embedding(t, self.dim, flip_sin_to_cos=True, freq_shift=0.0).to(dt)
        return self.timestep_embedder(tp) + self.text_embedder(pooled.to(dt))


class _NormOut(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear(F.silu(temb)).chunk(2, dim=1)
        return adaln.ln_modulate(x, shift, scale)


class MMDiT(nn.Module):
    """forward(sample [B,C,h,w], timestep scalar or [B] (T·σ),
    encoder_hidden_states [B,Lc,joint_attention_dim], pooled [B,pooled_dim])
    → the predicted velocity [B,C,h,w] (float32 statistics, the module's
    dtype out)."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.inner_dim
        self.pos_embed = _PatchEmbed(cfg)
        self.time_text_embed = _TimeTextEmbed(cfg)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, cfg.caption_projection_dim)
        self.transformer_blocks = nn.ModuleList(
            [JointTransformerBlock(cfg, context_pre_only=i == cfg.num_layers - 1) for i in range(cfg.num_layers)])
        self.norm_out = _NormOut(dim)
        p = cfg.patch_size
        self.proj_out = nn.Linear(dim, p * p * cfg.out_channels)

    def forward(self, sample, timestep, encoder_hidden_states, pooled):
        b, _, H, W = sample.shape
        dt = self.proj_out.weight.dtype
        t = torch.as_tensor(timestep, device=sample.device, dtype=torch.float32).reshape(-1).expand(b)
        x = self.pos_embed(sample)
        temb = self.time_text_embed(t, pooled)
        c = self.context_embedder(encoder_hidden_states.to(dt))
        for blk in self.transformer_blocks:
            x, c = blk(x, c, temb)
        x = self.proj_out(self.norm_out(x, temb))
        p, co = self.cfg.patch_size, self.cfg.out_channels
        h, w = H // p, W // p
        x = x.reshape(b, h, w, p, p, co)
        return torch.einsum("nhwpqc->nchpwq", x).reshape(b, co, h * p, w * p)
