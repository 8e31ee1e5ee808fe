"""A plain SD3 MMDiT (diffusers' SD3Transformer2DModel without dual-attention
layers), float32, HF key names, written from diffusers' published model:

- patch embed: a p x p stride-p convolution, flattened, plus a 2-D sin-cos
  table of pos_embed_max_size² (get_2d_sincos_pos_embed with base size
  sample_size / p) centre-cropped to the patch grid;
- time + text embed: Timesteps(256, flip_sin_to_cos, shift 0) through
  linear_1, SiLU, linear_2, plus the pooled text through the same shape;
- context embedder: a linear from joint_attention_dim;
- joint blocks: adaLN-Zero (shift, scale, gate for attention and MLP) per
  stream, q/k/v per stream, per-head RMSNorm (eps 1e-6) on Q and K, one
  softmax attention over [image, text], output projections, GELU (tanh)
  MLPs; the last block's text stream (context_pre_only) has only an
  AdaLayerNormContinuous (scale, then shift) and its q/k/v;
- AdaLayerNormContinuous out, a linear to p·p·C, unpatchify.

No code of the program is used; attention is plain matmuls, one batch
row at a time, the 1/√d scale folded into Q.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Conv2d, Linear, Precision


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device="meta"))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


def sincos_2d(dim: int, grid: int, base: int) -> np.ndarray:
    """get_2d_sincos_pos_embed(dim, grid, base_size=base): [grid², dim]."""
    g = np.arange(grid, dtype=np.float64) / (grid / base)
    mesh = np.stack(np.meshgrid(g, g), axis=0).reshape(2, 1, grid, grid)

    def one_d(d, pos):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([one_d(dim // 2, mesh[0]), one_d(dim // 2, mesh[1])], axis=1)


def timestep_proj(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' get_timestep_embedding(t, dim, flip_sin_to_cos=True,
    downscale_freq_shift=0): [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    arg = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def _attention(q, k, v):
    """softmax(q kᵀ / √d) v in plain matmuls, q/k/v [B, H, L, d], one batch
    row at a time (a row's scores at 4429 tokens and 38 heads are 3 GB)."""
    q = q * q.shape[-1] ** -0.5
    outs = []
    for i in range(q.shape[0]):
        p = torch.softmax(torch.matmul(q[i:i + 1], k[i:i + 1].transpose(-1, -2)), dim=-1)
        outs.append(torch.matmul(p, v[i:i + 1]))
        del p
    return torch.cat(outs)


def _ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _mlp2(cin: int, cout: int, p: Precision) -> nn.ModuleDict:
    return nn.ModuleDict({"linear_1": Linear(cin, cout, prec=p), "linear_2": Linear(cout, cout, prec=p)})


class _Attn(nn.Module):
    def __init__(self, dim: int, heads: int, hd: int, pre_only: bool, p: Precision):
        super().__init__()
        self.heads, self.hd = heads, hd
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, n, Linear(dim, heads * hd, prec=p))
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            setattr(self, n, RMSNorm(hd))
        self.to_out = nn.ModuleList([Linear(heads * hd, dim, prec=p)])
        if not pre_only:
            self.to_add_out = Linear(heads * hd, dim, prec=p)

    def forward(self, x, c):
        b, lx, lc = x.shape[0], x.shape[1], c.shape[1]

        def split(t, n):  # [B, H, n, d]
            return t.view(b, n, self.heads, self.hd).transpose(1, 2)

        q = torch.cat([self.norm_q(split(self.to_q(x), lx)), self.norm_added_q(split(self.add_q_proj(c), lc))], 2)
        k = torch.cat([self.norm_k(split(self.to_k(x), lx)), self.norm_added_k(split(self.add_k_proj(c), lc))], 2)
        v = torch.cat([split(self.to_v(x), lx), split(self.add_v_proj(c), lc)], 2)
        o = _attention(q, k, v).transpose(1, 2).reshape(b, lx + lc, self.heads * self.hd)
        ox = self.to_out[0](o[:, :lx])
        oc = self.to_add_out(o[:, lx:]) if hasattr(self, "to_add_out") else None
        return ox, oc


class _FF(nn.Module):
    def __init__(self, dim: int, p: Precision):
        super().__init__()
        self.net = nn.ModuleList([nn.ModuleDict({"proj": Linear(dim, 4 * dim, prec=p)}), nn.Identity(),
                                  Linear(4 * dim, dim, prec=p)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0]["proj"](x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hd: int, pre_only: bool, p: Precision):
        super().__init__()
        self.pre_only = pre_only
        self.norm1 = nn.ModuleDict({"linear": Linear(dim, 6 * dim, prec=p)})
        self.norm1_context = nn.ModuleDict({"linear": Linear(dim, (2 if pre_only else 6) * dim, prec=p)})
        self.attn = _Attn(dim, heads, hd, pre_only, p)
        self.ff = _FF(dim, p)
        if not pre_only:
            self.ff_context = _FF(dim, p)

    def forward(self, x, c, temb):
        e = self.norm1["linear"](F.silu(temb))
        sh, sc, g, sh_m, sc_m, g_m = (t[:, None] for t in e.chunk(6, dim=1))
        ec = self.norm1_context["linear"](F.silu(temb))
        if self.pre_only:
            csc, csh = (t[:, None] for t in ec.chunk(2, dim=1))
        else:
            csh, csc, cg, csh_m, csc_m, cg_m = (t[:, None] for t in ec.chunk(6, dim=1))
        ax, ac = self.attn(_ln(x) * (1 + sc) + sh, _ln(c) * (1 + csc) + csh)
        x = x + g * ax
        x = x + g_m * self.ff(_ln(x) * (1 + sc_m) + sh_m)
        if self.pre_only:
            return x, None
        c = c + cg * ac
        c = c + cg_m * self.ff_context(_ln(c) * (1 + csc_m) + csh_m)
        return x, c


class MMDiT(nn.Module):
    """forward(sample [B,C,h,w], timestep [B] (T·σ), encoder_hidden_states
    [B,Lc,joint_attention_dim], pooled [B,pooled]) → velocity [B,C,h,w]."""

    def __init__(self, cfg: dict, prec: Precision | None = None):
        super().__init__()
        p = prec or Precision()
        self.cfg = cfg
        hd, heads = cfg["attention_head_dim"], cfg["num_attention_heads"]
        dim = hd * heads
        ps = cfg["patch_size"]
        self.pos_embed = nn.ModuleDict({"proj": Conv2d(cfg["in_channels"], dim, ps, stride=ps, prec=p)})
        self.time_text_embed = nn.ModuleDict({"timestep_embedder": _mlp2(256, dim, p),
                                              "text_embedder": _mlp2(cfg["pooled_projection_dim"], dim, p)})
        self.context_embedder = Linear(cfg["joint_attention_dim"], cfg["caption_projection_dim"], prec=p)
        n = cfg["num_layers"]
        self.transformer_blocks = nn.ModuleList([Block(dim, heads, hd, i == n - 1, p) for i in range(n)])
        self.norm_out = nn.ModuleDict({"linear": Linear(dim, 2 * dim, prec=p)})
        self.proj_out = Linear(dim, ps * ps * cfg["out_channels"], prec=p)

    def _pos(self, h: int, w: int, device) -> torch.Tensor:
        """The table centre-cropped to h x w patches (made once a size)."""
        key = (h, w, str(device))
        cache = self.__dict__.setdefault("_tables", {})
        if key not in cache:
            c = self.cfg
            m, dim = c["pos_embed_max_size"], c["attention_head_dim"] * c["num_attention_heads"]
            table = torch.from_numpy(sincos_2d(dim, m, c["sample_size"] // c["patch_size"])).float()
            top, left = (m - h) // 2, (m - w) // 2
            cache[key] = table.reshape(m, m, dim)[top:top + h, left:left + w].reshape(h * w, dim).to(device)
        return cache[key]

    def forward(self, sample, timestep, context, pooled):
        b, _, H, W = sample.shape
        ps, co = self.cfg["patch_size"], self.cfg["out_channels"]
        x = self.pos_embed["proj"](sample)
        h, w = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2) + self._pos(h, w, x.device)
        te = self.time_text_embed
        tproj = timestep_proj(timestep.reshape(-1).expand(b), 256)
        temb = (te["timestep_embedder"]["linear_2"](F.silu(te["timestep_embedder"]["linear_1"](tproj)))
                + te["text_embedder"]["linear_2"](F.silu(te["text_embedder"]["linear_1"](pooled))))
        c = self.context_embedder(context)
        for blk in self.transformer_blocks:
            x, c = blk(x, c, temb)
        scale, shift = self.norm_out["linear"](F.silu(temb)).chunk(2, dim=1)
        x = self.proj_out(_ln(x) * (1 + scale[:, None]) + shift[:, None])
        x = x.reshape(b, h, w, ps, ps, co).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, co, h * ps, w * ps)
