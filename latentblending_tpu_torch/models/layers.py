"""Shared building blocks of the SDXL stack, as torch nn.Modules in NCHW.

Counterpart of latentblending_tpu/models/layers.py. Module and parameter
names are the HF/diffusers checkpoint keys ("to_out.0", "ff.net.0.proj",
ModuleList indices), with torch layouts (Linear [out,in], Conv OIHW), so a
diffusers state dict loads without renames or transposes.

Numerics follow the JAX package, not diffusers, where the two differ:
- GroupNorm and LayerNorm compute in float32 and keep float32 parameters
  whatever the compute dtype;
- GEGLU's gate is the tanh-approximated GELU (flax `nn.gelu` default),
  where diffusers uses the exact erf form;
- attention outside the kernel gate is plain matmul + softmax in float32,
  as jax.nn.dot_product_attention computes it.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentblending_tpu_torch.ops.attention import attention_reference, flash_attention


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding: timesteps [B] → [B, dim] float32."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class GroupNorm(nn.GroupNorm):
    """GroupNorm over channels (dim 1) with float32 statistics and params."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with float32 statistics and params."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class TimestepEmbedding(nn.Module):
    """linear_1 → silu → linear_2 (diffusers TimestepEmbedding naming)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


def _use_flash_attention(lq: int, lk: int, mask, is_cuda: bool) -> bool:
    """Kernel gate for big self-attention maps on the GPU — the rules of the
    JAX package's gate, with `is_cuda` in place of the TPU backend check.

    The plain path materialises [B,H,L,L] logits; the kernel keeps memory
    O(L·tile). Cross-attention (lk=77) stays on the plain path. LB_FLASH=0
    disables the kernel, LB_FLASH_MIN sets the minimum length (1024)."""
    if os.environ.get("LB_FLASH") == "0":
        return False
    min_len = int(os.environ.get("LB_FLASH_MIN", "1024"))
    return is_cuda and mask is None and lq == lk and lq >= min_len and lq % 512 == 0


class Attention(nn.Module):
    """Multi-head attention with separate q/k/v projections; context=None is
    self-attention. x [B, L, query_dim] → [B, L, query_dim]."""

    def __init__(self, query_dim: int, heads: int, dim_head: int = 64, context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None, mask=None) -> torch.Tensor:
        ctx = x if context is None else context
        b, lq = x.shape[0], x.shape[1]
        lk = ctx.shape[1]
        q = self.to_q(x).view(b, lq, self.heads, self.dim_head)
        k = self.to_k(ctx).view(b, lk, self.heads, self.dim_head)
        v = self.to_v(ctx).view(b, lk, self.heads, self.dim_head)
        if _use_flash_attention(lq, lk, mask, q.is_cuda):
            out = flash_attention(q, k, v)
        else:
            out = attention_reference(q, k, v, bias=mask)
        return self.to_out[0](out.reshape(b, lq, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward: net.0 (dim → 8·dim, gated to 4·dim), net.2 (4·dim → dim).
    net.1 is diffusers' dropout slot, which holds no parameters."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim_head, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer, linear projections (SDXL): GN → proj_in → blocks
    → proj_out → + residual. x [B, C, H, W]."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int, context_dim: int, groups: int = 32):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)]
        )
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_in(y)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        y = self.proj_out(y)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: Optional[int] = None, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=eps)
        self.conv1 = conv3x3(cin, cout)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv2 = conv3x3(cout, cout)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEAttention(nn.Module):
    """Single-head attention of the VAE mid block (group_norm, to_q/k/v,
    to_out.0). x [B, C, H, W]; the head dim is C (512 at full size)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        L = h * w
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, L, c)
        q = self.to_q(y).unsqueeze(2)
        k = self.to_k(y).unsqueeze(2)
        v = self.to_v(y).unsqueeze(2)
        if _use_flash_attention(L, L, None, q.is_cuda):
            out = flash_attention(q, k, v)
        else:
            out = attention_reference(q, k, v)
        out = self.to_out[0](out.reshape(b, L, c))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


_NORMS = (nn.GroupNorm, nn.LayerNorm)


@torch.no_grad()
def init_like_jax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter in place the way the JAX package's flax
    `init` does: Linear/Conv weights truncated-normal with variance
    1/fan_in (flax lecun_normal), embeddings normal with std 1/√features,
    CLIP's position table normal(0.01), biases 0, norm scales 1. Values are
    drawn in float32 on the module's device, then stored in each tensor's
    dtype."""
    trunc = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
    for name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
                continue
            if isinstance(mod, _NORMS):
                p.fill_(1.0)
                continue
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if isinstance(mod, nn.Embedding):
                std = 0.01 if name.endswith("position_embedding") else p.shape[1] ** -0.5
                w.normal_(0.0, std, generator=generator)
            else:
                fan_in = p[0].numel()
                std = fan_in ** -0.5 / trunc
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            p.copy_(w)
    return module


def cast_keep_norms_f32(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """module.to(dtype) with GroupNorm/LayerNorm parameters kept float32 (the
    JAX package creates them in float32 whatever the param dtype)."""
    module.to(dtype)
    for mod in module.modules():
        if isinstance(mod, _NORMS):
            mod.float()
    return module
