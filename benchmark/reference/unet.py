"""Plain SDXL UNet (diffusers UNet2DConditionModel semantics), float32,
with HF checkpoint key names.

A frozen copy of the repository's test reference (tests/torch_ref_unet.py),
reading the benchmark's configuration file (HF keys) and computing
attention in plain matmuls. As diffusers does, GEGLU gates with the exact
(erf) GELU.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Conv2d, Linear, Precision, attention, group_norm, layer_norm

HEAD_DIM = 64


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)  # flip_sin_to_cos


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim, p):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim, prec=p)
        self.linear_2 = Linear(dim, dim, prec=p)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, groups, eps, p):
        super().__init__()
        self.norm1 = group_norm(groups, in_ch, eps)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, prec=p)
        self.time_emb_proj = Linear(temb_dim, out_ch, prec=p)
        self.norm2 = group_norm(groups, out_ch, eps)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, prec=p)
        self.has_shortcut = in_ch != out_ch
        if self.has_shortcut:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1, prec=p)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.conv_shortcut(x) if self.has_shortcut else x) + h


class Attention(nn.Module):
    def __init__(self, query_dim, heads, context_dim, p):
        super().__init__()
        inner = heads * HEAD_DIM
        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=False, prec=p)
        self.to_k = Linear(context_dim, inner, bias=False, prec=p)
        self.to_v = Linear(context_dim, inner, bias=False, prec=p)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, prec=p)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, lq, _ = x.shape
        lk = ctx.shape[1]
        q = self.to_q(x).view(b, lq, self.heads, HEAD_DIM).transpose(1, 2)
        k = self.to_k(ctx).view(b, lk, self.heads, HEAD_DIM).transpose(1, 2)
        v = self.to_v(ctx).view(b, lk, self.heads, HEAD_DIM).transpose(1, 2)
        out = attention(q, k, v).transpose(1, 2).reshape(b, lq, self.heads * HEAD_DIM)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim, inner, p):
        super().__init__()
        self.proj = Linear(dim, inner * 2, prec=p)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, p):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, p), nn.Identity(), Linear(dim * 4, dim, prec=p)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, context_dim, p):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.attn1 = Attention(dim, heads, dim, p)
        self.norm2 = layer_norm(dim)
        self.attn2 = Attention(dim, heads, context_dim, p)
        self.norm3 = layer_norm(dim)
        self.ff = FeedForward(dim, p)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, heads, depth, channels, context_dim, groups, p):
        super().__init__()
        inner = heads * HEAD_DIM
        self.norm = group_norm(groups, channels, 1e-6)
        self.proj_in = Linear(channels, inner, prec=p)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, context_dim, p) for _ in range(depth)])
        self.proj_out = Linear(inner, channels, prec=p)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.proj_in(y)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        y = self.proj_out(y)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class DownBlock(nn.Module):
    def __init__(self, cfg, in_ch, out_ch, heads, depth, has_attn, add_down, p):
        super().__init__()
        temb = cfg["block_out_channels"][0] * 4
        g, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList() if has_attn else None
        for i in range(cfg["layers_per_block"]):
            self.resnets.append(ResnetBlock(in_ch if i == 0 else out_ch, out_ch, temb, g, eps, p))
            if has_attn:
                self.attentions.append(Transformer2D(heads, depth, out_ch, cfg["cross_attention_dim"], g, p))
        if add_down:
            self.downsamplers = nn.ModuleList([nn.ModuleDict({"conv": Conv2d(out_ch, out_ch, 3, 2, 1, prec=p)})])
        self.add_down = add_down

    def forward(self, x, temb, ctx):
        res = []
        for i, rn in enumerate(self.resnets):
            x = rn(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx)
            res.append(x)
        if self.add_down:
            x = self.downsamplers[0]["conv"](x)
            res.append(x)
        return x, res


class UpBlock(nn.Module):
    def __init__(self, cfg, prev_ch, out_ch, skip_chs, heads, depth, has_attn, add_up, p):
        super().__init__()
        temb = cfg["block_out_channels"][0] * 4
        g, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList() if has_attn else None
        ch = prev_ch
        for i in range(cfg["layers_per_block"] + 1):
            self.resnets.append(ResnetBlock(ch + skip_chs[i], out_ch, temb, g, eps, p))
            ch = out_ch
            if has_attn:
                self.attentions.append(Transformer2D(heads, depth, out_ch, cfg["cross_attention_dim"], g, p))
        if add_up:
            self.upsamplers = nn.ModuleList([nn.ModuleDict({"conv": Conv2d(out_ch, out_ch, 3, padding=1, prec=p)})])
        self.add_up = add_up

    def forward(self, x, skips, temb, ctx):
        for i, rn in enumerate(self.resnets):
            x = rn(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx)
        if self.add_up:
            x = self.upsamplers[0]["conv"](F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


class MidBlock(nn.Module):
    def __init__(self, cfg, p):
        super().__init__()
        ch = cfg["block_out_channels"][-1]
        temb = cfg["block_out_channels"][0] * 4
        g, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, temb, g, eps, p), ResnetBlock(ch, ch, temb, g, eps, p)])
        self.attentions = nn.ModuleList([Transformer2D(
            cfg["attention_head_dim"][-1], cfg["transformer_layers_per_block"][-1], ch,
            cfg["cross_attention_dim"], g, p)])

    def forward(self, x, temb, ctx):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, ctx)
        return self.resnets[1](x, temb)


class UNet(nn.Module):
    """forward(sample [B,4,h,w], timestep [B], encoder_hidden_states
    [B,77,ctx], text_embeds [B,pooled], time_ids [B,6]) → epsilon [B,4,h,w].
    `attention_head_dim` holds the head count per level (the SDXL config's
    quirk); the head size is 64."""

    def __init__(self, cfg: dict, prec: Precision | None = None):
        super().__init__()
        p = prec or Precision()
        self.cfg = cfg
        chans = cfg["block_out_channels"]
        c0 = chans[0]
        temb = c0 * 4
        self.conv_in = Conv2d(cfg["in_channels"], c0, 3, padding=1, prec=p)
        self.time_embedding = TimestepEmbedding(c0, temb, p)
        self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"], temb, p)
        has_attn = ["CrossAttn" in t for t in cfg["down_block_types"]]
        heads, depths = cfg["attention_head_dim"], cfg["transformer_layers_per_block"]
        n = len(chans)
        self.down_blocks = nn.ModuleList([
            DownBlock(cfg, chans[max(lvl - 1, 0)], chans[lvl], heads[lvl], depths[lvl], has_attn[lvl], lvl < n - 1, p)
            for lvl in range(n)])
        self.mid_block = MidBlock(cfg, p)
        skip_chs_all = [c0]
        for lvl in range(n):
            skip_chs_all += [chans[lvl]] * cfg["layers_per_block"]
            if lvl < n - 1:
                skip_chs_all.append(chans[lvl])
        self.up_blocks = nn.ModuleList()
        prev = chans[-1]
        for lvl in reversed(range(n)):
            take = cfg["layers_per_block"] + 1
            skips = list(reversed(skip_chs_all[-take:]))
            del skip_chs_all[-take:]
            self.up_blocks.append(UpBlock(cfg, prev, chans[lvl], skips, heads[lvl], depths[lvl], has_attn[lvl],
                                          lvl > 0, p))
            prev = chans[lvl]
        self.conv_norm_out = group_norm(cfg["norm_num_groups"], c0, cfg["norm_eps"])
        self.conv_out = Conv2d(c0, cfg["out_channels"], 3, padding=1, prec=p)

    def forward(self, sample, timestep, encoder_hidden_states, text_embeds, time_ids):
        b = sample.shape[0]
        emb = self.time_embedding(timestep_embedding(timestep.expand(b), self.cfg["block_out_channels"][0]))
        tid = timestep_embedding(time_ids.reshape(-1), self.cfg["addition_time_embed_dim"]).reshape(b, -1)
        emb = emb + self.add_embedding(torch.cat([text_embeds, tid], dim=-1))
        x = self.conv_in(sample)
        skips = [x]
        for blk in self.down_blocks:
            x, res = blk(x, emb, encoder_hidden_states)
            skips += res
        x = self.mid_block(x, emb, encoder_hidden_states)
        for blk in self.up_blocks:
            x = blk(x, skips, emb, encoder_hidden_states)
        return self.conv_out(F.silu(self.conv_norm_out(x)))
