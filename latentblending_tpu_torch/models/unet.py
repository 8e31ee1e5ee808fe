"""SDXL UNet (UNet2DConditionModel-equivalent) as a torch nn.Module, NCHW.

Counterpart of latentblending_tpu/models/unet.py, with the HF checkpoint's
module tree (down_blocks.1.attentions.0.transformer_blocks.1.attn1.to_q …)
so a diffusers state dict loads as is. Includes SDXL micro-conditioning:
the pooled text embedding plus sinusoidal embeddings of the 6 time ids.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentblending_tpu_torch.models.configs import UNetConfig
from latentblending_tpu_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    conv3x3,
    timestep_embedding,
)

HEAD_DIM = 64  # fixed for SDXL; tiny configs scale the head count instead


class DownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, cin: int, cout: int, heads: int, depth: int, has_attn: bool,
                 add_downsample: bool):
        super().__init__()
        g, t = cfg.norm_num_groups, cfg.time_embed_dim
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if i == 0 else cout, cout, t, g, cfg.norm_eps) for i in range(cfg.layers_per_block)]
        )
        if has_attn:
            self.attentions = nn.ModuleList(
                [Transformer2D(cout, heads, HEAD_DIM, depth, cfg.cross_attention_dim, g)
                 for _ in range(cfg.layers_per_block)]
            )
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(cout)])

    def forward(self, x, temb, context):
        residuals = []
        for i, res in enumerate(self.resnets):
            x = res(x, temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
            residuals.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            residuals.append(x)
        return x, residuals


class UpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, cins: list[int], cout: int, heads: int, depth: int, has_attn: bool,
                 add_upsample: bool):
        super().__init__()
        g, t = cfg.norm_num_groups, cfg.time_embed_dim
        self.resnets = nn.ModuleList([ResnetBlock2D(cin, cout, t, g, cfg.norm_eps) for cin in cins])
        if has_attn:
            self.attentions = nn.ModuleList(
                [Transformer2D(cout, heads, HEAD_DIM, depth, cfg.cross_attention_dim, g) for _ in cins]
            )
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, x, skips, temb, context):
        for i, res in enumerate(self.resnets):
            x = res(torch.cat([x, skips.pop()], dim=1), temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        g, t = cfg.norm_num_groups, cfg.time_embed_dim
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, t, g, cfg.norm_eps) for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2D(ch, cfg.num_attention_heads[-1], HEAD_DIM, cfg.transformer_layers_per_block[-1],
                          cfg.cross_attention_dim, g)
        ])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UNet2DCondition(nn.Module):
    """The SDXL denoiser.

    forward(sample [B,4,h,w] (input-scaled), timestep scalar or [B],
            encoder_hidden_states [B,77,ctx], text_embeds [B,pooled_dim],
            time_ids [B,6]) → predicted epsilon [B,4,h,w].
    pooled_dim is the width of the pooled text embedding (1280 for SDXL).
    """

    def __init__(self, cfg: UNetConfig, pooled_dim: int):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        n = len(ch)
        self.conv_in = conv3x3(cfg.in_channels, ch[0])
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim)
        self.add_embedding = TimestepEmbedding(pooled_dim + 6 * cfg.addition_time_embed_dim, cfg.time_embed_dim)

        skip_ch = [ch[0]]
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for lvl in range(n):
            self.down_blocks.append(DownBlock(
                cfg, cin, ch[lvl], cfg.num_attention_heads[lvl], cfg.transformer_layers_per_block[lvl],
                cfg.down_block_has_attn[lvl], add_downsample=lvl < n - 1,
            ))
            skip_ch += [ch[lvl]] * cfg.layers_per_block + ([ch[lvl]] if lvl < n - 1 else [])
            cin = ch[lvl]
        self.mid_block = MidBlock(cfg)

        self.up_blocks = nn.ModuleList()
        x_ch = ch[-1]
        for lvl in reversed(range(n)):
            cins = []
            for _ in range(cfg.layers_per_block + 1):
                cins.append(x_ch + skip_ch.pop())
                x_ch = ch[lvl]
            self.up_blocks.append(UpBlock(
                cfg, cins, ch[lvl], cfg.num_attention_heads[lvl], cfg.transformer_layers_per_block[lvl],
                cfg.down_block_has_attn[lvl], add_upsample=lvl > 0,
            ))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0], eps=cfg.norm_eps)
        self.conv_out = conv3x3(ch[0], cfg.out_channels)

    def forward(self, sample, timestep, encoder_hidden_states, text_embeds, time_ids):
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        b = sample.shape[0]
        timestep = torch.as_tensor(timestep, device=sample.device)
        if timestep.ndim == 0:
            timestep = timestep.expand(b)
        t_emb = timestep_embedding(timestep, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        emb = self.time_embedding(t_emb.to(dtype))
        tid_emb = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim, cfg.flip_sin_to_cos,
                                     cfg.freq_shift).reshape(b, -1).to(dtype)
        emb = emb + self.add_embedding(torch.cat([text_embeds.to(dtype), tid_emb], dim=-1))

        context = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype))
        skips = [x]
        for blk in self.down_blocks:
            x, res = blk(x, emb, context)
            skips.extend(res)
        x = self.mid_block(x, emb, context)
        for blk in self.up_blocks:
            x = blk(x, skips, emb, context)
        return self.conv_out(F.silu(self.conv_norm_out(x)))
