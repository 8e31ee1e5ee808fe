"""SDXL VAE (AutoencoderKL-equivalent) as a torch nn.Module, NCHW.

Counterpart of latentblending_tpu/models/vae.py with the HF checkpoint's
module tree (encoder/decoder.down_blocks/up_blocks.i.resnets.j,
mid_block.attentions.0, quant_conv, post_quant_conv: 248 tensors at full
size). The full tree is built so a checkpoint loads completely; only
`decode` runs in this port so far. The encoder mirrors the JAX package's
(symmetric stride-2 padding in its downsamplers).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from latentblending_tpu_torch.models.configs import VAEConfig
from latentblending_tpu_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    VAEAttention,
    conv3x3,
)

_VAE_EPS = 1e-6


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, None, groups, _VAE_EPS) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, groups: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout, None, groups, _VAE_EPS) for j in range(n)]
        )
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.upsamplers[0](x) if hasattr(self, "upsamplers") else x


class _DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, groups: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(cin if j == 0 else cout, cout, None, groups, _VAE_EPS) for j in range(n)]
        )
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(cout)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.downsamplers[0](x) if hasattr(self, "downsamplers") else x


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(reversed(cfg.block_out_channels))  # [512, 512, 256, 128]
        g = cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.latent_channels, chans[0])
        self.mid_block = _MidBlock(chans[0], g)
        self.up_blocks = nn.ModuleList(
            [_UpBlock(chans[max(i - 1, 0)], ch, cfg.layers_per_block + 1, g, i < len(chans) - 1)
             for i, ch in enumerate(chans)]
        )
        self.conv_norm_out = GroupNorm(g, chans[-1], eps=_VAE_EPS)
        self.conv_out = conv3x3(chans[-1], cfg.out_channels)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(cfg.block_out_channels)
        g = cfg.norm_num_groups
        self.conv_in = conv3x3(cfg.in_channels, chans[0])
        self.down_blocks = nn.ModuleList(
            [_DownBlock(chans[max(i - 1, 0)], ch, cfg.layers_per_block, g, i < len(chans) - 1)
             for i, ch in enumerate(chans)]
        )
        self.mid_block = _MidBlock(chans[-1], g)
        self.conv_norm_out = GroupNorm(g, chans[-1], eps=_VAE_EPS)
        self.conv_out = conv3x3(chans[-1], 2 * cfg.latent_channels)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    """AutoencoderKL; decode() is the hot path (keyframe rendering)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = VAEEncoder(cfg)
        self.decoder = VAEDecoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [B,4,h,w] (already divided by scaling_factor) → image
        [B,3,H,W] in about [-1,1]."""
        z = self.post_quant_conv(latents.to(self.post_quant_conv.weight.dtype))
        return self.decoder(z)

    forward = decode
