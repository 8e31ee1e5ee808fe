"""Plain AutoencoderKL decoder (diffusers AutoencoderKL.decode semantics),
float32, with HF checkpoint key names (post_quant_conv, decoder.*). The
configuration's `shift_factor` (absent or null: none) is added after the
division by `scaling_factor`; `use_post_quant_conv` false (absent: true)
leaves post_quant_conv out, as SD3's decoder does.

A frozen copy of the repository's test reference (tests/torch_ref_vae.py),
reading the benchmark's configuration file, with the mid-block attention
in plain matmuls.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import Conv2d, Linear, Precision, attention, group_norm

_EPS = 1e-6


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, groups, p):
        super().__init__()
        self.norm1 = group_norm(groups, in_ch, _EPS)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, prec=p)
        self.norm2 = group_norm(groups, out_ch, _EPS)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, prec=p)
        self.has_shortcut = in_ch != out_ch
        if self.has_shortcut:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1, prec=p)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.conv_shortcut(x) if self.has_shortcut else x) + h


class VAEAttention(nn.Module):
    def __init__(self, ch, groups, p):
        super().__init__()
        self.group_norm = group_norm(groups, ch, _EPS)
        self.to_q = Linear(ch, ch, prec=p)
        self.to_k = Linear(ch, ch, prec=p)
        self.to_v = Linear(ch, ch, prec=p)
        self.to_out = nn.ModuleList([Linear(ch, ch, prec=p)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(y)[:, None], self.to_k(y)[:, None], self.to_v(y)[:, None]
        out = self.to_out[0](attention(q, k, v)[:, 0])
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class MidBlock(nn.Module):
    def __init__(self, ch, groups, p):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, groups, p), ResnetBlock(ch, ch, groups, p)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups, p)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class UpBlock(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, add_up, p):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if i == 0 else out_ch, out_ch, groups, p) for i in range(layers)])
        self.add_up = add_up
        if add_up:
            self.upsamplers = nn.ModuleList([nn.ModuleDict({"conv": Conv2d(out_ch, out_ch, 3, padding=1, prec=p)})])

    def forward(self, x):
        for rn in self.resnets:
            x = rn(x)
        if self.add_up:
            x = self.upsamplers[0]["conv"](F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: dict, p):
        super().__init__()
        chans = list(reversed(cfg["block_out_channels"]))
        g = cfg["norm_num_groups"]
        self.conv_in = Conv2d(cfg["latent_channels"], chans[0], 3, padding=1, prec=p)
        self.mid_block = MidBlock(chans[0], g, p)
        self.up_blocks = nn.ModuleList()
        prev = chans[0]
        for i, ch in enumerate(chans):
            self.up_blocks.append(UpBlock(prev, ch, cfg["layers_per_block"] + 1, g, i < len(chans) - 1, p))
            prev = ch
        self.conv_norm_out = group_norm(g, chans[-1], _EPS)
        self.conv_out = Conv2d(chans[-1], cfg["out_channels"], 3, padding=1, prec=p)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: dict, prec: Precision | None = None):
        super().__init__()
        p = prec or Precision()
        self.cfg = cfg
        self.decoder = Decoder(cfg, p)
        if cfg.get("use_post_quant_conv", True):
            self.post_quant_conv = Conv2d(cfg["latent_channels"], cfg["latent_channels"], 1, prec=p)

    def forward(self, latents_bhwc: torch.Tensor) -> torch.Tensor:
        """Final latents [B,h,w,c] → (uint8 images [B,H,W,3], [-1,1] images):
        divided by the scaling factor, shifted, decoded, clamped to [-1,1],
        then floor((x/2 + 1/2)·255 + 1/2)."""
        z = latents_bhwc.float().permute(0, 3, 1, 2) / self.cfg["scaling_factor"]
        if self.cfg.get("shift_factor") is not None:
            z = z + self.cfg["shift_factor"]
        if hasattr(self, "post_quant_conv"):
            z = self.post_quant_conv(z)
        img = self.decoder(z).permute(0, 2, 3, 1).clamp(-1.0, 1.0)
        return pm1_to_uint8(img), img


def pm1_to_uint8(img: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(img / 2 + 0.5, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def pm1_to_i420(img: torch.Tensor) -> list[torch.Tensor]:
    """[-1,1] images [B,H,W,3] → uint8 planes (Y [B,H,W], Cb and Cr
    [B,H/2,W/2]): JFIF full-range BT.601 (ITU-T T.871) on the [0,255]
    values, chroma as the mean of each 2x2 block, each rounded half up."""
    rgb = torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    B, H, W = y.shape

    def pool(c):
        return c.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))

    def u8(x):
        return torch.clamp(x + 0.5, 0.0, 255.0).to(torch.uint8)

    return [u8(y), u8(pool(cb)), u8(pool(cr))]


def i420_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """uint8 planes → uint8 RGB [B,H,W,3]: each chroma sample over its 2x2
    block, the JFIF inverse, rounded half up."""
    up = lambda c: c.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0  # noqa: E731
    yf, cbf, crf = y.float(), up(cb), up(cr)
    rgb = torch.stack([yf + 1.402 * crf, yf - 0.344136286 * cbf - 0.714136286 * crf, yf + 1.772 * cbf], dim=-1)
    return torch.clamp(rgb + 0.5, 0.0, 255.0).to(torch.uint8)
