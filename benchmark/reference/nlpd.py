"""Normalized Laplacian Pyramid Distance (Laparra, Ballé, Berardino and
Simoncelli, Electronic Imaging 2016) on luma, as the engine's gap metric
defines it: a 5-tap binomial Burt-Adelson pyramid of 5 levels (reflect
padding, bilinear half-pixel upsampling), each band divided by its blurred
local amplitude plus 0.17, the RMS of the band difference averaged over
the levels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_K5 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _blur(x):
    k = _K5.to(x.device)
    x = F.conv2d(F.pad(x, (0, 0, 2, 2), mode="reflect"), k.view(1, 1, 5, 1))
    return F.conv2d(F.pad(x, (2, 2, 0, 0), mode="reflect"), k.view(1, 1, 1, 5))


def _pyramid(x, levels):
    out = []
    for _ in range(levels - 1):
        down = _blur(x)[:, :, ::2, ::2]
        up = _blur(F.interpolate(down, size=tuple(x.shape[2:]), mode="bilinear", align_corners=False))
        out.append(x - up)
        x = down
    return out + [x]


def nlpd(a: torch.Tensor, b: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """a, b [B,H,W,3] in [-1,1] → [B] distances."""
    w = torch.tensor([0.299, 0.587, 0.114], device=a.device)
    ya = (((a.float() + 1.0) / 2.0) @ w)[:, None]
    yb = (((b.float() + 1.0) / 2.0) @ w)[:, None]
    total = torch.zeros(a.shape[0], device=a.device)
    for ba, bb in zip(_pyramid(ya, levels), _pyramid(yb, levels)):
        amp = 0.5 * (_blur(ba.abs()) + _blur(bb.abs())) + 0.17
        total = total + torch.sqrt(((ba - bb) / amp).pow(2).mean(dim=(1, 2, 3)) + 1e-12)
    return total / levels
