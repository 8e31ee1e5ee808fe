"""Weight-free perceptual distance: Normalized Laplacian Pyramid Distance
(Laparra, Ballé, Berardino & Simoncelli, Electronic Imaging 2016).

Counterpart of latentblending_tpu/models/perceptual.py: the engine's
default gap metric when no LPIPS weights are given. Public tensors keep the
JAX layout ([B,H,W,3] images in [-1,1]); the pyramid runs on a one-channel
NCHW luma tensor. The 5-tap binomial blur pads by reflection, and the
pyramid's upsampling is bilinear with half-pixel centres
(F.interpolate(align_corners=False)), which is what the JAX package's
jax.image.resize(method="linear") computes for a 2× upsample.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# 5-tap binomial filter (the classic Burt-Adelson pyramid kernel, a=0.375)
_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap blur, depthwise, reflect padding. x: [B,C,H,W]."""
    c = x.shape[1]
    k = torch.as_tensor(_K5, device=x.device, dtype=x.dtype)
    x = F.conv2d(F.pad(x, (0, 0, 2, 2), mode="reflect"), k.view(1, 1, 5, 1).expand(c, 1, 5, 1), groups=c)
    return F.conv2d(F.pad(x, (2, 2, 0, 0), mode="reflect"), k.view(1, 1, 1, 5).expand(c, 1, 1, 5), groups=c)


def _down2(x: torch.Tensor) -> torch.Tensor:
    return _blur(x)[:, :, ::2, ::2]


def _up2(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    return _blur(F.interpolate(x, size=hw, mode="bilinear", align_corners=False))


def laplacian_pyramid(x: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Burt-Adelson Laplacian pyramid of [B,C,H,W]; the last entry is the
    low-pass residual."""
    pyr = []
    for _ in range(levels - 1):
        down = _down2(x)
        pyr.append(x - _up2(down, tuple(x.shape[2:])))
        x = down
    pyr.append(x)
    return pyr


def nlpd_distance(img0: torch.Tensor, img1: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """NLPD of [B,H,W,3] images in [-1,1] → [B] (luma only; per level the
    RMS of the divisively normalised band difference, averaged over levels)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=img0.device)
    y0 = (((img0.float() + 1.0) / 2.0) @ w)[:, None]
    y1 = (((img1.float() + 1.0) / 2.0) @ w)[:, None]
    c = 0.17  # stabilizer ~ mean band amplitude scale of natural images
    total = torch.zeros((img0.shape[0],), dtype=torch.float32, device=img0.device)
    for b0, b1 in zip(laplacian_pyramid(y0, levels), laplacian_pyramid(y1, levels)):
        sigma = 0.5 * (_blur(b0.abs()) + _blur(b1.abs()))
        n0 = b0 / (sigma + c)
        n1 = b1 / (sigma + c)
        total = total + torch.sqrt(torch.mean((n0 - n1) ** 2, dim=(1, 2, 3)) + 1e-12)
    return total / levels


def prep_uint8(img, device=None) -> torch.Tensor:
    """uint8 image(s) [H,W,3] or [B,H,W,3] (anything np.asarray takes) →
    float32 [B,H,W,3] in [-1,1] on `device`."""
    x = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device) / 255.0 * 2.0 - 1.0
    return x[None] if x.ndim == 3 else x


def staging_device(device: Optional[torch.device]) -> torch.device:
    """Where a scorer's distance() stages its uint8 images: the device it
    was built for, else the card (no CPU fallback: pass device="cpu")."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("scorer: no CUDA device; build it with device=\"cpu\" to score on the CPU")
    return torch.device("cuda")


def pair_device(device: Optional[torch.device], imgs_a: torch.Tensor, imgs_b: torch.Tensor) -> torch.device:
    """The device distance_batch computes on: its inputs' own. A scorer
    built for a device refuses inputs that lie elsewhere rather than copy
    them."""
    d = imgs_a.device
    if imgs_b.device != d:
        raise ValueError(f"scorer: pairs on {d} and {imgs_b.device}")
    if device is not None and (device.type != d.type or device.index not in (None, d.index)):
        raise ValueError(f"scorer built for {device} was given images on {d}")
    return d


class NLPDScorer:
    """distance(uint8 imgs) → float; distance_batch([-1,1] [B,H,W,3] pairs) → [B].

    distance_batch computes on its inputs' device; distance stages its
    images on `device` (the engine passes its holder's), the card when
    None."""

    def __init__(self, levels: int = 5, device=None):
        self.levels = int(levels)
        self.device = None if device is None else torch.device(device)

    @staticmethod
    def _prep(img, device=None) -> torch.Tensor:
        return prep_uint8(img, device)

    def distance(self, img_a, img_b) -> float:
        dev = staging_device(self.device)
        return float(self.distance_batch(self._prep(img_a, dev), self._prep(img_b, dev))[0])

    def distance_batch(self, imgs_a: torch.Tensor, imgs_b: torch.Tensor) -> torch.Tensor:
        pair_device(self.device, imgs_a, imgs_b)
        return nlpd_distance(imgs_a, imgs_b, self.levels)
