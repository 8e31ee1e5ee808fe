"""Image resize with OpenCV's INTER_AREA rule, on the device.

Counterpart of the `cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)`
that the JAX package's `SDXLHolder.image2latent` runs on the host
(latentblending_tpu/runtime/holder.py). The port's hosts have no OpenCV,
so the rule is reproduced here: the resize is separable, one weight
matrix per axis, built on the host in float64; the device applies them
with two matrix products (plain `torch.matmul`, as the JAX package leaves
its resize to OpenCV outside any kernel) and rounds to uint8 as cv2 does.

OpenCV's INTER_AREA is two rules (imgproc resize.cpp):

- both axes shrink or keep their size: each output pixel is the mean of
  the source cell it covers, fractional pixels at the cell's edges
  weighted by their covered fraction (`computeResizeAreaTab`; at integer
  factors a plain box mean);
- any axis grows: both axes take the linear rule with area coefficients:
  output pixel d reads source sx = floor(d·scale) and sx + 1 with weights
  1 - f and f, f = frac((d + 1) - (sx + 1)/scale) where positive, else 0;
  the last source pixel repeats at the edge.

Results round halves up, as cv2's uint8 box mean does. cv2 computes the
linear rule on uint8 in 11-bit fixed point, so results may differ from it
by 1 at a rounding boundary.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of the shrinking rule (OpenCV computeResizeAreaTab)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += (s1 - f1) / cell
        w[d, s1:s2] += 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] += min(f2 - s2, 1.0, cell) / cell
    return w


def _linear_area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of the linear rule with area coefficients."""
    scale = n_in / n_out
    inv = n_out / n_in
    w = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        sx = math.floor(d * scale)
        f = np.float32((d + 1) - (sx + 1) * inv)  # OpenCV keeps the fraction in float
        f = 0.0 if f <= 0 else float(f - math.floor(f))
        if sx >= n_in - 1:
            sx, f = n_in - 1, 0.0
        w[d, sx] += 1.0 - f
        if f:
            w[d, sx + 1] += f
    return w


def area_weights(in_hw: tuple[int, int], out_hw: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """(rows [H, H0], columns [W, W0]) weight matrices of INTER_AREA from
    in_hw = (H0, W0) to out_hw = (H, W)."""
    (h0, w0), (h, w) = in_hw, out_hw
    if min(h0, w0, h, w) < 1:
        raise ValueError(f"resize from {in_hw} to {out_hw}: sizes must be positive")
    build = _area_matrix if (h0 >= h and w0 >= w) else _linear_area_matrix
    return build(h0, h), build(w0, w)


def resize_area(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Image [H0, W0, C] → [height, width, C] on x's device, as
    cv2.resize(img, (width, height), INTER_AREA) gives it: uint8 in, uint8
    out; any other dtype in, float32 out (unrounded)."""
    if x.ndim != 3:
        raise ValueError(f"resize_area takes an [H, W, C] image, got shape {tuple(x.shape)}")
    h0, w0, c = x.shape
    wy, wx = area_weights((h0, w0), (int(height), int(width)))
    wy = torch.from_numpy(wy.astype(np.float32)).to(x.device)
    wx = torch.from_numpy(wx.astype(np.float32)).to(x.device)
    rows = torch.matmul(wy, x.float().reshape(h0, w0 * c)).reshape(int(height), w0, c)
    out = torch.matmul(wx, rows)  # [W, W0] @ [H, W0, C] → [H, W, C]
    if x.dtype != torch.uint8:
        return out
    return torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)
