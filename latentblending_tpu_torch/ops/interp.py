"""Interpolation primitives: spherical / linear latent mixing, in PyTorch.

Counterpart of latentblending_tpu/ops/interp.py, with the same numerics:
the slerp angle math accumulates the dot product and norms in float32
(not float64) and clamps the cosine to ±(1 − 1e-7); results are cast back
to the input dtype. These are the plain tensor versions; the batched slerp
on the hot path goes through the hand-written kernel in ops/slerp.py.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-7


def _slerp_weights(dot: torch.Tensor, fract: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical interpolation weights (s0, s1) from a cosine and a fraction."""
    dot = torch.clamp(dot, -1.0 + _EPS, 1.0 - _EPS)
    theta_0 = torch.arccos(dot)
    sin_theta_0 = torch.sin(theta_0)
    theta_t = theta_0 * fract
    s0 = torch.sin(theta_0 - theta_t) / sin_theta_0
    s1 = torch.sin(theta_t) / sin_theta_0
    return s0, s1


def interpolate_spherical(p0: torch.Tensor, p1: torch.Tensor, fract_mixing) -> torch.Tensor:
    """Slerp between two equally-shaped tensors, treated as one flat vector."""
    a = p0.float()
    b = p1.float()
    norm = torch.clamp(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b), min=1e-20)
    dot = torch.sum(a * b) / norm
    fract = torch.as_tensor(fract_mixing, dtype=torch.float32, device=a.device)
    s0, s1 = _slerp_weights(dot, fract)
    return (a * s0 + b * s1).to(p0.dtype)


def interpolate_spherical_batched(p0: torch.Tensor, p1: torch.Tensor, fract: torch.Tensor) -> torch.Tensor:
    """Per-element slerp over the leading batch axis: p0, p1 [B, ...]; fract [B]."""
    a = p0.float()
    b = p1.float()
    red = tuple(range(1, a.ndim))
    norm = torch.clamp(torch.sqrt(torch.sum(a * a, dim=red) * torch.sum(b * b, dim=red)), min=1e-20)
    dot = torch.sum(a * b, dim=red) / norm
    s0, s1 = _slerp_weights(dot, fract.to(device=a.device, dtype=torch.float32))
    bshape = (-1,) + (1,) * (a.ndim - 1)
    return (a * s0.reshape(bshape) + b * s1.reshape(bshape)).to(p0.dtype)


def interpolate_linear(p0, p1, fract_mixing):
    """Lerp, with the uint8 round-trip for host images."""
    if isinstance(p0, np.ndarray) and p0.dtype == np.uint8:
        a = p0.astype(np.float32)
        b = np.asarray(p1, np.float32)
        out = (1.0 - fract_mixing) * a + fract_mixing * b
        return np.clip(out, 0, 255).astype(np.uint8)
    return (1.0 - fract_mixing) * p0 + fract_mixing * p1


def interpolate_linear_pytree(t0, t1, fract_mixing) -> tuple:
    """Lerp each tensor of two matching sequences (conditioning mixes) in
    float32, cast back to each tensor's dtype."""
    f = float(fract_mixing)
    return tuple(((1.0 - f) * a.float() + f * b.float()).to(a.dtype) for a, b in zip(t0, t1))
