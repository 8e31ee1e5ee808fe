"""M1: the MMDiT's adaLN-Zero modulation and gated residuals — the
hand-written CUDA kernel and its plain PyTorch version.

Replaces no TPU kernel: the JAX package has no SD3. A JointTransformerBlock
(models/mmdit.py) normalises each stream before its attention and its
feed-forward, modulated by adaLN vectors from the time embedding, and adds
each branch's output back through a gate:

    ln_modulate(x, shift, scale)      = bf16(LN(x) * (1 + scale) + shift)
    gated_residual(x, gate, y)        = bf16(x + gate * y)
    gated_residual(x, gate, y, shift, scale)
                                      = (x', ln_modulate(x', shift, scale))

with x, y [B, L, D], the vectors [B, D], LN without affine parameters (eps
1e-6), its statistics and the modulation in float32, one rounding a result;
the fused form normalises the rounded x'. The plain versions are the
unfused expressions the MMDiT computed before M1 (five norm sites, four
residuals a block).

Kernel: csrc/adaln_bf16.cu, one bf16 pass over the token rows (a row in a
CTA's registers, the row's statistics reduced in the CTA, the vectors read
once a CTA), counted as `M1` a launch.

`ln_modulate` and `gated_residual` take CUDA tensors to the kernel and CPU
tensors to the plain version; nothing falls back from one to the other. A
CUDA input the kernel does not take (`takes`: bf16 x and y, contiguous, D a
multiple of 8 up to MAX_D, vectors [B, D] whose rows are contiguous, all
16-byte aligned) raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from latentblending_tpu_torch import profiling

EPS = 1e-6
MAX_D = 8192  # the widest row a CTA of the kernel holds (8 warps x 4 loads of 8)


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine parameters, eps 1e-6, in float32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=EPS)


def _modulate(norm_x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return norm_x * (1.0 + scale.float()[:, None]) + shift.float()[:, None]


def ln_modulate_reference(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of ln_modulate, in x's dtype."""
    return _modulate(_ln(x), shift, scale).to(x.dtype)


def gated_residual_reference(x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor, shift=None, scale=None):
    """Plain version of gated_residual: x', or (x', its modulated norm)."""
    x = (x.float() + gate.float()[:, None] * y.float()).to(x.dtype)
    if shift is None:
        return x
    return x, ln_modulate_reference(x, shift, scale)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def takes(x: torch.Tensor, vectors, y: torch.Tensor | None = None) -> bool:
    """Whether M1 computes on x [B, L, D], the branch output y (x's shape)
    and the modulation vectors [B, D] (the device aside)."""
    if x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous() or not _aligned(x):
        return False
    B, _, D = x.shape
    if D % 8 or D > MAX_D:
        return False
    if y is not None and (y.dtype != x.dtype or y.shape != x.shape or not y.is_contiguous() or not _aligned(y)):
        return False
    return all(v.dtype == x.dtype and tuple(v.shape) == (B, D) and v.stride(1) == 1 and v.stride(0) % 8 == 0
               and _aligned(v) for v in vectors)


def _on_card(t: torch.Tensor) -> bool:
    """Whether t goes to the kernel (a CUDA tensor); the one place a test may
    stand the card in, with `_launch`."""
    return t.is_cuda


def _check(name: str, x: torch.Tensor, vectors, y: torch.Tensor | None = None) -> None:
    tensors = [x, *vectors] + ([y] if y is not None else [])
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{name}: bfloat16 only, got {[t.dtype for t in tensors]}")
    if any(not _on_card(t) or t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on x's CUDA device")
    if not takes(x, vectors, y):
        raise ValueError(f"{name}: M1 takes x, y [B, L, D] contiguous with D a multiple of 8 up to {MAX_D} and "
                         f"vectors [B, D] with contiguous rows, all 16-byte aligned; got x {tuple(x.shape)} "
                         f"{x.stride()}, vectors {[(tuple(v.shape), v.stride()) for v in vectors]}"
                         + ("" if y is None else f", y {tuple(y.shape)} {y.stride()}"))


def _launch(name: str, *args) -> None:
    """Run the C entry `name` on x's device and its current stream (tensors
    as pointers, 0 for a missing one); raises on a launch error."""
    from latentblending_tpu_torch.ops import _build

    _build.launch(name, *args)


def ln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """bf16(LN(x) * (1 + scale) + shift): x [B, L, D], shift, scale [B, D]."""
    if not _on_card(x):
        return ln_modulate_reference(x, shift, scale)
    _check("ln_modulate", x, (shift, scale))
    out = torch.empty_like(x)
    _launch("lb_adaln_modulate_bf16", x, shift, shift.stride(0), scale, scale.stride(0), out, *x.shape)
    profiling.count("M1")
    return out


def gated_residual(x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor, shift=None, scale=None):
    """x' = bf16(x + gate * y): x, y [B, L, D], gate [B, D]. Given shift and
    scale, also ln_modulate(x', shift, scale) from the same pass: returns
    (x', norm)."""
    if (shift is None) != (scale is None):
        raise ValueError("gated_residual: give both shift and scale, or neither")
    if not _on_card(x):
        return gated_residual_reference(x, gate, y, shift, scale)
    norm = shift is not None
    _check("gated_residual", x, (gate, shift, scale) if norm else (gate,), y)
    x_out = torch.empty_like(x)
    out = torch.empty_like(x) if norm else None
    _launch("lb_gated_residual_bf16", x, gate, gate.stride(0), y, shift if norm else 0, shift.stride(0) if norm else 0,
            scale if norm else 0, scale.stride(0) if norm else 0, x_out, out if norm else 0, *x.shape)
    profiling.count("M1")
    return (x_out, out) if norm else x_out
