"""K1: batched per-row slerp — the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel latentblending_tpu/ops/pallas_kernels.py
(`slerp_pallas`, dispatched by `slerp_batched_auto`). It runs on the main
path twice: the crossfeed slerp once per denoise step over the whole batch
(runtime/denoise.py), and the parental mix of a stem round over all
(step, stem) rows (engine/blending.py). Kernel: csrc/slerp.cu. On the H100
it is bound by memory (~8 flops per element); one block per row reduces
the three sums in one f32 pass, then a second pass re-reads the row from
L2, so device memory sees about one read and one write.

`slerp_rows` takes a CUDA tensor to the kernel (or raises) and a CPU tensor
to the plain version; nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from latentblending_tpu_torch.ops.interp import interpolate_spherical_batched

# kernel launches made by slerp_rows (a CPU call launches nothing)
launches = 0

_ENTRY = {torch.float32: "lb_slerp_rows_f32", torch.bfloat16: "lb_slerp_rows_bf16"}


def slerp_rows_reference(a: torch.Tensor, b: torch.Tensor, fract: torch.Tensor) -> torch.Tensor:
    """Plain version: a, b [B, ...]; fract [B] → [B, ...] in a's dtype."""
    return interpolate_spherical_batched(a, b, fract)


def slerp_rows(a: torch.Tensor, b: torch.Tensor, fract: torch.Tensor) -> torch.Tensor:
    """Per-row slerp of a, b [B, ...] with fractions fract [B] (f32 math)."""
    if not a.is_cuda:
        return slerp_rows_reference(a, b, fract)
    global launches
    if a.dtype not in _ENTRY:
        raise TypeError(f"slerp_rows: dtype {a.dtype} not supported (float32, bfloat16)")
    if b.dtype != a.dtype or b.shape != a.shape:
        raise ValueError(f"slerp_rows: a {tuple(a.shape)} {a.dtype} vs b {tuple(b.shape)} {b.dtype}")
    if not (b.is_cuda and fract.is_cuda) or len({a.device, b.device, fract.device}) != 1:
        raise ValueError("slerp_rows: a, b and fract must be on the same CUDA device")
    if fract.dtype != torch.float32 or fract.shape != (a.shape[0],):
        raise ValueError(f"slerp_rows: fract must be float32 [{a.shape[0]}], got {fract.dtype} {tuple(fract.shape)}")
    if not (a.is_contiguous() and b.is_contiguous() and fract.is_contiguous()):
        raise ValueError("slerp_rows: inputs must be contiguous")
    from latentblending_tpu_torch.ops import _build

    rows = a.shape[0]
    n = a.numel() // max(rows, 1)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    name = _ENTRY[a.dtype]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_build.library(), name)(
            a.data_ptr(), b.data_ptr(), fract.data_ptr(), out.data_ptr(), rows, n, stream
        )
    _build.check(rc, name)
    launches += 1
    return out
