"""K2/K3: non-causal attention forward — the hand-written CUDA kernel and
its plain PyTorch version.

Replaces the Pallas TPU `flash_attention` calls of
latentblending_tpu/models/layers.py behind `_use_flash_attention`:

- K2, `Attention.__call__`: UNet self-attention, head dim 64, bf16
  (SDXL-Turbo 512²: q/k/v [10, 1024, 10, 64], 10 calls per UNet eval);
- K3, `VAEAttention.__call__`: the VAE mid block's single head of d=512,
  f32 (512²: [chunk, 4096, 1, 512]).

Both are one template in csrc/attention.cu (online-softmax forward, f32
accumulation, 1/√d scale, [B, L, H, d] layout in and out). On the H100
the work is compute-bound (~4·L·d flops per q/k/v element); this first
version runs on the CUDA cores and keeps memory O(L·tile) by never
writing the [B,H,L,L] logits, with K/V tiles staged in shared memory and
the output accumulators in registers.

`flash_attention` takes CUDA tensors to the kernel (or raises) and CPU
tensors to `attention_reference`; nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

# kernel launches, per site (a CPU call launches nothing)
launches_self = 0  # K2: d=64 bf16
launches_vae = 0  # K3: d=512 f32

# (head dim, dtype) -> (C entry point, counter name)
_KERNELS = {
    (64, torch.bfloat16): ("lb_attention_fwd_d64_bf16", "launches_self"),
    (512, torch.float32): ("lb_attention_fwd_d512_f32", "launches_vae"),
}
# the kernels tile the sequence in blocks of 64 (d=64) and 16/32 (d=512)
_SEQ_MULTIPLE = 64


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias=None) -> torch.Tensor:
    """Plain attention, softmax(q kᵀ/√d + bias) v, computed in float32 as
    jax.nn.dot_product_attention does. q [B,Lq,H,d], k/v [B,Lk,H,d] →
    [B,Lq,H,d] in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked self-attention, q/k/v [B, L, H, d] → [B, L, H, d]."""
    if not q.is_cuda:
        return attention_reference(q, k, v)
    B, L, H, D = q.shape
    key = (D, q.dtype)
    if key not in _KERNELS:
        raise TypeError(f"flash_attention: no kernel for head dim {D} in {q.dtype} (have {sorted(_KERNELS, key=str)})")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share shape and dtype (self-attention)")
    if not (k.is_cuda and v.is_cuda) or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v must be on the same CUDA device")
    if L % _SEQ_MULTIPLE:
        raise ValueError(f"flash_attention: sequence length {L} is not a multiple of {_SEQ_MULTIPLE}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    from latentblending_tpu_torch.ops import _build

    name, counter = _KERNELS[key]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_build.library(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, H, float(D ** -0.5), stream
        )
    _build.check(rc, name)
    globals()[counter] += 1
    return out
