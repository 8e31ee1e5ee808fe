"""K2/K3: non-causal attention forward — the hand-written CUDA kernels and
their plain PyTorch version.

Replace the Pallas TPU `flash_attention` calls of
latentblending_tpu/models/layers.py behind `_use_flash_attention`, which
run in their module's dtype:

- K2, `Attention.__call__`: UNet self-attention, head dim 64, in the
  UNet's dtype, bf16 or f32 (SDXL-Turbo 512²: q/k/v [10, 1024, 10, 64],
  10 calls per UNet eval);
- K3, `VAEAttention.__call__`: the VAE mid block's single head of d=512,
  decoder and encoder, in the VAE's dtype, f32 or bf16 (512²:
  [chunk, 4096, 1, 512]).

All four are online-softmax (flash) forwards on the tensor cores, with f32
accumulation, a 1/√d scale and the [B, L, H, d] layout in and out; they
never write the [B,H,L,L] logits, so memory stays O(L·tile):

- K2 bf16, csrc/attention_d64_bf16.cu: warpgroup MMA (wgmma) on bf16, Q
  and K/V tiles loaded by TMA, softmax and P (bf16) kept in registers;
  query tiles of 64 rows, key tiles of 128 rows. It takes any sequence
  length: a length that is not a multiple of 128 (SD3's joint sequence,
  4096 image + 333 text tokens at 1024²) runs a second instantiation
  that reads each batch through its own TMA box bounds (rows past L read
  as zeros, never another batch's), masks the last key tile's columns
  past L to -inf and stores no row past L; it is counted under `K2` and
  under `K2_tail`. Lengths that are multiples of 128 run the kernel as
  before.
- K2 f32, csrc/attention_d64_f32.cu: TF32 wgmma in three passes (3xTF32,
  hi/lo operand split: ~f32 accuracy), one CTA per 128 query rows of one
  head (two consumer warpgroups); a producer warpgroup loads Q and 64-key
  K tiles by TMA and splits each K and V tile once for both consumers (V
  written transposed, as TF32 wgmma wants it), Q split once into
  registers, P split in registers.
- K3 f32, csrc/attention_d512_f32.cu: 3xTF32 on TF32 wgmma, d split
  across a 4-CTA cluster (128 columns a CTA) whose CTAs exchange partial
  scores by st.async and sum them in rank order; a producer warpgroup
  loads Q and K by TMA and splits each K and V tile once (V written
  transposed), the consumer warpgroup keeps Q hi and P split in registers;
  64-row query tiles, 32-key tiles, one head only.
- K3 bf16, csrc/attention_d512_bf16.cu: the same cluster split on wgmma,
  loads by TMA from a producer warp, the partial scores exchanged by
  st.async into the partner's shared memory (P rounded to bf16 before
  P V); query and key tiles of 64 rows, one head only.

`flash_attention` takes CUDA tensors to the kernel (or raises) and CPU
tensors to `attention_reference`; nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from latentblending_tpu_torch import profiling

# (head dim, dtype) -> (C entry point, its launch counter in the profiling
# registry (a CPU call launches nothing), the sequence multiple
# its tiles need: K2 bf16 64-row query and 128-row key tiles (1: its tail
# instantiation takes the rest), K2 f32 128-row query and 64-row key
# tiles, K3 f32 64-row query and 32-row key tiles, K3 bf16 64-row query
# and key tiles)
_KERNELS = {
    (64, torch.bfloat16): ("lb_attention_fwd_d64_bf16", "K2", 1),
    (64, torch.float32): ("lb_attention_fwd_d64_f32", "K2_f32", 128),
    (512, torch.float32): ("lb_attention_fwd_d512_f32", "K3", 64),
    (512, torch.bfloat16): ("lb_attention_fwd_d512_bf16", "K3_bf16", 64),
}


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
    if not _on_card(q):
        return attention_reference(q, k, v)
    B, L, H, D = q.shape
    key = (D, q.dtype)
    if key not in _KERNELS:
        raise TypeError(f"flash_attention: no kernel for head dim {D} in {q.dtype} (have {sorted(_KERNELS, key=str)})")
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share shape and dtype (self-attention)")
    if not (_on_card(k) and _on_card(v)) or len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k and v must be on the same CUDA device")
    name, counter, multiple = _KERNELS[key]
    if L % multiple:
        raise ValueError(f"flash_attention: sequence length {L} is not a multiple of {multiple}")
    if D == 512 and H != 1:
        raise ValueError(f"flash_attention: the d=512 kernel takes one head, not {H}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on a 16-byte boundary (TMA / cp.async loads)")
    out = torch.empty_like(q)
    _launch(name, q, k, v, out)
    profiling.count(counter)
    if counter == "K2" and L % 128:
        profiling.count("K2_tail")
    return out


def _on_card(t: torch.Tensor) -> bool:
    """Whether t goes to a kernel (a CUDA tensor); the one place a test may
    stand the card in, with `_launch`."""
    return t.is_cuda


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor) -> None:
    """Run the C entry `name` on q, k, v into out, on q's device and its
    current stream; raises on a launch error."""
    from latentblending_tpu_torch.ops import _build

    B, L, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_build.library(), name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, H, float(D ** -0.5), stream
        )
    _build.check(rc, name)
