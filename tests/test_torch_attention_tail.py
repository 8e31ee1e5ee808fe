"""K2 bf16 at sequence lengths that are not multiples of its 128-key tiles
(SD3's joint sequence): no padded key takes weight, no row past L is
written, no batch reads another's rows; against attention_reference.

The kernel runs on the card only (a CUDA kernel has no interpret mode), so
the test is marked `gpu` and skips here. It imports neither jax nor the
JAX package: on the card its body runs as a plain function.
"""
from __future__ import annotations

import pytest
import torch

# K2 bf16's bound against the plain result in float32 (chip_smoke.py's K2_ABS_BOUND)
K2_ABS_BOUND = 2e-2


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU: K2 is a CUDA kernel")
def test_k2_tail_matches_plain_version_on_gpu():
    from latentblending_tpu_torch import profiling
    from latentblending_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(0)
    for L in (77, 4429, 4480):
        B, H = 2, 38
        q, k, v = (torch.randn((B, L, H, 64), generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        tail0, k20 = profiling.counter("K2_tail"), profiling.counter("K2")
        out = attention.flash_attention(q, k, v)
        want = torch.cat([attention.attention_reference(q[i:i + 1].float(), k[i:i + 1].float(), v[i:i + 1].float())
                          for i in range(B)])
        err = (out.float() - want).abs().max().item()
        assert torch.isfinite(out.float()).all() and err <= K2_ABS_BOUND, (L, err)
        assert profiling.counter("K2") - k20 == 1
        assert profiling.counter("K2_tail") - tail0 == (1 if L % 128 else 0)
        # each batch alone gives its rows of the pair: no batch's rows are
        # another's keys
        for i in range(B):
            alone = attention.flash_attention(q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                                              v[i:i + 1].contiguous())
            assert torch.equal(alone, out[i:i + 1]), (L, i)
        # the output inside a longer buffer: nothing past row L of the last
        # batch is written
        n = B * L * H * 64
        buf = torch.full((n + 4096,), 7.0, device="cuda", dtype=torch.bfloat16)
        attention._launch("lb_attention_fwd_d64_bf16", q, k, v, buf[:n].view(B, L, H, 64))
        torch.cuda.synchronize()
        assert torch.equal(buf[:n].view(B, L, H, 64), out), L
        assert bool((buf[n:] == 7.0).all()), L
