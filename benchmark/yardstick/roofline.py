"""Peaks of one NVIDIA H100 SXM and the least time a piece of work can take
on it: the benchmark's copy of chip_smoke.py's `_bound` and of its K2/K3
operation counts, with the work a transition needs.

Published peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit):
989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s f32 on the CUDA cores,
3.35 TB/s of HBM. An f32 kernel on the tensor cores runs 3xTF32 (three
TF32 products per f32 one), so its operations count three times over the
TF32 peak; whole-model f32 work (the f32 VAE in `mfu`) is counted against
495 / 3 = 165 TFLOP/s, the same convention.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# the peak a model part in its configured dtype is held to in `mfu`
MODEL_PEAK = {"bfloat16": PEAK_FLOPS["bf16"], "float32": PEAK_FLOPS["tf32"] / 3}

# self-attention sites that count as attention-kernel work: sequence
# lengths that are a multiple of this (the flash gate of the port when the
# benchmark was defined; fixed here so that the yardstick does not follow
# a later change of the gate)
ATTN_SEQ_MULTIPLE = 512


def bound_s(nbytes: float, flops: float, peak: str) -> float:
    """Least seconds the card could take: the larger of bytes over the
    memory rate and flops over the peak of their type."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak])


def attention_bound_s(batch: int, L: int, heads: int, d: int, dtype: str) -> float:
    """Bound of one self-attention call [batch, L, heads, d]: q, k, v read
    and o written once; QK^T and PV (4 B H L^2 d flops). bf16 against the
    bf16 peak, f32 as 3xTF32."""
    flops = 4.0 * batch * heads * L * L * d
    if dtype == "bfloat16":
        return bound_s(4.0 * batch * L * heads * d * 2, flops, "bf16")
    return bound_s(4.0 * batch * L * heads * d * 4, 3 * flops, "tf32")


def unet_attention_sites(unet: dict, h_lat: int, w_lat: int) -> list[tuple[int, int, int]]:
    """(L, heads, calls) of the UNet's self-attention per image eval, for the
    sites whose L is a multiple of ATTN_SEQ_MULTIPLE; head size 64."""
    chans = unet["block_out_channels"]
    depths = unet["transformer_layers_per_block"]
    n = len(chans)
    sites = []
    for lvl, t in enumerate(unet["down_block_types"]):
        if "CrossAttn" not in t:
            continue
        L = (h_lat >> lvl) * (w_lat >> lvl)
        calls = (2 * unet["layers_per_block"] + 1) * depths[lvl]
        if lvl == n - 1:
            calls += depths[-1]  # the mid block's transformer
        if L % ATTN_SEQ_MULTIPLE == 0:
            sites.append((L, chans[lvl] // 64, calls))
    return sites


def unet_attention_bound_s(unet: dict, h_lat: int, w_lat: int, images: int, dtype: str) -> float:
    """Bound of the flash-gated UNet self-attention of `images` image evals."""
    return sum(calls * attention_bound_s(images, L, heads, 64, dtype)
               for L, heads, calls in unet_attention_sites(unet, h_lat, w_lat))


def vae_attention_bound_s(vae: dict, h_img: int, w_img: int, decodes: int, dtype: str) -> float:
    """Bound of the VAE mid-block attention (one head, d = top channels) of
    `decodes` decodes."""
    L = (h_img // 8) * (w_img // 8)
    return attention_bound_s(decodes, L, 1, vae["block_out_channels"][-1], dtype)
