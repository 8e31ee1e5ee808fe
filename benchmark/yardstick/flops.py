"""Analytic FLOP counts of the SDXL UNet and the AutoencoderKL decode
(matmul and conv MACs x 2; norms, elementwise work and softmax are left
out, under 1% of the total).

Copied from the port's ops/flops.py, reading the benchmark's own
configuration files (HF key names) instead of the port's dataclasses, so a
change to the program cannot move the yardstick. CLIP, the similarity
metric and the JPEG work are not counted.

`unet_forward_flops` counts ONE UNet forward for `batch` images: callers
fold classifier-free guidance into `batch` (a CFG step on B rows passes 2B).
"""
from __future__ import annotations


def _conv(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _resnet(h: int, w: int, cin: int, cout: int, temb: int | None) -> float:
    f = _conv(h, w, cin, cout) + _conv(h, w, cout, cout)
    if cin != cout:
        f += _conv(h, w, cin, cout, 1)
    if temb:
        f += 2.0 * temb * cout
    return f


def _tx_block(L: int, c: int, ctx_len: int, ctx_dim: int) -> float:
    # attn1 (self): q,k,v,out projections + QK^T + PV
    f = 4 * 2.0 * L * c * c + 2 * 2.0 * L * L * c
    # attn2 (cross): q + out over c; k,v from context; QK^T + PV vs ctx_len
    f += 2 * 2.0 * L * c * c + 2 * 2.0 * ctx_len * ctx_dim * c + 2 * 2.0 * L * ctx_len * c
    # GEGLU ff: proj c→8c, out 4c→c
    f += 2.0 * L * c * 8 * c + 2.0 * L * 4 * c * c
    return f


def _transformer2d(h: int, w: int, c: int, depth: int, ctx_len: int, ctx_dim: int) -> float:
    L = h * w
    f = 2 * 2.0 * L * c * c  # proj_in + proj_out
    return f + depth * _tx_block(L, c, ctx_len, ctx_dim)


def has_attn(unet: dict) -> list[bool]:
    """Which levels hold cross-attention transformers (HF down_block_types)."""
    return ["CrossAttn" in t for t in unet["down_block_types"]]


def unet_forward_flops(unet: dict, h_lat: int, w_lat: int, batch: int, ctx_len: int = 77) -> float:
    """FLOPs of one UNet forward for `batch` images at [h_lat, w_lat, 4]."""
    chans = list(unet["block_out_channels"])
    temb = chans[0] * 4
    ctx = unet["cross_attention_dim"]
    depths = unet["transformer_layers_per_block"]
    attn = has_attn(unet)
    n = len(chans)
    f = _conv(h_lat, w_lat, unet["in_channels"], chans[0])  # conv_in
    f += 2.0 * chans[0] * temb + 2.0 * temb * temb  # time_embedding MLP
    f += 2.0 * unet["projection_class_embeddings_input_dim"] * temb + 2.0 * temb * temb

    h, w = h_lat, w_lat
    skips = [chans[0]]
    cin = chans[0]
    for lvl in range(n):
        cout = chans[lvl]
        for _ in range(unet["layers_per_block"]):
            f += _resnet(h, w, cin, cout, temb)
            if attn[lvl]:
                f += _transformer2d(h, w, cout, depths[lvl], ctx_len, ctx)
            skips.append(cout)
            cin = cout
        if lvl < n - 1:
            h, w = h // 2, w // 2
            f += _conv(h, w, cout, cout)  # strided downsample conv
            skips.append(cout)

    c = chans[-1]
    f += _resnet(h, w, c, c, temb)
    f += _transformer2d(h, w, c, depths[-1], ctx_len, ctx)
    f += _resnet(h, w, c, c, temb)

    cin = c
    for lvl in reversed(range(n)):
        cout = chans[lvl]
        for _ in range(unet["layers_per_block"] + 1):
            skip = skips.pop()
            f += _resnet(h, w, cin + skip, cout, temb)
            if attn[lvl]:
                f += _transformer2d(h, w, cout, depths[lvl], ctx_len, ctx)
            cin = cout
        if lvl > 0:
            h, w = h * 2, w * 2
            f += _conv(h, w, cout, cout)  # upsample conv

    f += _conv(h_lat, w_lat, chans[0], unet["out_channels"])  # conv_out
    return f * batch


def vae_decode_flops(vae: dict, h_img: int, w_img: int, batch: int = 1) -> float:
    """FLOPs of one VAE decode to [h_img, w_img, 3]: post_quant_conv unless
    `use_post_quant_conv` is false (absent: true); `shift_factor` is an
    elementwise add, not counted."""
    chans = list(reversed(vae["block_out_channels"]))  # decoder order
    lat = vae["latent_channels"]
    h, w = h_img // 8, w_img // 8
    f = _conv(h, w, lat, lat, 1) if vae.get("use_post_quant_conv", True) else 0.0  # post_quant
    f += _conv(h, w, lat, chans[0])  # conv_in
    f += 2 * _resnet(h, w, chans[0], chans[0], None)
    L, c = h * w, chans[0]
    f += 4 * 2.0 * L * c * c + 2 * 2.0 * L * L * c  # mid-block attention
    cin = chans[0]
    for i, ch in enumerate(chans):
        for _ in range(vae["layers_per_block"] + 1):
            f += _resnet(h, w, cin, ch, None)
            cin = ch
        if i < len(chans) - 1:
            h, w = h * 2, w * 2
            f += _conv(h, w, ch, ch)
    f += _conv(h_img, w_img, chans[-1], vae["out_channels"])  # conv_out
    return f * batch
