"""Analytic FLOP counts for the SDXL stack (MFU reporting).

A copy of latentblending_tpu/ops/flops.py that reads the port's model
configs (the counts are the same functions of the same configs).

XLA's `compiled.cost_analysis()` under-counts scanned programs (the scan
body is counted once, not exec_steps times) and reports nothing for Pallas
custom calls (flash attention), so bench MFU derived from it was ~10× low.
These counters walk the architecture analytically — matmul/conv MACs × 2;
norms/elementwise/softmax are ignored (<1% of total).

Convention: `unet_forward_flops` counts ONE UNet forward for `batch`
images — callers fold CFG into `batch` (a CFG step on B stems passes 2·B).
"""
from __future__ import annotations

from latentblending_tpu_torch.models.configs import UNetConfig, VAEConfig


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


def unet_forward_flops(
    cfg: UNetConfig, h_lat: int, w_lat: int, batch: int, ctx_len: int = 77
) -> float:
    """FLOPs of one UNet forward for `batch` images at [h_lat, w_lat, 4]."""
    chans = list(cfg.block_out_channels)
    temb = cfg.time_embed_dim
    ctx = cfg.cross_attention_dim
    n = len(chans)
    f = _conv(h_lat, w_lat, cfg.in_channels, chans[0])  # conv_in
    f += 2.0 * chans[0] * temb + 2.0 * temb * temb  # time_embedding MLP
    f += 2.0 * cfg.projection_class_embeddings_input_dim * temb + 2.0 * temb * temb

    # down path: skip channel bookkeeping mirrors models/unet.py
    h, w = h_lat, w_lat
    skips = [chans[0]]
    cin = chans[0]
    for lvl in range(n):
        cout = chans[lvl]
        for _ in range(cfg.layers_per_block):
            f += _resnet(h, w, cin, cout, temb)
            if cfg.down_block_has_attn[lvl]:
                f += _transformer2d(h, w, cout, cfg.transformer_layers_per_block[lvl], ctx_len, ctx)
            skips.append(cout)
            cin = cout
        if lvl < n - 1:
            h, w = h // 2, w // 2
            f += _conv(h, w, cout, cout)  # strided downsample conv
            skips.append(cout)

    # mid
    c = chans[-1]
    f += _resnet(h, w, c, c, temb)
    f += _transformer2d(h, w, c, cfg.transformer_layers_per_block[-1], ctx_len, ctx)
    f += _resnet(h, w, c, c, temb)

    # up path
    cin = c
    for lvl in reversed(range(n)):
        cout = chans[lvl]
        for _ in range(cfg.layers_per_block + 1):
            skip = skips.pop()
            f += _resnet(h, w, cin + skip, cout, temb)
            if cfg.down_block_has_attn[lvl]:
                f += _transformer2d(h, w, cout, cfg.transformer_layers_per_block[lvl], ctx_len, ctx)
            cin = cout
        if lvl > 0:
            h, w = h * 2, w * 2
            f += _conv(h, w, cout, cout)  # upsample conv

    f += _conv(h_lat, w_lat, chans[0], cfg.out_channels)  # conv_out
    return f * batch


def vae_decode_flops(cfg: VAEConfig, h_img: int, w_img: int, batch: int = 1) -> float:
    """FLOPs of one VAE decode to [h_img, w_img, 3]."""
    chans = list(reversed(cfg.block_out_channels))  # decoder order
    h, w = h_img // 8, w_img // 8
    f = _conv(h, w, cfg.latent_channels, cfg.latent_channels, 1)  # post_quant
    f += _conv(h, w, cfg.latent_channels, chans[0])  # conv_in
    # mid: 2 resnets + single-head attention
    f += 2 * _resnet(h, w, chans[0], chans[0], None)
    L, c = h * w, chans[0]
    f += 4 * 2.0 * L * c * c + 2 * 2.0 * L * L * c
    cin = chans[0]
    for i, ch in enumerate(chans):
        for _ in range(cfg.layers_per_block + 1):
            f += _resnet(h, w, cin, ch, None)
            cin = ch
        if i < len(chans) - 1:
            h, w = h * 2, w * 2
            f += _conv(h, w, ch, ch)
    f += _conv(h_img, w_img, chans[-1], cfg.out_channels)  # conv_out
    return f * batch
