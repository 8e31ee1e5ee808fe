"""The model work an SDXL transition needs (work.py's counts of image
evals and keyframes): the UNet's evals and the keyframes' decodes for
`mfu`; the UNet's flash-gated self-attention and the VAE's mid-block
attention, with the port's kernels that run them, for `attn_roofline`.
"""
from __future__ import annotations

from benchmark.yardstick import flops, roofline, work

# the port's K2 (d=64) and K3 (d=512) kernels, by their profiler names
ATTENTION_KERNELS = ("attention_d64_", "attention_d512_")


def _lat(cfg: dict) -> tuple[int, int]:
    return cfg["run"]["height"] // 8, cfg["run"]["width"] // 8


def model_seconds_at_peak(cfg: dict) -> float:
    """Seconds the needed UNet and decode work takes at the peak of each
    part's configured dtype."""
    run = cfg["run"]
    h, w = _lat(cfg)
    unet_f = flops.unet_forward_flops(cfg["unet"], h, w, work.image_evals(cfg))
    vae_f = flops.vae_decode_flops(cfg["vae"], run["height"], run["width"], work.keyframes(cfg))
    return (unet_f / roofline.MODEL_PEAK[run["dtypes"]["unet"]]
            + vae_f / roofline.MODEL_PEAK[run["dtypes"]["vae"]])


def attention_bound_seconds(cfg: dict) -> float:
    """Bound of the attention-kernel work a transition needs: UNet
    self-attention at the gated sites over the needed image evals, and the
    VAE mid-block attention once per keyframe."""
    run = cfg["run"]
    h, w = _lat(cfg)
    return (roofline.unet_attention_bound_s(cfg["unet"], h, w, work.image_evals(cfg), run["dtypes"]["unet"])
            + roofline.vae_attention_bound_s(cfg["vae"], run["height"], run["width"], work.keyframes(cfg),
                                             run["dtypes"]["vae"]))
