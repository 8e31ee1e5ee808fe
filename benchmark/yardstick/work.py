"""The work one transition needs, from a configuration file's plan.

A keyframe transition is two edges denoised over all N steps and, per
level of the plan, stems that start at the level's injection step, so a
stem needs N - idx_injection steps. With classifier-free guidance a step
is two UNet image evals. Every keyframe is decoded once. This counts what
the plan needs, not what an implementation runs (the fused turbo scan runs
every row over all N steps), so a change that stops computing discarded
rows shows as a gain.
"""
from __future__ import annotations

from benchmark.yardstick import flops, roofline


def row_steps(cfg: dict) -> int:
    """UNet row-steps a transition needs (before CFG doubling)."""
    run = cfg["run"]
    n = run["num_inference_steps"]
    plan = run["plan"]
    return 2 * n + sum(k * (n - idx) for idx, k in zip(plan["idx_injection"], plan["stems"]))


def keyframes(cfg: dict) -> int:
    return 2 + sum(cfg["run"]["plan"]["stems"])


def image_evals(cfg: dict) -> int:
    """UNet image evals a transition needs: row-steps, twice under CFG."""
    return row_steps(cfg) * (2 if cfg["run"]["guidance_scale"] > 1.0 else 1)


def _lat(cfg: dict) -> tuple[int, int]:
    return cfg["run"]["height"] // 8, cfg["run"]["width"] // 8


def model_seconds_at_peak(cfg: dict) -> float:
    """Seconds the needed UNet and decode work takes at the peak of each
    part's configured dtype: the numerator of `mfu`."""
    run = cfg["run"]
    h, w = _lat(cfg)
    unet_f = flops.unet_forward_flops(cfg["unet"], h, w, image_evals(cfg))
    vae_f = flops.vae_decode_flops(cfg["vae"], run["height"], run["width"], keyframes(cfg))
    return (unet_f / roofline.MODEL_PEAK[run["dtypes"]["unet"]]
            + vae_f / roofline.MODEL_PEAK[run["dtypes"]["vae"]])


def attention_bound_seconds(cfg: dict) -> float:
    """Bound of the attention-kernel work a transition needs: UNet
    self-attention at the gated sites over the needed image evals, and the
    VAE mid-block attention once per keyframe."""
    run = cfg["run"]
    h, w = _lat(cfg)
    return (roofline.unet_attention_bound_s(cfg["unet"], h, w, image_evals(cfg), run["dtypes"]["unet"])
            + roofline.vae_attention_bound_s(cfg["vae"], run["height"], run["width"], keyframes(cfg),
                                             run["dtypes"]["vae"]))
