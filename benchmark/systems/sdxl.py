"""SDXL in the program: the port's SDXLHolder of the configuration's
port spec, checked against the configuration, its weights the
reference's draws (benchmark/reference/sdxl.py's parts and names), under
the port's BlendingEngine.
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark import weights
from benchmark.reference import sdxl as ref_sdxl


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"no torch dtype {name!r}")
    return dtype


def _check_spec(cfg: dict, spec) -> None:
    """The port's spec is the configuration's (weight shapes are checked
    name by name when the weights are filled)."""
    u, v, run = cfg["unet"], cfg["vae"], cfg["run"]
    pairs = [
        (spec.unet.block_out_channels, tuple(u["block_out_channels"])),
        (spec.unet.num_attention_heads, tuple(u["attention_head_dim"])),
        (spec.unet.transformer_layers_per_block, tuple(u["transformer_layers_per_block"])),
        (spec.unet.layers_per_block, u["layers_per_block"]),
        (spec.unet.cross_attention_dim, u["cross_attention_dim"]),
        (spec.unet.addition_time_embed_dim, u["addition_time_embed_dim"]),
        (spec.vae.block_out_channels, tuple(v["block_out_channels"])),
        (spec.vae.scaling_factor, v["scaling_factor"]),
        (spec.clip1.num_layers, cfg["text_encoder"]["num_hidden_layers"]),
        (spec.clip2.num_layers, cfg["text_encoder_2"]["num_hidden_layers"]),
        (spec.clip2.hidden_size, cfg["text_encoder_2"]["hidden_size"]),
        (spec.scheduler.timestep_spacing, cfg["scheduler"]["timestep_spacing"]),
        (spec.default_size, (run["width"], run["height"])),
    ]
    bad = [(a, b) for a, b in pairs if a != b]
    if bad:
        raise ValueError(f"the port's spec {spec.name!r} differs from the configuration: {bad}")


def build(cfg: dict, seed: int, device):
    """The port's BlendingEngine over an SDXLHolder of `cfg` on `device`,
    its weights the draws of `seed` over the reference's names."""
    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.ops.scheduler import scheduler_config_from_hf
    from latentblending_tpu_torch.precision import disable_tf32
    from latentblending_tpu_torch.runtime.holder import SPECS, SDXLHolder, build_modules

    disable_tf32()
    run = cfg["run"]
    spec = SPECS[cfg["port_spec"]]
    # the sampler is the configuration's scheduler (the spec's own is the
    # fallback for a class the port does not know, which is refused)
    sched = scheduler_config_from_hf(cfg["scheduler"], spec.scheduler)
    if sched is spec.scheduler:
        raise ValueError(f"the port has no sampler for {cfg['scheduler']['_class_name']!r}")
    spec = dataclasses.replace(spec, scheduler=sched)
    _check_spec(cfg, spec)
    dtype, vae_dtype = _dtype(run["dtypes"]["unet"]), _dtype(run["dtypes"]["vae"])
    mods = build_modules(spec, dtype, device, vae_dtype)
    weights.fill_parts(mods, ref_sdxl.parts(cfg), ref_sdxl.PARTS, cfg, seed, torch.device(device))
    holder = SDXLHolder(spec, mods, dtype=dtype, vae_dtype=vae_dtype, device=device)
    return BlendingEngine(holder, run_benchmark=run["engine"]["run_benchmark"])


def hooked(engine) -> tuple:
    """The UNet and the VAE decoder."""
    return engine.dh.unet, engine.dh.vae.decoder
