"""SD3 in the program: the port's SD3Holder of the configuration's port spec,
checked against the configuration, its weights the reference's draws
(benchmark/reference/sd35.py's parts and names, over the same views of the
program's MMDiT and T5), under the port's BlendingEngine.

The program's SD3 modules are imported before anything is built or drawn,
so a checkout without them fails at once.
"""
from __future__ import annotations

import torch

from benchmark import weights
from benchmark.reference import sd35 as ref_sd35
from benchmark.systems.sdxl import _dtype


def _check_spec(cfg: dict, spec) -> None:
    """The port's spec is the configuration's (weight shapes are checked
    name by name when the weights are filled), and so is T5's compute
    dtype (models/t5.py's COMPUTE_DTYPE: the port has no other)."""
    from latentblending_tpu_torch.models.t5 import COMPUTE_DTYPE

    t, v, run = cfg["transformer"], cfg["vae"], cfg["run"]
    t5, m = cfg["text_encoder_3"], spec.mmdit
    if t.get("dual_attention_layers") or t.get("qk_norm") != "rms_norm":
        raise ValueError("the port's MMDiT has RMSNorm on Q and K and no dual-attention layers")
    pairs = [
        (m.num_layers, t["num_layers"]), (m.num_attention_heads, t["num_attention_heads"]),
        (m.attention_head_dim, t["attention_head_dim"]), (m.joint_attention_dim, t["joint_attention_dim"]),
        (m.caption_projection_dim, t["caption_projection_dim"]), (m.pooled_projection_dim, t["pooled_projection_dim"]),
        (m.patch_size, t["patch_size"]), (m.in_channels, t["in_channels"]), (m.out_channels, t["out_channels"]),
        (m.sample_size, t["sample_size"]), (m.pos_embed_max_size, t["pos_embed_max_size"]),
        (spec.t5.d_model, t5["d_model"]), (spec.t5.num_layers, t5["num_layers"]), (spec.t5.num_heads, t5["num_heads"]),
        (spec.t5.d_ff, t5["d_ff"]), (spec.t5.relative_attention_num_buckets, t5["relative_attention_num_buckets"]),
        (spec.t5.relative_attention_max_distance, t5["relative_attention_max_distance"]),
        (spec.vae.latent_channels, v["latent_channels"]), (spec.vae.block_out_channels, tuple(v["block_out_channels"])),
        (spec.vae.scaling_factor, v["scaling_factor"]), (spec.vae_shift_factor, v["shift_factor"]),
        (spec.vae_post_quant_conv, v["use_post_quant_conv"]),
        (spec.clip1.num_layers, cfg["text_encoder"]["num_hidden_layers"]),
        (spec.clip1.projection_dim, cfg["text_encoder"]["projection_dim"]),
        (spec.clip2.num_layers, cfg["text_encoder_2"]["num_hidden_layers"]),
        (spec.clip2.hidden_size, cfg["text_encoder_2"]["hidden_size"]),
        (spec.scheduler.shift, cfg["scheduler"]["shift"]),
        (spec.max_sequence_length, run["max_sequence_length"]),
        (spec.default_size, (run["width"], run["height"])),
        (str(COMPUTE_DTYPE).split(".")[1], run["dtypes"].get("t5_compute")),
    ]
    bad = [(a, b) for a, b in pairs if a != b]
    if bad:
        raise ValueError(f"the port's spec {spec.name!r} differs from the configuration: {bad}")


def build(cfg: dict, seed: int, device):
    """The port's BlendingEngine over an SD3Holder of `cfg` on `device`, its
    weights the draws of `seed` over the reference's names."""
    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.models.sd3_configs import SD3_SPECS
    from latentblending_tpu_torch.ops.scheduler import FlowMatchSchedulerConfig, scheduler_config_from_hf
    from latentblending_tpu_torch.precision import disable_tf32
    from latentblending_tpu_torch.runtime.holder import SD3Holder, build_sd3_modules

    disable_tf32()
    run = cfg["run"]
    spec = SD3_SPECS[cfg["port_spec"]]
    if not isinstance(scheduler_config_from_hf(cfg["scheduler"], None), FlowMatchSchedulerConfig):
        raise ValueError(f"the port has no SD3 sampler for {cfg['scheduler']['_class_name']!r}")
    _check_spec(cfg, spec)
    dt = run["dtypes"]
    mods = build_sd3_modules(spec, _dtype(dt["mmdit"]), device, _dtype(dt["vae"]), _dtype(dt["t5"]))
    weights.fill_parts(ref_sd35.split(mods, cfg), ref_sd35.parts(cfg), ref_sd35.PARTS, cfg, seed,
                       torch.device(device))
    holder = SD3Holder(spec, mods, dtype=_dtype(dt["mmdit"]), vae_dtype=_dtype(dt["vae"]), device=device)
    return BlendingEngine(holder, run_benchmark=run["engine"]["run_benchmark"])


def hooked(engine) -> tuple:
    """The MMDiT (the denoiser, under bench::unet) and the VAE decoder."""
    return engine.dh.mmdit, engine.dh.vae.decoder
