"""The system under test: the port's holder and engine, built from a
configuration file and the run's seed, and one transition as a client
calls it. The only module of the benchmark that imports the program.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import calls, weights
from benchmark.reference import clip as ref_clip, unet as ref_unet, vae as ref_vae


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"no torch dtype {name!r}")
    return dtype


def _reference_names(cfg: dict) -> dict:
    """(name, shape) lists of the reference's four parts, built on meta."""
    return {
        "unet": weights.names_of(ref_unet.UNet(cfg["unet"])),
        "vae": weights.names_of(ref_vae.VAEDecoder(cfg["vae"])),
        "clip1": weights.names_of(ref_clip.TextEncoder(dict(cfg["text_encoder"], projection=False))),
        "clip2": weights.names_of(ref_clip.TextEncoder(dict(cfg["text_encoder_2"], projection=True))),
    }


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


@dataclasses.dataclass
class Record:
    """One completed transition, as the check and the readers need it."""

    request: object
    keyframes: np.ndarray  # uint8 [K,H,W,3]
    finals: list  # device final latents, one [1,h,w,4] per keyframe
    fracts: list
    idx: list
    path: str
    denoise_s: float
    embed_s: float
    wall_s: float
    product: object = None  # what the call made besides the keyframes (a movie's file)
    movie_write_s: float | None = None  # the engine's movie_write phase, where it ran


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
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
        names = _reference_names(cfg)
        for i, part in enumerate(weights.PARTS):
            weights.fill(dict(mods[part].state_dict()), names[part], seed, i,
                         weights.part_dtype(cfg, part), torch.device(device))
        self.holder = SDXLHolder(spec, mods, dtype=dtype, vae_dtype=vae_dtype, device=device)
        eng = BlendingEngine(self.holder, run_benchmark=run["engine"]["run_benchmark"])
        eng.set_dimensions((run["width"], run["height"]))
        eng.set_num_inference_steps(run["num_inference_steps"])
        b = run["engine"]["branching"]
        eng.set_branching(depth_strength=b["depth_strength"], nmb_max_branches=b["nmb_max_branches"])
        eng.placement_policy = traffic["placement_policy"]
        plan = ([int(i) for i in eng.list_idx_injection], [int(k) for k in eng.list_nmb_stems])
        if plan != (run["plan"]["idx_injection"], run["plan"]["stems"]):
            raise ValueError(f"the engine's plan {plan} is not the configuration's {run['plan']}")
        cf = run["parental_crossfeed"]
        if (eng.parental_crossfeed_power, eng.parental_crossfeed_range, eng.parental_crossfeed_decay) != (
                cf["power"], cf["range"], cf["decay"]) or eng.guidance_scale_base != run["guidance_scale"]:
            raise ValueError("the engine's crossfeed or guidance is not the configuration's")
        self.engine = eng
        self.call = calls.load(traffic["call"]).Call(traffic)
        self.plan = plan
        self._n = 0

    def transition(self, req) -> Record:
        """One client transition: the prompts set (their embedding synced and
        timed as embed_s), then the cell's call until its product is on the host."""
        eng = self.engine
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench::embed"):
            eng.set_negative_prompt(req.negative)
            eng.set_prompt1(req.prompt1)
            eng.set_prompt2(req.prompt2)
            if self.holder.device.type == "cuda":
                torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench::transition"):
            imgs, product = self.call.call(eng, req, self._n)
        t2 = time.perf_counter()
        self._n += 1
        phases = eng.last_report.phases
        levels = eng.last_report.levels
        fused = [lv.get("fused", False) for lv in levels]
        path = ("fused" if len(levels) == 1 else "fused-multi") if fused and all(fused) else "per-level"
        return Record(
            request=req, keyframes=np.stack([np.asarray(im) for im in imgs]),
            finals=[lat[-1] for lat in eng.tree_latents], fracts=list(eng.tree_fracts),
            idx=[int(i) for i in eng.tree_idx_injection], path=path,
            denoise_s=float(phases.get("denoise", {}).get("total_s", 0.0)),
            embed_s=t1 - t0, wall_s=t2 - t0, product=product,
            movie_write_s=float(phases["movie_write"]["total_s"]) if "movie_write" in phases else None,
        )

    def module_hooks(self) -> list:
        """Forward hooks that put the UNet's and the VAE decoder's launches in
        record_function ranges (bench::unet, bench::vae), for traced runs."""
        handles = []
        for name, mod in (("bench::unet", self.holder.unet), ("bench::vae", self.holder.vae.decoder)):
            stack = []

            def pre(_m, _a, name=name, stack=stack):
                rf = torch.profiler.record_function(name)
                rf.__enter__()
                stack.append(rf)

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
        return handles

    def close(self) -> None:
        """Let go of the program's modules and state (what the calls wrote
        stays until `self.call` is cleaned up)."""
        self.engine = self.holder = None
