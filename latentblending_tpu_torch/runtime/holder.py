"""SDXLHolder — the diffusion runtime (UNet, VAE, two CLIP towers, the
scheduler tables and tokenizers), in PyTorch.

Counterpart of latentblending_tpu/runtime/holder.py. The holder owns torch
modules on an explicit `device`; the public tensors keep the JAX package's
layout (latents [B,h,w,4], images [B,H,W,3] in [-1,1]) and the holder
permutes to NCHW at the UNet/VAE boundary. The UNet runs in `dtype` (bf16
by default), the VAE in float32 (the reference's force_upcast, and what the
JAX package does off the TPU); the CLIP towers compute in float32.
Random noise comes from explicit torch.Generators; it cannot reproduce
jax.random draws, so tests hand both packages the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from latentblending_tpu_torch.models import configs as C
from latentblending_tpu_torch.models.clip import CLIPTextEncoder
from latentblending_tpu_torch.models.layers import cast_keep_norms_f32, init_like_jax_
from latentblending_tpu_torch.models.tokenizer import HashTokenizer
from latentblending_tpu_torch.models.unet import UNet2DCondition
from latentblending_tpu_torch.models.vae import VAE
from latentblending_tpu_torch.ops.scheduler import (
    SDXL_BASE_SCHEDULER,
    SDXL_TURBO_EULER_SCHEDULER,
    SDXL_TURBO_SCHEDULER,
    SchedulerState,
    make_schedule,
)
from latentblending_tpu_torch.runtime.denoise import (
    Conditioning,
    DenoisePlan,
    build_mix_inputs,
    denoise_scan,
)

VAE_SCALE_FACTOR = 8


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Architecture bundle for one SDXL variant."""

    name: str
    unet: C.UNetConfig
    vae: C.VAEConfig
    clip1: C.CLIPTextConfig
    clip2: C.CLIPTextConfig
    scheduler: Any
    is_sdxl_turbo: bool
    default_size: tuple[int, int]

    @property
    def pooled_dim(self) -> int:
        return self.clip2.projection_dim or self.clip2.hidden_size


SDXL_TURBO = ModelSpec(
    "sdxl-turbo", C.SDXL_TURBO_UNET, C.SDXL_VAE, C.SDXL_CLIP_L, C.SDXL_CLIP_BIGG,
    SDXL_TURBO_SCHEDULER, True, (512, 512),
)
SDXL_BASE = ModelSpec(
    "sdxl-base", C.SDXL_BASE_UNET, C.SDXL_VAE, C.SDXL_CLIP_L, C.SDXL_CLIP_BIGG,
    SDXL_BASE_SCHEDULER, False, (1024, 1024),
)
TINY_TURBO = ModelSpec(
    "tiny-turbo", C.TINY_UNET, C.TINY_VAE, C.TINY_CLIP, C.TINY_CLIP_PROJ,
    SDXL_TURBO_EULER_SCHEDULER, True, (128, 128),
)
TINY_ANCESTRAL = ModelSpec(
    "tiny-ancestral", C.TINY_UNET, C.TINY_VAE, C.TINY_CLIP, C.TINY_CLIP_PROJ,
    SDXL_TURBO_SCHEDULER, True, (128, 128),
)
TINY_BASE = ModelSpec(
    "tiny-base", C.TINY_UNET, C.TINY_VAE, C.TINY_CLIP, C.TINY_CLIP_PROJ,
    SDXL_BASE_SCHEDULER, False, (128, 128),
)

SPECS = {s.name: s for s in (SDXL_TURBO, SDXL_BASE, TINY_TURBO, TINY_ANCESTRAL, TINY_BASE)}


def build_modules(spec: ModelSpec, dtype: torch.dtype, device) -> dict[str, nn.Module]:
    """The four modules of a spec, allocated uninitialised on `device`
    (structure built on the meta device: no memory is touched twice). UNet
    in `dtype` with float32 norms; VAE and CLIP towers in float32."""
    with torch.device("meta"):
        mods = {
            "unet": cast_keep_norms_f32(UNet2DCondition(spec.unet, spec.pooled_dim), dtype),
            "vae": VAE(spec.vae),
            "clip1": CLIPTextEncoder(spec.clip1),
            "clip2": CLIPTextEncoder(spec.clip2),
        }
    return {k: m.to_empty(device=device).eval().requires_grad_(False) for k, m in mods.items()}


class SDXLHolder:
    def __init__(self, spec: ModelSpec | str, modules: dict[str, nn.Module], tokenizer1=None, tokenizer2=None,
                 dtype: torch.dtype = torch.bfloat16, device="cpu"):
        """modules: {'unet', 'vae', 'clip1', 'clip2'} port nn.Modules on `device`."""
        self.spec = spec if isinstance(spec, ModelSpec) else SPECS[spec]
        self.dtype = dtype
        self.device = torch.device(device)
        self.is_sdxl_turbo = self.spec.is_sdxl_turbo
        self.unet = modules["unet"]
        self.vae = modules["vae"]
        self.clip1 = modules["clip1"]
        self.clip2 = modules["clip2"]

        self.tokenizer1 = tokenizer1 or HashTokenizer(
            self.spec.clip1.vocab_size, bos_token_id=0, eos_token_id=self.spec.clip1.eos_token_id,
            pad_token_id=self.spec.clip1.eos_token_id,
        )
        self.tokenizer2 = tokenizer2 or HashTokenizer(
            self.spec.clip2.vocab_size, bos_token_id=0, eos_token_id=self.spec.clip2.eos_token_id, pad_token_id=0
        )
        self.negative_prompt = ""
        self.guidance_scale = 0.0 if self.is_sdxl_turbo else 4.0
        self.guidance_rescale = 0.0
        # ancestral per-step noise: deterministic in (noise_seed_base, call
        # index); the engine restarts the stream at each transition
        self.noise_seed_base = 0
        self._noise_call = 0
        self.num_inference_steps = 4 if self.is_sdxl_turbo else 30
        self.schedule: SchedulerState = make_schedule(self.spec.scheduler, self.num_inference_steps)
        self.set_dimensions(self.spec.default_size)

    # ------------------------------------------------------------- factories

    @classmethod
    def from_random(cls, spec: ModelSpec | str = "tiny-turbo", seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                    device="cpu", **kw) -> "SDXLHolder":
        """Random-weight holder of the full architecture, built and
        initialised directly on `device` (initialisation as the JAX
        package's flax init, drawn from a torch.Generator seeded with `seed`)."""
        spec = spec if isinstance(spec, ModelSpec) else SPECS[spec]
        device = torch.device(device)
        mods = build_modules(spec, dtype, device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        for m in mods.values():
            init_like_jax_(m, gen)
        return cls(spec, mods, dtype=dtype, device=device, **kw)

    @classmethod
    def from_state_dicts(cls, spec: ModelSpec | str, state_dicts: dict[str, dict], dtype: torch.dtype = torch.bfloat16,
                         device="cpu", **kw) -> "SDXLHolder":
        """Holder from {'unet','vae','clip1','clip2'} state dicts in the port's
        (HF) key names, e.g. from models.weights.params_from_jax."""
        spec = spec if isinstance(spec, ModelSpec) else SPECS[spec]
        mods = build_modules(spec, dtype, torch.device(device))
        for name, m in mods.items():
            m.load_state_dict(state_dicts[name], strict=True)
        return cls(spec, mods, dtype=dtype, device=device, **kw)

    # ----------------------------------------------------------------- state

    def set_num_inference_steps(self, num_inference_steps: int):
        self.num_inference_steps = int(num_inference_steps)
        self.schedule = make_schedule(self.schedule.config, self.num_inference_steps)

    def reset_noise_stream(self, seed_base: int):
        """Restart the deterministic ancestral-noise stream."""
        self.noise_seed_base = int(seed_base)
        self._noise_call = 0

    def set_scheduler_type(self, scheduler_type: str):
        """Switch the solver: 'euler' | 'euler_ancestral' | 'dpmpp_2m'."""
        if scheduler_type not in ("euler", "euler_ancestral", "dpmpp_2m"):
            raise ValueError(scheduler_type)
        cfg = dataclasses.replace(self.schedule.config, scheduler_type=scheduler_type)
        self.schedule = make_schedule(cfg, self.num_inference_steps)

    def set_dimensions(self, size_output: Optional[tuple[int, int]] = None):
        s = VAE_SCALE_FACTOR
        width, height = size_output if size_output is not None else self.spec.default_size
        self.width_img = int(round(width / s) * s)
        self.height_img = int(round(height / s) * s)
        self.width_latent = self.width_img // s
        self.height_latent = self.height_img // s

    @property
    def decode_chunk(self) -> int:
        """VAE decode batch per call: the JAX package's rule for an f32 VAE
        (4 images at ≤512², 1 above). Not yet re-measured on the GPU."""
        return 4 if self.height_img * self.width_img <= 512 * 512 else 1

    def set_negative_prompt(self, negative_prompt):
        if isinstance(negative_prompt, (list, tuple)):
            negative_prompt = negative_prompt[0] if negative_prompt else ""
        self.negative_prompt = negative_prompt

    @property
    def do_classifier_free_guidance(self) -> bool:
        return self.guidance_scale > 1.0

    # ------------------------------------------------------------ text path

    @torch.no_grad()
    def get_text_embedding(self, prompt: str):
        """(prompt_embeds, negative_prompt_embeds, pooled, negative_pooled),
        each with batch 1, in the holder's dtype."""
        ids1 = torch.as_tensor(self.tokenizer1([prompt, self.negative_prompt]), dtype=torch.long, device=self.device)
        ids2 = torch.as_tensor(self.tokenizer2([prompt, self.negative_prompt]), dtype=torch.long, device=self.device)
        pen1, _, _ = self.clip1(ids1)
        pen2, _, pooled = self.clip2(ids2)
        embeds = torch.cat([pen1, pen2], dim=-1)
        return (embeds[0:1].to(self.dtype), embeds[1:2].to(self.dtype),
                pooled[0:1].to(self.dtype), pooled[1:2].to(self.dtype))

    # ----------------------------------------------------------- noise path

    def get_noise(self, seed: int = 420) -> torch.Tensor:
        """[1, h_lat, w_lat, 4] seeded gaussian × init_noise_sigma."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        lat = torch.randn((1, self.height_latent, self.width_latent, 4), generator=gen,
                          device=self.device, dtype=torch.float32)
        return (lat * self.schedule.init_noise_sigma).to(self.dtype)

    def ancestral_noise(self, exec_steps: int, shape: tuple) -> torch.Tensor:
        """Per-step euler_ancestral draws [exec_steps, *shape] of the next
        denoise call, from a generator seeded by (noise_seed_base, call)."""
        seed = (self.noise_seed_base * 1_000_003 + self._noise_call) % (2**63)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((exec_steps,) + tuple(shape), generator=gen, device=self.device, dtype=torch.float32)

    def default_time_ids(self, batch: int) -> torch.Tensor:
        """SDXL micro-conditioning (orig_h, orig_w, crop_top, crop_left,
        target_h, target_w) at the real output size."""
        tid = torch.tensor([[self.height_img, self.width_img, 0, 0, self.height_img, self.width_img]],
                           dtype=torch.float32, device=self.device)
        return tid.repeat(batch, 1).to(self.dtype)

    # --------------------------------------------------------- decode path

    @torch.no_grad()
    def decode_to_pm1_batched(self, latents: torch.Tensor) -> torch.Tensor:
        """[B,h,w,4] → [B,H,W,3] images in [-1,1], on the device, decoded in
        chunks of `decode_chunk` so full-resolution activations stay bounded."""
        outs = []
        c = max(1, self.decode_chunk)
        for i in range(0, latents.shape[0], c):
            z = latents[i : i + c].float().permute(0, 3, 1, 2) / self.spec.vae.scaling_factor
            img = self.vae.decode(z.contiguous()).permute(0, 2, 3, 1)
            outs.append(torch.clamp(img, -1.0, 1.0))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    @staticmethod
    def to_uint8_device(imgs_pm1: torch.Tensor) -> torch.Tensor:
        """[-1,1] → uint8, still on the device."""
        return (torch.clamp(imgs_pm1 / 2 + 0.5, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    # -------------------------------------------------------- denoise paths

    def _unet_apply(self, lat, t, pe, pool, tids):
        eps = self.unet(lat.permute(0, 3, 1, 2), t, pe, pool, tids)
        return eps.permute(0, 2, 3, 1).contiguous()

    def _conditioning(self, text_embeddings, batch: int) -> Conditioning:
        pe, ne, pool, npool = text_embeddings

        def rep(x):
            x = x.to(self.dtype)
            return x.repeat((batch,) + (1,) * (x.ndim - 1)) if x.shape[0] == 1 else x

        tids = self.default_time_ids(batch)
        return Conditioning(rep(pe), rep(pool), tids, rep(ne), rep(npool), tids)

    @torch.no_grad()
    def run_diffusion_batched(
        self,
        cond: Conditioning,
        latents_start: torch.Tensor,  # [B,h,w,4]
        idx_start: int = 0,
        mix_traj=None,  # [N,B,h,w,4]
        mixing_coeffs=None,  # [N] or [N,B]
        guidance_scale=None,  # [B] or None
        guidance_rescale=None,  # float or None (→ holder default)
    ) -> torch.Tensor:
        """One batched denoise over [idx_start, N); returns traj [M,B,h,w,4]."""
        B = latents_start.shape[0]
        N = self.num_inference_steps
        use_cfg = self.do_classifier_free_guidance
        if guidance_scale is None:
            guidance_scale = torch.full((B,), self.guidance_scale, dtype=torch.float32)
        guidance_scale = torch.as_tensor(guidance_scale, dtype=torch.float32, device=self.device)
        if guidance_rescale is None:
            guidance_rescale = self.guidance_rescale
        latents_start = latents_start.to(self.dtype).contiguous()
        mw, mc = build_mix_inputs(N, idx_start, mix_traj, mixing_coeffs, latents_start)
        plan = DenoisePlan(
            num_steps=N, idx_start=idx_start, batch=B, use_cfg=use_cfg,
            guidance_rescale=float(guidance_rescale) if use_cfg else 0.0,
            sched=self.schedule.config.scheduler_type,
        )
        noise = None
        if plan.sched == "euler_ancestral":
            noise = self.ancestral_noise(plan.exec_steps, tuple(latents_start.shape))
        self._noise_call += 1
        return denoise_scan(
            self._unet_apply, plan, latents_start, cond, mw.to(self.dtype), mc,
            self.schedule.sigmas, self.schedule.timesteps, guidance_scale, noise=noise,
        )

    def run_diffusion(self, text_embeddings, latents_start: torch.Tensor, idx_start: int = 0,
                      list_latents_mixing=None, mixing_coeffs=0.0, guidance_rescale: float | None = None):
        """Single-branch API: the full-length latent list with None for
        skipped steps."""
        N = self.num_inference_steps
        if isinstance(mixing_coeffs, float):
            coeffs = np.full(N, mixing_coeffs, np.float32)
        else:
            coeffs = np.asarray(mixing_coeffs, np.float32)
            if len(coeffs) != N:
                raise ValueError(f"len(mixing_coeffs) {len(coeffs)} != num_inference_steps {N}")
        mix_traj = None
        if list_latents_mixing is not None and coeffs.sum() > 0:
            mix_traj = torch.stack([
                torch.zeros_like(latents_start) if li is None else li.to(self.dtype) for li in list_latents_mixing[:N]
            ], dim=0)
        cond = self._conditioning(text_embeddings, 1)
        traj = self.run_diffusion_batched(
            cond, latents_start, idx_start, mix_traj, coeffs if mix_traj is not None else None,
            guidance_rescale=guidance_rescale,
        )
        return [None] * idx_start + [traj[j] for j in range(N - idx_start)]
