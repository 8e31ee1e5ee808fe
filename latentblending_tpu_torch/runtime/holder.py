"""SDXLHolder — the diffusion runtime (UNet, VAE, two CLIP towers, the
scheduler tables and tokenizers), in PyTorch; SD3Holder, the same runtime
over SD3's MMDiT, three text towers and flow-matching schedule.

Counterpart of latentblending_tpu/runtime/holder.py. The holder owns torch
modules on `device`, the card unless the caller passes device="cpu" (it
raises where there is no card); the public tensors keep the JAX package's
layout (latents [B,h,w,4], images [B,H,W,3] in [-1,1]) and the holder
permutes to NCHW at the UNet/VAE boundary. The UNet runs in `dtype` (bf16
by default), the VAE in `vae_dtype` (float32 by default: the reference's
force_upcast, and what the JAX package does off the TPU; bf16 on request,
with float32 norms); the CLIP towers compute in float32.
Random noise comes from explicit torch.Generators; it cannot reproduce
jax.random draws, so tests hand both packages the same draws.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from latentblending_tpu_torch import profiling
from latentblending_tpu_torch.models import configs as C
from latentblending_tpu_torch.models.clip import CLIPTextEncoder
from latentblending_tpu_torch.models.layers import cast_keep_norms_f32, init_like_jax_
from latentblending_tpu_torch.models.mmdit import MMDiT
from latentblending_tpu_torch.models.sd3_configs import SD3_SPECS, SD3Spec
from latentblending_tpu_torch.models.t5 import T5Encoder, T5HashTokenizer
from latentblending_tpu_torch.models.tokenizer import CLIPTokenizer, HashTokenizer
from latentblending_tpu_torch.models.unet import UNet2DCondition
from latentblending_tpu_torch.models.vae import VAE
from latentblending_tpu_torch.ops.resize import resize_area
from latentblending_tpu_torch.ops.scheduler import (
    SDXL_BASE_SCHEDULER,
    SDXL_TURBO_EULER_SCHEDULER,
    SDXL_TURBO_SCHEDULER,
    SchedulerState,
    make_schedule,
    scheduler_config_from_hf,
)
from latentblending_tpu_torch.runtime.denoise import (
    Conditioning,
    DenoisePlan,
    build_mix_inputs,
    denoise_scan,
    denoise_scan_tree,
    denoise_scan_tree_seg,
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


def build_modules(spec: ModelSpec, dtype: torch.dtype, device,
                  vae_dtype: Optional[torch.dtype] = None) -> dict[str, nn.Module]:
    """The four modules of a spec, allocated uninitialised on `device`
    (structure built on the meta device: no memory is touched twice). UNet
    in `dtype` and VAE in `vae_dtype` (None: float32), each with float32
    norms; CLIP towers in float32."""
    with torch.device("meta"):
        mods = {
            "unet": cast_keep_norms_f32(UNet2DCondition(spec.unet, spec.pooled_dim), dtype),
            "vae": cast_keep_norms_f32(VAE(spec.vae), vae_dtype or torch.float32),
            "clip1": CLIPTextEncoder(spec.clip1),
            "clip2": CLIPTextEncoder(spec.clip2),
        }
    return {k: m.to_empty(device=device).eval().requires_grad_(False) for k, m in mods.items()}


def _holder_device(device) -> torch.device:
    """The holder's device; a CUDA device needs a card (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SDXLHolder: no CUDA device; pass device=\"cpu\" to run on the CPU")
    return device


class SDXLHolder:
    def __init__(self, spec: ModelSpec | str, modules: dict[str, nn.Module], tokenizer1=None, tokenizer2=None,
                 dtype: torch.dtype = torch.bfloat16, vae_dtype: Optional[torch.dtype] = None, device="cuda",
                 mesh=None):
        """modules: {'unet', 'vae', 'clip1', 'clip2'} port nn.Modules on `device`
        (the card unless the caller asks for the CPU), the VAE's weights in
        `vae_dtype`.

        mesh: a parallel.mesh.Mesh, or None (one device). With a mesh every
        rank holds the same weights (checked at the first denoise), shards
        each stem batch over the mesh's 'data' axis and, when its 'model'
        axis is > 1, the UNet's transformer blocks over it (parallel/tp.py);
        the decode and the text towers run replicated on every rank.

        vae_dtype: None means float32. The JAX package picks bf16 when its
        backend is a TPU and float32 elsewhere; the port keeps float32 on
        the card until a bf16 VAE's keyframes are measured there, since it
        changes every keyframe. torch.bfloat16 runs the VAE (decode and
        encode) in bf16 with float32 norms, as the JAX package's bf16 VAE
        does, and its mid-block attention on the bf16 kernel (K3 bf16)."""
        self.spec = spec if isinstance(spec, ModelSpec) else SPECS[spec]
        self.dtype = dtype
        self.vae_dtype = torch.float32 if vae_dtype is None else vae_dtype
        vae_weights = modules["vae"].weight_dtype
        if vae_weights != self.vae_dtype:
            raise ValueError(f"SDXLHolder: the VAE's weights are {vae_weights}, vae_dtype is {self.vae_dtype}")
        self.device = _holder_device(device)
        self.is_sdxl_turbo = self.spec.is_sdxl_turbo
        self.unet = modules["unet"]
        self.vae = modules["vae"]
        self.clip1 = modules["clip1"]
        self.clip2 = modules["clip2"]
        self.mesh = mesh
        self._params_placed = False

        self.tokenizer1 = tokenizer1 or HashTokenizer(
            self.spec.clip1.vocab_size, bos_token_id=0, eos_token_id=self.spec.clip1.eos_token_id,
            pad_token_id=self.spec.clip1.eos_token_id,
        )
        self.tokenizer2 = tokenizer2 or HashTokenizer(
            self.spec.clip2.vocab_size, bos_token_id=0, eos_token_id=self.spec.clip2.eos_token_id, pad_token_id=0
        )
        self.negative_prompt = ""
        self._init_state()

    def _init_state(self) -> None:
        """The runtime state every holder starts from: guidance, the noise
        stream, the denoise signatures seen, carried spans, the schedule at
        the default step count and the spec's default size."""
        self.guidance_scale = self.default_guidance_scale
        self.guidance_rescale = 0.0
        # ancestral per-step noise: deterministic in (noise_seed_base, call
        # index); the engine restarts the stream at each transition
        self.noise_seed_base = 0
        self._noise_call = 0
        self._decode_chunk_override: Optional[int] = None
        # denoise signatures already run (see _note_warm)
        self._warm_keys: set = set()
        self.last_run_was_warm = False
        # embed spans taken while no transition was open, for the next one
        self.carried_spans: list = []
        self.num_inference_steps = self.default_num_inference_steps
        self.schedule: SchedulerState = make_schedule(self.spec.scheduler, self.num_inference_steps)
        self.set_dimensions(self.spec.default_size)

    # ------------------------------------------------------------- factories

    @classmethod
    def from_random(cls, spec: ModelSpec | str = "tiny-turbo", seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                    vae_dtype: Optional[torch.dtype] = None, device="cuda", **kw) -> "SDXLHolder":
        """Random-weight holder of the full architecture, built and
        initialised directly on `device` (initialisation as the JAX
        package's flax init, drawn from a torch.Generator seeded with `seed`).
        vae_dtype as in __init__ (None: float32)."""
        spec = spec if isinstance(spec, ModelSpec) else SPECS[spec]
        device = _holder_device(device)
        mods = build_modules(spec, dtype, device, vae_dtype)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        for m in mods.values():
            init_like_jax_(m, gen)
        return cls(spec, mods, dtype=dtype, vae_dtype=vae_dtype, device=device, **kw)

    @classmethod
    def from_state_dicts(cls, spec: ModelSpec | str, state_dicts: dict[str, dict], dtype: torch.dtype = torch.bfloat16,
                         vae_dtype: Optional[torch.dtype] = None, device="cuda", **kw) -> "SDXLHolder":
        """Holder from {'unet','vae','clip1','clip2'} state dicts in the port's
        (HF) key names, e.g. from models.weights.params_from_jax; each tensor
        is stored in its module's dtype. vae_dtype as in __init__."""
        spec = spec if isinstance(spec, ModelSpec) else SPECS[spec]
        device = _holder_device(device)
        mods = build_modules(spec, dtype, device, vae_dtype)
        for name, m in mods.items():
            m.load_state_dict(state_dicts[name], strict=True)
        return cls(spec, mods, dtype=dtype, vae_dtype=vae_dtype, device=device, **kw)

    @classmethod
    def from_pretrained(cls, snapshot_dir: str, spec: ModelSpec | str | None = None,
                        dtype: torch.dtype = torch.bfloat16, vae_dtype: Optional[torch.dtype] = None,
                        device="cuda", **kw) -> "SDXLHolder":
        """Holder from a HF snapshot directory (unet/, vae/, text_encoder/,
        text_encoder_2/ with .safetensors; scheduler/scheduler_config.json,
        tokenizer/ and tokenizer_2/ where present), as the JAX package's
        from_pretrained loads it: the spec is SDXL-Turbo when "turbo" is in
        the directory's name, else SDXL-base; the checkpoint's scheduler
        config overrides the spec's.

        Each UNet and CLIP tensor is rounded to `dtype` on load, as the JAX
        loader stores them; the CLIP towers keep the rounded values in
        float32 and compute in float32 (the JAX package's bf16 storage with
        f32 compute). The VAE loads as stored, in vae_dtype (None: float32).
        Loading is strict, but for the two CLIP keys real checkpoints carry
        and the tower does not use (models/weights.CLIP_UNUSED:
        `logit_scale`, which the JAX converter drops, and
        `text_model.embeddings.position_ids`, a buffer of older transformers
        checkpoints), which are not read."""
        from latentblending_tpu_torch.models.weights import load_clip, load_sdxl_unet, load_sdxl_vae

        if spec is None:
            spec = SDXL_TURBO if "turbo" in os.fspath(snapshot_dir).lower() else SDXL_BASE
        spec = spec if isinstance(spec, ModelSpec) else SPECS[spec]
        sched_fp = os.path.join(snapshot_dir, "scheduler", "scheduler_config.json")
        if os.path.isfile(sched_fp):
            with open(sched_fp) as f:
                spec = dataclasses.replace(spec, scheduler=scheduler_config_from_hf(json.load(f), spec.scheduler))
        device = _holder_device(device)

        def rounded(sd: dict) -> dict:
            return {k: v.to(dtype) for k, v in sd.items()}

        state_dicts = {"unet": rounded(load_sdxl_unet(snapshot_dir)), "vae": load_sdxl_vae(snapshot_dir),
                       "clip1": rounded(load_clip(snapshot_dir, "text_encoder")),
                       "clip2": rounded(load_clip(snapshot_dir, "text_encoder_2"))}
        mods = build_modules(spec, dtype, device, vae_dtype)
        for name, m in mods.items():
            m.load_state_dict(state_dicts.pop(name), strict=True)
        toks = [CLIPTokenizer.from_dir(os.path.join(snapshot_dir, d))
                if os.path.isdir(os.path.join(snapshot_dir, d)) else None for d in ("tokenizer", "tokenizer_2")]
        return cls(spec, mods, tokenizer1=toks[0], tokenizer2=toks[1], dtype=dtype, vae_dtype=vae_dtype,
                   device=device, **kw)

    # ----------------------------------------------------------------- state

    @property
    def default_guidance_scale(self) -> float:
        """The family's CFG scale: none for turbo, 4.0 for SDXL-base."""
        return 0.0 if self.is_sdxl_turbo else 4.0

    @property
    def default_num_inference_steps(self) -> int:
        return 4 if self.is_sdxl_turbo else 30

    @property
    def latent_channels(self) -> int:
        return self.spec.vae.latent_channels

    def init_types(self) -> dict:
        """The reference's runtime dtype probe and turbo detection, here
        static properties of the spec and the holder."""
        return {"dtype": self.dtype, "is_sdxl_turbo": self.is_sdxl_turbo}

    def prepare_mixing(self, mixing_coeffs, list_latents_mixing) -> list:
        """mixing_coeffs (a float, or one value per step) → a per-step list;
        raises ValueError if its length, or that of a mixing trajectory it
        needs, is not num_inference_steps."""
        N = self.num_inference_steps
        if isinstance(mixing_coeffs, float):
            coeffs = N * [mixing_coeffs]
        elif isinstance(mixing_coeffs, (list, tuple, np.ndarray)):
            if len(mixing_coeffs) != N:
                raise ValueError(f"len(mixing_coeffs) {len(mixing_coeffs)} != num_inference_steps {N}")
            coeffs = list(mixing_coeffs)
        else:
            raise ValueError("mixing_coeffs should be float or list with len=num_inference_steps")
        if np.sum(coeffs) > 0 and len(list_latents_mixing) != N:
            raise ValueError(f"len(list_latents_mixing) {len(list_latents_mixing)} != num_inference_steps {N}")
        return coeffs

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
        """VAE decode batch per call: a value set on the holder, else
        LB_DECODE_CHUNK, else the JAX package's rule: a base of 8 images
        for a bf16 VAE and 4 for an f32 one at ≤512², base // 4 between
        512² and 1024², 1 at ≥1024². The rule's numbers were measured on a
        TPU v5e (the JAX package's tools/profile_vae.py), not on the GPU."""
        if self._decode_chunk_override is not None:
            return self._decode_chunk_override
        env = os.environ.get("LB_DECODE_CHUNK")
        if env:
            return max(1, int(env))
        base = 8 if self.vae_dtype == torch.bfloat16 else 4
        area = self.height_img * self.width_img
        if area >= 1024 * 1024:
            return 1
        if area <= 512 * 512:
            return base
        return max(1, base // 4)

    @decode_chunk.setter
    def decode_chunk(self, value: int):
        self._decode_chunk_override = int(value)

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
        each with batch 1, in the holder's dtype: the tracer's `embed`
        span, kept in carried_spans for the next transition when none is
        open."""
        with profiling.span("embed", device=self.device, carry=self.carried_spans):
            ids1 = torch.as_tensor(self.tokenizer1([prompt, self.negative_prompt]), dtype=torch.long,
                                   device=self.device)
            ids2 = torch.as_tensor(self.tokenizer2([prompt, self.negative_prompt]), dtype=torch.long,
                                   device=self.device)
            pen1, _, _ = self.clip1(ids1)
            pen2, _, pooled = self.clip2(ids2)
            embeds = torch.cat([pen1, pen2], dim=-1)
            return (embeds[0:1].to(self.dtype), embeds[1:2].to(self.dtype),
                    pooled[0:1].to(self.dtype), pooled[1:2].to(self.dtype))

    # ----------------------------------------------------------- noise path

    def get_noise(self, seed: int = 420) -> torch.Tensor:
        """[1, h_lat, w_lat, c] seeded gaussian × init_noise_sigma (c the
        VAE's latent channels)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        lat = torch.randn((1, self.height_latent, self.width_latent, self.latent_channels), generator=gen,
                          device=self.device, dtype=torch.float32)
        return (lat * self.schedule.init_noise_sigma).to(self.dtype)

    def ancestral_noise(self, exec_steps: int, shape: tuple) -> torch.Tensor:
        """Per-step euler_ancestral draws [exec_steps, *shape] of the next
        denoise call, from a generator seeded by (noise_seed_base, call)."""
        seed = (self.noise_seed_base * 1_000_003 + self._noise_call) % (2**63)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((exec_steps,) + tuple(shape), generator=gen, device=self.device, dtype=torch.float32)

    def ancestral_noise_steps(self, shapes) -> list[torch.Tensor]:
        """Per-step euler_ancestral draws of the next denoise call whose
        batch changes between steps: step i draws shapes[i] (the live rows of
        the segmented scan), from a generator seeded as in ancestral_noise."""
        seed = (self.noise_seed_base * 1_000_003 + self._noise_call) % (2**63)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return [torch.randn(tuple(s), generator=gen, device=self.device, dtype=torch.float32) for s in shapes]

    def default_time_ids(self, batch: int) -> torch.Tensor:
        """SDXL micro-conditioning (orig_h, orig_w, crop_top, crop_left,
        target_h, target_w) at the real output size."""
        tid = torch.tensor([[self.height_img, self.width_img, 0, 0, self.height_img, self.width_img]],
                           dtype=torch.float32, device=self.device)
        return tid.repeat(batch, 1).to(self.dtype)

    # --------------------------------------------------------- decode path

    # the VAE's latent shift (SD3's shift_factor); SDXL has none
    vae_shift_factor: Optional[float] = None

    @torch.no_grad()
    def decode_to_pm1_batched(self, latents: torch.Tensor) -> torch.Tensor:
        """[B,h,w,c] → [B,H,W,3] images in [-1,1], on the device, decoded in
        chunks of `decode_chunk` so full-resolution activations stay bounded:
        z / scaling_factor (+ shift_factor), then the VAE's decode."""
        outs = []
        c = max(1, self.decode_chunk)
        with profiling.span("vae.decode", device=latents.device, rows=latents.shape[0]):
            for i in range(0, latents.shape[0], c):
                z = latents[i : i + c].float().permute(0, 3, 1, 2) / self.spec.vae.scaling_factor
                if self.vae_shift_factor is not None:
                    z = z + self.vae_shift_factor
                img = self.vae.decode(z.contiguous()).permute(0, 2, 3, 1)
                outs.append(torch.clamp(img, -1.0, 1.0))
            return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    @staticmethod
    def to_uint8_device(imgs_pm1: torch.Tensor) -> torch.Tensor:
        """[-1,1] → uint8, still on the device. The conversions to uint8
        (this, to_i420_device, latent2image) compute in float32 whatever
        the VAE's dtype, so a bf16 image is rounded once. The JAX package
        computes them in the image's dtype, rounding after every op; on the
        same bf16 images the two agree within 1 (RGB) and 2 (I420)."""
        return (torch.clamp(imgs_pm1.float() / 2 + 0.5, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    @staticmethod
    def to_i420_device(imgs_pm1: torch.Tensor) -> torch.Tensor:
        """[-1,1] [B,H,W,3] → packed I420 uint8 [B, H*3/2, W], on the device.

        JFIF full-range BT.601 (ITU-T T.871 §7) with 2×2 mean-pooled chroma,
        the layout of video/i420.py (Y rows, then Cb and Cr at two chroma
        rows per buffer row): 1.5 bytes per pixel leave the device instead
        of 3. Needs H % 4 == 0 and even W."""
        B, H, W = imgs_pm1.shape[:3]
        if H % 4 or W % 2:
            raise ValueError(f"I420 needs H % 4 == 0 and even W, got {(H, W)}")
        rgb = torch.clamp(imgs_pm1.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
        cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b

        def pool(c):
            return c.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))

        def u8(x):
            return torch.clamp(x + 0.5, 0.0, 255.0).to(torch.uint8)

        return torch.cat([u8(y), u8(pool(cb)).reshape(B, H // 4, W), u8(pool(cr)).reshape(B, H // 4, W)], dim=1)

    @staticmethod
    def pm1_to_uint8(imgs_pm1: torch.Tensor) -> np.ndarray:
        """[-1,1] device images → host uint8 [B,H,W,3] (one transfer)."""
        return SDXLHolder.to_uint8_device(imgs_pm1).cpu().numpy()

    def latents2images_batched(self, latents: torch.Tensor) -> list[np.ndarray]:
        """[B,h,w,4] → list of uint8 images via chunked batched decodes."""
        arr = self.pm1_to_uint8(self.decode_to_pm1_batched(latents))
        return [arr[i] for i in range(arr.shape[0])]

    def latent2image(self, latents: torch.Tensor, output_type: str = "np"):
        """Final latent [h,w,4] or [1,h,w,4] → uint8 image [H,W,3] (rounded
        to nearest, as the JAX package); output_type "pil" gives a PIL image
        (PIL is imported on that branch only)."""
        if latents.ndim == 3:
            latents = latents[None]
        img = self.decode_to_pm1_batched(latents[:1])
        img = (torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0) * 255.0).round().to(torch.uint8)[0].cpu().numpy()
        if output_type == "pil":
            from PIL import Image

            return Image.fromarray(img)
        return img

    # --------------------------------------------------------- encode path

    @torch.no_grad()
    def image2latent(self, image) -> torch.Tensor:
        """uint8 image [H,W,3] (or anything np.asarray takes; PIL is never
        imported) → scaled latent [1,h,w,4], the posterior mean, in the
        holder's dtype. An image of another size is resized on the device
        with OpenCV's INTER_AREA rule (ops/resize.py), where the JAX package
        calls cv2.resize on the host. The VAE encodes in vae_dtype."""
        x = torch.as_tensor(np.ascontiguousarray(np.asarray(image)), device=self.device)
        if tuple(x.shape[:2]) != (self.height_img, self.width_img):
            x = resize_area(x, self.height_img, self.width_img)
        x = x.to(torch.float32)[None] / 255.0 * 2.0 - 1.0
        mean, _ = self.vae.encode(x.permute(0, 3, 1, 2).contiguous())
        return (mean * self.spec.vae.scaling_factor).permute(0, 2, 3, 1).contiguous().to(self.dtype)

    # -------------------------------------------------------- denoise paths

    def _note_warm(self, key: tuple) -> None:
        """Set last_run_was_warm for a denoise call of signature `key`.

        Rule: a call is cold (False) the first time this holder runs its
        signature (path, batch and latent shape, window start, CFG, solver),
        on any device, and warm after. On the GPU the cold call pays the
        kernel library build (first call), cuBLAS/cuDNN algorithm selection
        for the new shapes and allocator growth, so only warm calls are
        timing samples for the engine's cost model."""
        self.last_run_was_warm = key in self._warm_keys
        self._warm_keys.add(key)

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
            # drawn for the unsharded batch on every rank: a sharded run
            # draws what the unsharded one draws
            noise = self.ancestral_noise(plan.exec_steps, tuple(latents_start.shape))
        self._noise_call += 1
        self._note_warm(("level", plan, tuple(latents_start.shape)))
        if self.mesh is not None:
            return self._denoise_sharded(plan, latents_start, cond, mw.to(self.dtype), mc, guidance_scale, noise)
        return denoise_scan(
            self._unet_apply, plan, latents_start, cond, mw.to(self.dtype), mc,
            self.schedule.sigmas, self.schedule.timesteps, guidance_scale, noise=noise,
        )

    def _place_params(self) -> None:
        """Once, before the first sharded denoise: check that every rank
        holds the same weights (replicate_params over all four modules), then
        Megatron-shard the UNet when the 'model' axis is > 1
        (latentblending_tpu/runtime/holder.py:550-557)."""
        from latentblending_tpu_torch.parallel.mesh import replicate_params
        from latentblending_tpu_torch.parallel.tp import shard_unet_params

        if self._params_placed:
            return
        replicate_params(nn.ModuleDict({"unet": self.unet, "vae": self.vae, "clip1": self.clip1,
                                        "clip2": self.clip2}), self.mesh)
        if self.mesh.shape["model"] > 1:
            shard_unet_params(self.unet, self.mesh)
        self._params_placed = True

    def _denoise_sharded(self, plan: DenoisePlan, latents_start, cond: Conditioning, mw, mc, guidance_scale,
                         noise) -> torch.Tensor:
        """run_diffusion_batched under a mesh (latentblending_tpu/runtime/holder.py:531-595):
        the batch padded to a multiple of the 'data' axis by repeating its
        last row (latents, conditioning, guidance, mix window and
        coefficients, ancestral draws), this rank's rows denoised, the
        trajectories gathered over the data group and sliced back to B."""
        from latentblending_tpu_torch.parallel.mesh import gather_stem_batch, pad_to_multiple, shard_stem_batch

        mesh = self.mesh
        B = latents_start.shape[0]
        B_run = pad_to_multiple(B, mesh.shape["data"])

        def rows(x, dim=0):
            if B_run != B:
                x = torch.cat([x] + [x.narrow(dim, B - 1, 1)] * (B_run - B), dim=dim)
            return shard_stem_batch(x, mesh, dim).contiguous()

        self._place_params()
        local = dataclasses.replace(plan, batch=B_run // mesh.shape["data"])
        cond = Conditioning(*(None if c is None else rows(c)
                              for c in (getattr(cond, f.name) for f in dataclasses.fields(cond))))
        traj = denoise_scan(
            self._unet_apply, local, rows(latents_start), cond, rows(mw, 1), rows(mc, 1),
            self.schedule.sigmas, self.schedule.timesteps, rows(guidance_scale),
            noise=None if noise is None else rows(noise, 1),
        )
        return gather_stem_batch(traj, mesh, dim=1)[:, :B]

    def _single_device(self, name: str) -> None:
        """The fused tree scans gather rows within the batch, which would
        all-gather a 'data'-sharded batch at every step: mesh holders run
        run_diffusion_batched per level instead (the JAX package asserts the
        same, latentblending_tpu/runtime/holder.py:617 and :671)."""
        if self.mesh is not None:
            raise RuntimeError(f"{name} is a single-device path; a mesh holder runs run_diffusion_batched per level")

    @torch.no_grad()
    def run_tree_batched(
        self,
        cond: Conditioning,
        latents_start: torch.Tensor,  # [B,h,w,4] — edges then stems
        parent_idx,  # [B,2] int — in-batch parent rows (self for edges)
        parent_fract,  # [B] float — parental slerp fraction per row
        coeffs,  # [N,B] float — crossfeed coefficient per (step,row)
        guidance_scale=None,  # [B] or None
        win_steps=None,  # [N,h,w,4] recycled-edge entering-states, or None
        win_mask=None,  # [B] bool — rows whose parent-1 is the window
        pin_steps=None,  # [B] int — injection step per row (0 = edge)
    ) -> torch.Tensor:
        """ONE fused loop over [0,N) computing the edge trajectories and all
        stems of a single-level plan (denoise_scan_tree); returns traj
        [N,B,h,w,4]. The euler_ancestral draws of the whole call come from
        one ancestral_noise(N, (B,h,w,4)) call. A single-device path: under a
        mesh it raises, and the engine runs the per-level path."""
        self._single_device("run_tree_batched")
        B = latents_start.shape[0]
        N = self.num_inference_steps
        use_cfg = self.do_classifier_free_guidance
        if guidance_scale is None:
            guidance_scale = torch.full((B,), self.guidance_scale, dtype=torch.float32)
        guidance_scale = torch.as_tensor(guidance_scale, dtype=torch.float32, device=self.device)
        latents_start = latents_start.to(self.dtype).contiguous()
        plan = DenoisePlan(
            num_steps=N, idx_start=0, batch=B, use_cfg=use_cfg,
            guidance_rescale=float(self.guidance_rescale) if use_cfg else 0.0,
            sched=self.schedule.config.scheduler_type,
        )
        noise = None
        if plan.sched == "euler_ancestral":
            noise = self.ancestral_noise(N, tuple(latents_start.shape))
        self._noise_call += 1
        self._note_warm(("tree", win_steps is not None, plan, tuple(latents_start.shape)))
        cw = np.asarray(coeffs, np.float32).copy()
        cw[0, :] = 0.0  # step 0 has no predecessor state to mix toward
        return denoise_scan_tree(
            self._unet_apply, plan, latents_start, cond,
            torch.as_tensor(np.asarray(parent_idx), dtype=torch.long, device=self.device),
            torch.as_tensor(np.asarray(parent_fract, np.float32), device=self.device),
            torch.from_numpy(cw).to(self.device), self.schedule.sigmas, self.schedule.timesteps,
            guidance_scale, noise=noise,
            win_steps=None if win_steps is None else win_steps.to(self.dtype),
            win_mask=win_mask, pin_steps=pin_steps,
        )

    @torch.no_grad()
    def run_tree_seg_batched(
        self,
        cond: Conditioning,
        latents_start: torch.Tensor,  # [B0,h,w,4] — the edge rows only
        parent_idx,  # [B,2] int — in-batch parent rows (self for edges)
        parent_fract,  # [B] float — parental slerp fraction per row
        coeffs,  # [N,B] float — crossfeed coefficient per (step,row)
        guidance_scale,  # [B]
        segs,  # ((start_step, batch), ...) — rows ordered by injection step
        win_steps=None,  # [N,h,w,4] recycled-edge entering-states, or None
        win_mask=None,  # [B] bool — rows whose parent-1 is the window
        pin_steps=None,  # [B] int — injection step per row (0 = edge)
    ) -> tuple:
        """ONE segmented loop computing a whole multi-level plan
        (denoise_scan_tree_seg): each row runs only its useful steps, in the
        largest batch alive at its depth. Returns the per-segment
        trajectories. The euler_ancestral draws of the call come from one
        ancestral_noise_steps call, step i of the live batch's shape. A
        single-device path, as run_tree_batched."""
        self._single_device("run_tree_seg_batched")
        parent_idx = np.asarray(parent_idx, np.int64)
        B = parent_idx.shape[0]
        N = self.num_inference_steps
        segs = tuple((int(i), int(b)) for i, b in segs)
        if segs[0][0] != 0 or segs[-1][1] != B:
            raise ValueError(f"segments {segs} must start at step 0 and end with the whole batch {B}")
        use_cfg = self.do_classifier_free_guidance
        plan = DenoisePlan(
            num_steps=N, idx_start=0, batch=B, use_cfg=use_cfg,
            guidance_rescale=float(self.guidance_rescale) if use_cfg else 0.0,
            sched=self.schedule.config.scheduler_type, segs=segs,
        )
        latents_start = latents_start.to(self.dtype).contiguous()
        noise = None
        if plan.sched == "euler_ancestral":
            live = [next(b for i0, b in reversed(segs) if i0 <= i) for i in range(N)]
            noise = self.ancestral_noise_steps([(b,) + tuple(latents_start.shape[1:]) for b in live])
        self._noise_call += 1
        self._note_warm(("seg", win_steps is not None, plan, tuple(latents_start.shape)))
        cw = np.asarray(coeffs, np.float32).copy()
        cw[0, :] = 0.0  # step 0 has no predecessor state to mix toward
        return denoise_scan_tree_seg(
            self._unet_apply, plan, latents_start, cond, parent_idx,
            torch.as_tensor(np.asarray(parent_fract, np.float32), device=self.device),
            torch.from_numpy(cw).to(self.device), self.schedule.sigmas, self.schedule.timesteps,
            torch.as_tensor(guidance_scale, dtype=torch.float32, device=self.device), noise=noise,
            win_steps=None if win_steps is None else win_steps.to(self.dtype),
            win_mask=win_mask, pin_steps=pin_steps,
        )

    def run_diffusion(self, text_embeddings, latents_start: torch.Tensor, idx_start: int = 0,
                      list_latents_mixing=None, mixing_coeffs=0.0, return_image: bool = False,
                      guidance_rescale: float | None = None):
        """Single-branch API: the full-length latent list with None for
        skipped steps, or with return_image the last latent's uint8 image
        (latent2image)."""
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
        out = [None] * idx_start + [traj[j] for j in range(N - idx_start)]
        if return_image:
            return self.latent2image(out[-1])
        return out

    # the reference's name for the SDXL loop
    run_diffusion_sd_xl = run_diffusion

    # ------------------------------------------------------------- timing

    def benchmark_speed(self) -> tuple[float, float]:
        """Wall of one UNet step (the last step of the schedule, one branch)
        and of one VAE decode, each the second of two calls — the budget
        planner's inputs under cost_model='reference'."""
        te = self.get_text_embedding("test")
        lat = self.get_noise(0)
        idx = self.num_inference_steps - 1
        self.run_diffusion(te, lat, idx_start=idx)
        with profiling.wait("benchmark"):
            if lat.is_cuda:
                torch.cuda.synchronize(lat.device)
        t0 = time.time()
        out = self.run_diffusion(te, lat, idx_start=idx)
        with profiling.wait("benchmark"):
            if lat.is_cuda:
                torch.cuda.synchronize(lat.device)
        dt_unet_step = time.time() - t0
        self.latent2image(out[-1])  # a host copy: it waits for the decode
        t0 = time.time()
        self.latent2image(out[-1])
        return dt_unet_step, time.time() - t0


# ------------------------------------------------------------------ SD3


def build_sd3_modules(spec: SD3Spec, dtype: torch.dtype, device, vae_dtype: Optional[torch.dtype] = None,
                      t5_dtype: Optional[torch.dtype] = None) -> dict[str, nn.Module]:
    """The five modules of an SD3 spec, allocated uninitialised on `device`
    (built on the meta device): the MMDiT in `dtype` and T5 in `t5_dtype`
    (None: `dtype`), each with float32 norms; the VAE in `vae_dtype` (None:
    float32) with no quant convs; both CLIP towers in float32."""
    with torch.device("meta"):
        mods = {
            "mmdit": cast_keep_norms_f32(MMDiT(spec.mmdit), dtype),
            "t5": cast_keep_norms_f32(T5Encoder(spec.t5), t5_dtype or dtype),
            "vae": cast_keep_norms_f32(VAE(spec.vae, use_quant_conv=False,
                                           use_post_quant_conv=spec.vae_post_quant_conv), vae_dtype or torch.float32),
            "clip1": CLIPTextEncoder(spec.clip1),
            "clip2": CLIPTextEncoder(spec.clip2),
        }
    return {k: m.to_empty(device=device).eval().requires_grad_(False) for k, m in mods.items()}


class SD3Holder(SDXLHolder):
    """The runtime of an SD3 pipeline (stabilityai/stable-diffusion-3.5-large):
    SDXLHolder's tree, segmented-tree and decode paths over the MMDiT as the
    denoiser (held as `unet` too, the denoise loops' name for it),
    flow-matching Euler on 16-channel latents, and SD3's conditioning: the
    penultimate states of CLIP-L and OpenCLIP bigG side by side, zero-padded
    to T5's width and followed along the sequence by T5's 256 tokens, the
    two projected pooled features concatenated; no time ids. The decode
    shifts the latents by the VAE's shift_factor.

    What SDXL's holder does and this one cannot, it refuses: a mesh (the
    tensor-parallel rules are the UNet's), image keyframes (no encode path
    was checked for the 16-channel VAE) and samplers other than flow-matching
    Euler."""

    def __init__(self, spec: SD3Spec | str, modules: dict[str, nn.Module], dtype: torch.dtype = torch.bfloat16,
                 vae_dtype: Optional[torch.dtype] = None, device="cuda", mesh=None):
        """modules: {'mmdit', 't5', 'vae', 'clip1', 'clip2'} on `device`
        (build_sd3_modules), the VAE's weights in `vae_dtype` (None:
        float32)."""
        if mesh is not None:
            raise NotImplementedError("SD3Holder runs on one device: the mesh's tensor-parallel rules are the UNet's")
        self.spec = spec if isinstance(spec, SD3Spec) else SD3_SPECS[spec]
        self.dtype = dtype
        self.vae_dtype = torch.float32 if vae_dtype is None else vae_dtype
        if modules["vae"].weight_dtype != self.vae_dtype:
            raise ValueError(f"SD3Holder: the VAE's weights are {modules['vae'].weight_dtype}, "
                             f"vae_dtype is {self.vae_dtype}")
        self.device = _holder_device(device)
        self.is_sdxl_turbo = False
        self.mmdit = self.unet = modules["mmdit"]
        self.t5 = modules["t5"]
        self.vae = modules["vae"]
        self.clip1 = modules["clip1"]
        self.clip2 = modules["clip2"]
        self.mesh = None
        self._params_placed = False
        self.vae_shift_factor = self.spec.vae_shift_factor
        sp = self.spec
        self.tokenizer1 = HashTokenizer(sp.clip1.vocab_size, bos_token_id=0, eos_token_id=sp.clip1.eos_token_id,
                                        pad_token_id=sp.clip1.eos_token_id)
        self.tokenizer2 = HashTokenizer(sp.clip2.vocab_size, bos_token_id=0, eos_token_id=sp.clip2.eos_token_id,
                                        pad_token_id=0)
        self.tokenizer3 = T5HashTokenizer(sp.t5.vocab_size, sp.t5.eos_token_id, sp.t5.pad_token_id,
                                          sp.max_sequence_length)
        self.negative_prompt = ""
        self._init_state()

    @classmethod
    def from_random(cls, spec: SD3Spec | str = "tiny-sd3", seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                    vae_dtype: Optional[torch.dtype] = None, device="cuda", **kw) -> "SD3Holder":
        """Random-weight holder (SDXLHolder.from_random's initialisation)."""
        spec = spec if isinstance(spec, SD3Spec) else SD3_SPECS[spec]
        device = _holder_device(device)
        mods = build_sd3_modules(spec, dtype, device, vae_dtype)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        for m in mods.values():
            init_like_jax_(m, gen)
        return cls(spec, mods, dtype=dtype, vae_dtype=vae_dtype, device=device, **kw)

    @classmethod
    def from_state_dicts(cls, *a, **kw):
        raise NotImplementedError("SD3Holder: build the modules with build_sd3_modules and load them")

    @classmethod
    def from_pretrained(cls, *a, **kw):
        raise NotImplementedError("SD3Holder: no snapshot loader (the MMDiT and T5 have no checkpoint reader)")

    @property
    def default_guidance_scale(self) -> float:
        return self.spec.default_guidance

    @property
    def default_num_inference_steps(self) -> int:
        return self.spec.default_steps

    def set_scheduler_type(self, scheduler_type: str):
        if scheduler_type != "flow_euler":
            raise ValueError(f"SD3Holder samples by flow-matching Euler only, not {scheduler_type!r}")

    @torch.no_grad()
    def get_text_embedding(self, prompt: str):
        """(prompt_embeds [1, 77 + T5 tokens, T5 width], negative, pooled
        [1, 2048], negative pooled) in the holder's dtype: the `embed` span,
        T5 inside it as the `t5` span (both carried to the next transition
        when none is open)."""
        with profiling.span("embed", device=self.device, carry=self.carried_spans):
            texts = [prompt, self.negative_prompt]

            def ids(tok):
                return torch.as_tensor(tok(texts), dtype=torch.long, device=self.device)

            pen1, _, pool1 = self.clip1(ids(self.tokenizer1))
            pen2, _, pool2 = self.clip2(ids(self.tokenizer2))
            with profiling.span("t5", device=self.device, carry=self.carried_spans):
                t5 = self.t5(ids(self.tokenizer3))
            clip = torch.cat([pen1, pen2], dim=-1)
            clip = torch.nn.functional.pad(clip, (0, t5.shape[-1] - clip.shape[-1]))
            embeds = torch.cat([clip.to(self.dtype), t5.to(self.dtype)], dim=1)
            pooled = torch.cat([pool1, pool2], dim=-1)
            return (embeds[0:1], embeds[1:2], pooled[0:1].to(self.dtype), pooled[1:2].to(self.dtype))

    def default_time_ids(self, batch: int):
        """SD3 has no micro-conditioning."""
        return None

    def _unet_apply(self, lat, t, pe, pool, tids):
        v = self.mmdit(lat.permute(0, 3, 1, 2), t, pe, pool)
        return v.permute(0, 2, 3, 1).contiguous()

    def image2latent(self, image) -> torch.Tensor:
        raise NotImplementedError("SD3Holder: image keyframes are not supported (no 16-channel encode path)")
