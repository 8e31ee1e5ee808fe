"""Model configurations: SDXL-base, SDXL-Turbo, and tiny test variants.

Values mirror the HF config.json of stabilityai/stable-diffusion-xl-base-1.0
and stabilityai/sdxl-turbo (the models the reference loads via diffusers,
reference diffusers_holder.py:32-35, example_single_trans.py:11-12). The
architecture is identical between base and turbo; only sample_size differs
(128 vs 64) plus the scheduler spacing (leading vs trailing).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    # number of attention heads per level (SDXL stores this in
    # attention_head_dim — a known diffusers quirk; head dim is 64)
    num_attention_heads: tuple[int, ...] = (5, 10, 20)
    transformer_layers_per_block: tuple[int, ...] = (1, 2, 10)
    # which levels have cross-attention transformers (level 0 is plain)
    down_block_has_attn: tuple[bool, ...] = (False, True, True)
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    time_embed_dim_mult: int = 4  # time_embed_dim = block_out_channels[0] * 4
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025
    force_upcast: bool = True


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # ViT-L; bigG uses "gelu"
    projection_dim: int | None = None  # set for text_encoder_2 (pooled output)
    eos_token_id: int = 49407
    layer_norm_eps: float = 1e-5


# --- SDXL production configs -------------------------------------------------

SDXL_BASE_UNET = UNetConfig(sample_size=128)
SDXL_TURBO_UNET = UNetConfig(sample_size=64)
SDXL_VAE = VAEConfig()
# text_encoder (OpenAI CLIP ViT-L/14)
SDXL_CLIP_L = CLIPTextConfig()
# text_encoder_2 (OpenCLIP ViT-bigG/14)
SDXL_CLIP_BIGG = CLIPTextConfig(
    hidden_size=1280,
    num_layers=32,
    num_heads=20,
    intermediate_size=5120,
    hidden_act="gelu",
    projection_dim=1280,
)


# --- tiny configs for fast CPU tests -----------------------------------------

TINY_UNET = UNetConfig(
    sample_size=16,
    block_out_channels=(32, 64, 128),
    layers_per_block=1,
    num_attention_heads=(1, 2, 4),
    transformer_layers_per_block=(1, 1, 1),
    cross_attention_dim=64,
    norm_num_groups=8,
    addition_time_embed_dim=8,
    # pooled (32*4=128? no: time_embed_dim = 32*4 = 128) — pooled text dim 64
    # + 6 * 8 = 112
    projection_class_embeddings_input_dim=64 + 6 * 8,
)

TINY_VAE = VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=4)

TINY_CLIP = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    intermediate_size=64,
    max_position_embeddings=77,
    eos_token_id=999,
)
TINY_CLIP_PROJ = dataclasses.replace(TINY_CLIP, projection_dim=48, hidden_act="gelu")
