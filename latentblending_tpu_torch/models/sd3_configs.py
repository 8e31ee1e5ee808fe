"""Model configurations of Stable Diffusion 3.5 Large, and tiny variants.

Values mirror the HF configs of stabilityai/stable-diffusion-3.5-large
(transformer/, vae/, text_encoder{,_2,_3}/, scheduler/). They live apart
from models/configs.py, which is a byte-for-byte copy of the JAX
package's: the JAX package has no SD3.
"""
from __future__ import annotations

import dataclasses

from latentblending_tpu_torch.models.configs import CLIPTextConfig, VAEConfig
from latentblending_tpu_torch.ops.scheduler import SD3_SCHEDULER, FlowMatchSchedulerConfig


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """SD3Transformer2DModel with RMSNorm on Q and K and no dual-attention
    layers."""

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 38
    attention_head_dim: int = 64
    num_attention_heads: int = 38
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 2432
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    time_proj_dim: int = 256  # Timesteps(256, flip_sin_to_cos=True, downscale_freq_shift=0)
    mlp_ratio: int = 4  # FeedForward's default mult: GELU(tanh) dim → 4·dim → dim

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


@dataclasses.dataclass(frozen=True)
class T5Config:
    """T5 v1.1 encoder (T5EncoderModel): gated GELU (tanh), RMS layer norm,
    relative-position bias in layer 0 shared by all layers."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    eos_token_id: int = 1
    pad_token_id: int = 0


@dataclasses.dataclass(frozen=True)
class SD3Spec:
    """Architecture bundle of an SD3 pipeline: the MMDiT, three text towers
    (CLIP-L and OpenCLIP bigG, both projected, and T5), a 16-channel
    AutoencoderKL decoded with a shift and no post-quant conv, and the
    flow-matching scheduler."""

    name: str
    mmdit: MMDiTConfig
    t5: T5Config
    vae: VAEConfig
    clip1: CLIPTextConfig
    clip2: CLIPTextConfig
    scheduler: FlowMatchSchedulerConfig
    default_size: tuple[int, int]
    vae_shift_factor: float = 0.0609
    vae_post_quant_conv: bool = False
    max_sequence_length: int = 256  # T5 tokens
    default_steps: int = 28
    default_guidance: float = 3.5


SD35_LARGE = SD3Spec(
    "sd35-large",
    MMDiTConfig(),
    T5Config(),
    VAEConfig(latent_channels=16, scaling_factor=1.5305),
    dataclasses.replace(CLIPTextConfig(), projection_dim=768),
    CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120, hidden_act="gelu",
                   projection_dim=1280),
    SD3_SCHEDULER,
    (1024, 1024),
)

_TINY_CLIP = CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                            eos_token_id=999)
TINY_SD3 = SD3Spec(
    "tiny-sd3",
    MMDiTConfig(sample_size=16, num_layers=2, attention_head_dim=16, num_attention_heads=2, joint_attention_dim=64,
                caption_projection_dim=32, pooled_projection_dim=80, pos_embed_max_size=12),
    T5Config(vocab_size=1000, d_model=64, d_kv=16, d_ff=96, num_layers=2, num_heads=4),
    VAEConfig(latent_channels=16, block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=4,
              scaling_factor=1.5305),
    dataclasses.replace(_TINY_CLIP, projection_dim=32),
    dataclasses.replace(_TINY_CLIP, projection_dim=48, hidden_act="gelu"),
    SD3_SCHEDULER,
    (128, 128),
    max_sequence_length=32,
    default_steps=8,
)

SD3_SPECS = {s.name: s for s in (SD35_LARGE, TINY_SD3)}
