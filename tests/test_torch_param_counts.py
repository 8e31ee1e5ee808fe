"""Parameter-count anchors of the port's SD3.5-Large modules at the
published widths (stabilityai/stable-diffusion-3.5-large), built on the
meta device (no memory): the MMDiT at the published transformer config
(38 joint blocks of 2432, the last context_pre_only), "8.1B" on the model
card; T5 v1.1 XXL's encoder as SD3 loads it (T5EncoderModel: the token
table, 24 blocks, block 0's bias table), 4,762,310,656, the count
transformers reports for text_encoder_3."""
from __future__ import annotations

import torch

from latentblending_tpu_torch.models.mmdit import MMDiT
from latentblending_tpu_torch.models.sd3_configs import SD35_LARGE
from latentblending_tpu_torch.models.t5 import T5Encoder


def _count(module) -> int:
    return sum(p.numel() for p in module.parameters())


def test_sd35_large_mmdit_param_count():
    with torch.device("meta"):
        assert _count(MMDiT(SD35_LARGE.mmdit)) == 8_056_627_520


def test_sd35_t5_xxl_encoder_param_count():
    with torch.device("meta"):
        assert _count(T5Encoder(SD35_LARGE.t5)) == 4_762_310_656
