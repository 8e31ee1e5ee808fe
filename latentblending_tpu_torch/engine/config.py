"""EngineConfig — the single dataclass holding every engine knob.

SURVEY.md §5 (config system): the reference has no config object; its
parameter surface is constructor args + setters with pipe-dependent
defaults (reference blending_engine.py:128-132,:139-143,:193-203,:248-253,
:273-289). This dataclass is that surface in one place, with the same
names and the same turbo/base default tables; BlendingEngine keeps the
setter API for compatibility and can snapshot/apply an EngineConfig.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class EngineConfig:
    # generation geometry / schedule
    width: Optional[int] = None            # None → model default (512 turbo / 1024 base)
    height: Optional[int] = None
    num_inference_steps: Optional[int] = None  # None → 4 turbo / 30 base
    # guidance
    guidance_scale: Optional[float] = None     # None → 0.0 turbo / 4.0 base
    guidance_rescale: float = 0.0
    guidance_scale_mid_damper: float = 0.5
    mid_compression_scaler: float = 1.2
    # prompts / seeds
    negative_prompt: str = ""
    seed1: int = 0
    seed2: int = 0
    # crossfeed schedules (None → turbo 1/1/1, base 0.3/0.6/0.9 parental)
    branch1_crossfeed_power: float = 0.0
    branch1_crossfeed_range: float = 0.0
    branch1_crossfeed_decay: float = 0.0
    parental_crossfeed_power: Optional[float] = None
    parental_crossfeed_range: Optional[float] = None
    parental_crossfeed_decay: Optional[float] = None
    # branching plan (reference set_branching args; mutually exclusive)
    depth_strength: Optional[float] = None
    t_compute_max_allowed: Optional[float] = None
    nmb_max_branches: Optional[int] = None
    # TPU-build execution knobs (no reference counterpart)
    stem_batch: int = 0          # 0 = whole level per batch; 1 = reference policy
    cost_model: str = "batched"  # 'batched' | 'reference' planner calibration
    # 'measured' re-scores gaps between levels (reference behavior);
    # 'predictive' places all levels by predicted splitting — zero
    # inter-level host syncs (speed mode, documented policy deviation)
    placement_policy: str = "measured"
    # 'lpips' (reference; needs weights) | 'nlpd' (weight-free) | None → keep
    # the engine's current metric (which itself defaults to lpips-with-weights
    # else nlpd)
    similarity_metric: Optional[str] = None

    @classmethod
    def defaults(cls, is_sdxl_turbo: bool) -> "EngineConfig":
        """The reference's resolved default tables, materialized."""
        if is_sdxl_turbo:
            return cls(
                width=512, height=512, num_inference_steps=4, guidance_scale=0.0,
                parental_crossfeed_power=1.0, parental_crossfeed_range=1.0,
                parental_crossfeed_decay=1.0, nmb_max_branches=10,
            )
        return cls(
            width=1024, height=1024, num_inference_steps=30, guidance_scale=4.0,
            parental_crossfeed_power=0.3, parental_crossfeed_range=0.6,
            parental_crossfeed_decay=0.9, depth_strength=0.5, t_compute_max_allowed=20.0,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
