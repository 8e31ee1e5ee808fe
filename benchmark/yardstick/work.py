"""The work one transition needs, from a configuration file's plan.

A keyframe transition is two edges denoised over all N steps and, per
level of the plan, stems that start at the level's injection step, so a
stem needs N - idx_injection steps. With classifier-free guidance a step
is two image evals of the denoiser. Every keyframe is decoded once. This
counts what the plan needs, not what an implementation runs (the fused
turbo scan runs every row over all N steps), so a change that stops
computing discarded rows shows as a gain. What an eval and a decode cost
is the architecture's: benchmark/yardstick/<architecture>.py.
"""
from __future__ import annotations


def row_steps(cfg: dict) -> int:
    """Denoiser row-steps a transition needs (before CFG doubling)."""
    run = cfg["run"]
    n = run["num_inference_steps"]
    plan = run["plan"]
    return 2 * n + sum(k * (n - idx) for idx, k in zip(plan["idx_injection"], plan["stems"]))


def keyframes(cfg: dict) -> int:
    return 2 + sum(cfg["run"]["plan"]["stems"])


def image_evals(cfg: dict) -> int:
    """Denoiser image evals a transition needs: row-steps, twice under CFG."""
    return row_steps(cfg) * (2 if cfg["run"]["guidance_scale"] > 1.0 else 1)
