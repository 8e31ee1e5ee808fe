"""The denoising loop over a batch of sibling branches, in PyTorch.

Counterpart of latentblending_tpu/runtime/denoise.py's per-level path
(`denoise_scan`), written as a Python loop over the executed window
[idx_start, N) — PyTorch runs eagerly, so there is no compiled scan and no
variant cache. Each step: the crossfeed slerp toward the step's mix target
(kernel K1, ops/slerp.py), then the CFG-folded UNet (negative rows first),
then the solver update (Euler, Euler-ancestral or DPM-Solver++ 2M).

Latents keep the JAX package's layout, [B, h, w, 4]; the UNet callable
takes and returns that layout too (the holder permutes to NCHW inside).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from latentblending_tpu_torch.ops.scheduler import (
    dpmpp_2m_step,
    euler_ancestral_step,
    euler_step,
    scale_model_input,
)
from latentblending_tpu_torch.ops.slerp import slerp_rows


@dataclasses.dataclass(frozen=True)
class DenoisePlan:
    """What one denoise call executes: the step window, batch, CFG and solver."""

    num_steps: int
    idx_start: int
    batch: int
    use_cfg: bool
    guidance_rescale: float = 0.0
    # "euler" | "euler_ancestral" | "dpmpp_2m"
    sched: str = "euler"

    @property
    def exec_steps(self) -> int:
        return self.num_steps - self.idx_start


@dataclasses.dataclass
class Conditioning:
    """Batched SDXL conditioning for one denoise call (all [B, ...])."""

    prompt_embeds: torch.Tensor  # [B, 77, 2048]
    pooled_embeds: torch.Tensor  # [B, 1280]
    time_ids: torch.Tensor  # [B, 6]
    neg_prompt_embeds: Optional[torch.Tensor] = None
    neg_pooled_embeds: Optional[torch.Tensor] = None
    neg_time_ids: Optional[torch.Tensor] = None


def _rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale):
    """CFG rescale per arXiv:2305.08891 §3.4 (population std, as jnp.std)."""
    dims = tuple(range(1, noise_cfg.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def _fold_cfg(plan: DenoisePlan, cond: Conditioning):
    """Stack (neg, pos) conditioning along the batch when CFG is on."""
    if plan.use_cfg:
        pe = torch.cat([cond.neg_prompt_embeds, cond.prompt_embeds], dim=0)
        pool = torch.cat([cond.neg_pooled_embeds, cond.pooled_embeds], dim=0)
        neg_t = cond.neg_time_ids if cond.neg_time_ids is not None else cond.time_ids
        return pe, pool, torch.cat([neg_t, cond.time_ids], dim=0)
    return cond.prompt_embeds, cond.pooled_embeds, cond.time_ids


def _eps_and_step(plan, unet_apply, pe, pool, tids, guidance_scale,
                  latents, old_denoised, sigma, sigma_prev, sigma_next, t, noise, use2):
    """One UNet eval (CFG-folded) and one solver update."""
    lmi = scale_model_input(latents, sigma)
    if plan.use_cfg:
        eps2 = unet_apply(torch.cat([lmi, lmi], dim=0), t, pe, pool, tids)
        eps_u, eps_t = eps2.float().chunk(2, dim=0)
        g = guidance_scale.reshape(-1, 1, 1, 1).float()
        eps = eps_u + g * (eps_t - eps_u)
        if plan.guidance_rescale > 0.0:
            eps = _rescale_noise_cfg(eps, eps_t, plan.guidance_rescale)
    else:
        eps = unet_apply(lmi, t, pe, pool, tids)
    if plan.sched == "euler_ancestral":
        return euler_ancestral_step(latents, eps, sigma, sigma_next, noise), old_denoised
    if plan.sched == "dpmpp_2m":
        # crossfeed slerps the state BETWEEN steps, so old_denoised is the
        # pre-perturbation history on crossfed rows (as in the JAX package)
        denoised = latents.float() - sigma.float() * eps.float()
        return dpmpp_2m_step(latents, denoised, old_denoised, sigma_prev, sigma, sigma_next, use2), denoised
    return euler_step(latents, eps, sigma, sigma_next), old_denoised


def _step_tables(plan: DenoisePlan, sigmas: np.ndarray, timesteps: np.ndarray):
    """Per-executed-step σ/t values for the window (host float32 arrays)."""
    M, i0 = plan.exec_steps, plan.idx_start
    sig = np.asarray(sigmas, np.float32)
    sigma_w = sig[i0 : i0 + M]
    sigma_next_w = sig[i0 + 1 : i0 + 1 + M]
    # σ_{i-1} per executed step (the first entry is unused: use2 is False there)
    sigma_prev_w = sig[np.clip(i0 + np.arange(M) - 1, 0, None)]
    # 2nd-order update from the 2nd executed step on, never into σ=0
    use2_w = (np.arange(M) > 0) & (sigma_next_w > 0.0)
    t_w = np.asarray(timesteps, np.float32)[i0 : i0 + M]
    return sigma_w, sigma_prev_w, sigma_next_w, t_w, use2_w


def denoise_scan(
    unet_apply: Callable,
    plan: DenoisePlan,
    latents_start: torch.Tensor,  # [B, h, w, 4] — state entering step idx_start
    cond: Conditioning,
    mix_window: torch.Tensor,  # [M, B, h, w, 4] crossfeed targets per executed step
    mix_coeffs: torch.Tensor,  # [M, B] slerp fractions per executed step & stem
    sigmas: np.ndarray,  # [N+1]
    timesteps: np.ndarray,  # [N]
    guidance_scale: torch.Tensor,  # [B]
    noise: Optional[torch.Tensor] = None,  # [M, B, h, w, 4] ancestral draws
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns the latent trajectory [M, B, h, w, 4] for steps idx_start..N-1.

    For euler_ancestral the per-step draws come from `noise` when given,
    else from `generator` (one of the two is required)."""
    M = plan.exec_steps
    dev = latents_start.device
    if plan.sched == "euler_ancestral" and noise is None and generator is None:
        raise ValueError("plan.sched='euler_ancestral' needs `noise` or a `generator` (a per-call stream)")
    pe, pool, tids = _fold_cfg(plan, cond)
    tables = _step_tables(plan, sigmas, timesteps)
    sig_w, sigp_w, sign_w, t_w = (torch.as_tensor(a, device=dev) for a in tables[:4])
    use2_w = tables[4]
    mix_coeffs = mix_coeffs.to(device=dev, dtype=torch.float32)

    latents = latents_start
    old_denoised = torch.zeros(latents.shape, dtype=torch.float32, device=dev)
    traj = []
    for j in range(M):
        # crossfeed slerp — kernel K1 on the GPU
        latents = slerp_rows(latents, mix_window[j], mix_coeffs[j].contiguous())
        z = None
        if plan.sched == "euler_ancestral":
            z = noise[j] if noise is not None else torch.randn(
                latents.shape, generator=generator, device=dev, dtype=torch.float32)
        latents, old_denoised = _eps_and_step(
            plan, unet_apply, pe, pool, tids, guidance_scale, latents, old_denoised,
            sig_w[j], sigp_w[j], sign_w[j], t_w[j], z, bool(use2_w[j]),
        )
        traj.append(latents)
    return torch.stack(traj, dim=0)


def build_mix_inputs(
    num_steps: int,
    idx_start: int,
    mix_traj: Optional[torch.Tensor],  # [N, B, h, w, 4] (or None)
    coeffs,  # [N] or [N, B] (or None)
    latents_start: torch.Tensor,  # [B, h, w, 4]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack the crossfeed window: executed step j (global i = idx_start + j)
    mixes toward mix_traj[i-1]; no mixing at global step 0. Returns
    (mix_window [M,B,...], mix_coeffs [M,B])."""
    M = num_steps - idx_start
    B = latents_start.shape[0]
    if mix_traj is None or coeffs is None:
        mix_window = latents_start[None].expand((M,) + tuple(latents_start.shape))
        return mix_window, torch.zeros((M, B), dtype=torch.float32)
    coeffs = np.asarray(coeffs, np.float32)
    if coeffs.ndim == 1:
        coeffs = np.tile(coeffs[:, None], (1, B))
    idx = np.clip(np.arange(idx_start, num_steps) - 1, 0, num_steps - 1)
    mix_window = torch.stack([mix_traj[i] for i in idx], dim=0)
    cw = coeffs[idx_start:num_steps].copy()
    if idx_start == 0:
        cw[0] = 0.0  # no crossfeed at step 0
    return mix_window, torch.from_numpy(cw)
