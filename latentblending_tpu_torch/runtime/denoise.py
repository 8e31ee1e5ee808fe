"""The denoising loops over a batch of sibling branches, in PyTorch.

Counterpart of latentblending_tpu/runtime/denoise.py, written as Python
loops — PyTorch runs eagerly, so there is no compiled scan and no variant
cache:

- `denoise_scan` (the per-level path): a loop over the executed window
  [idx_start, N). Each step: the crossfeed slerp toward the step's mix
  target (kernel K1, ops/slerp.py), then the CFG-folded UNet (negative
  rows first), then the solver update (Euler, Euler-ancestral or
  DPM-Solver++ 2M).
- `denoise_scan_tree` (the fused single-level transition): one loop over
  all N steps for the edges and every stem of a level, whose crossfeed
  targets are live parental slerps of other rows of the same batch (one
  launch of K1's tree step per step: the parental mix and the crossfeed).
- `denoise_scan_tree_seg` (the fused multi-level transition): the same
  step over segments of steps whose batch grows at each boundary, rows
  ordered by injection step, so the live rows are a prefix of the batch
  and only useful (row, step) work runs.

Latents keep the JAX package's layout, [B, h, w, 4]; the UNet callable
takes and returns that layout too (the holder permutes to NCHW inside).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from latentblending_tpu_torch import profiling
from latentblending_tpu_torch.ops.scheduler import (
    dpmpp_2m_step,
    euler_ancestral_step,
    euler_step,
    scale_model_input,
)
from latentblending_tpu_torch.ops.slerp import host_checked_index, slerp_rows, slerp_tree_step


@dataclasses.dataclass(frozen=True)
class DenoisePlan:
    """What one denoise call executes: the step window, batch, CFG and solver."""

    num_steps: int
    idx_start: int
    batch: int
    use_cfg: bool
    guidance_rescale: float = 0.0
    # "euler" | "euler_ancestral" | "dpmpp_2m" | "flow_euler" (SD3's flow
    # matching: the model takes the state unscaled and predicts the velocity)
    sched: str = "euler"
    # ((start_step, batch), ...) of the segmented tree scan, else ()
    segs: tuple = ()

    @property
    def exec_steps(self) -> int:
        return self.num_steps - self.idx_start


@dataclasses.dataclass
class Conditioning:
    """Batched conditioning for one denoise call (all [B, ...]); SD3 has no
    time ids (None)."""

    prompt_embeds: torch.Tensor  # [B, 77, 2048] (SD3: [B, 333, 4096])
    pooled_embeds: torch.Tensor  # [B, 1280] (SD3: [B, 2048])
    time_ids: Optional[torch.Tensor]  # [B, 6] SDXL's micro-conditioning, or None
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
        if cond.time_ids is None:
            return pe, pool, None
        neg_t = cond.neg_time_ids if cond.neg_time_ids is not None else cond.time_ids
        return pe, pool, torch.cat([neg_t, cond.time_ids], dim=0)
    return cond.prompt_embeds, cond.pooled_embeds, cond.time_ids


def _eps_and_step(plan, unet_apply, pe, pool, tids, guidance_scale,
                  latents, old_denoised, sigma, sigma_prev, sigma_next, t, noise, use2):
    """One denoiser eval (CFG-folded; the tracer's `unet` span, whatever the
    denoiser's family: SDXL's UNet or SD3's MMDiT) and one solver update.
    Flow matching feeds the state unscaled and steps on the velocity with
    Euler's update."""
    lmi = latents if plan.sched == "flow_euler" else scale_model_input(latents, sigma)
    if plan.use_cfg:
        with profiling.span("unet"):
            eps2 = unet_apply(torch.cat([lmi, lmi], dim=0), t, pe, pool, tids)
        eps_u, eps_t = eps2.float().chunk(2, dim=0)
        g = guidance_scale.reshape(-1, 1, 1, 1).float()
        eps = eps_u + g * (eps_t - eps_u)
        if plan.guidance_rescale > 0.0:
            eps = _rescale_noise_cfg(eps, eps_t, plan.guidance_rescale)
    else:
        with profiling.span("unet"):
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
        with profiling.span("step", device=dev, step=plan.idx_start + j, rows=latents.shape[0]):
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


def denoise_scan_tree(
    unet_apply: Callable,
    plan: DenoisePlan,
    latents_start: torch.Tensor,  # [B, h, w, 4] — edges then stems
    cond: Conditioning,
    parent_idx: torch.Tensor,  # [B, 2] int64 — in-batch parent rows (self for edges)
    parent_fract: torch.Tensor,  # [B] f32 — parental mix fraction per row
    mix_coeffs: torch.Tensor,  # [M, B] crossfeed slerp fraction per step & row
    sigmas: np.ndarray,  # [N+1]
    timesteps: np.ndarray,  # [N]
    guidance_scale: torch.Tensor,  # [B]
    noise: Optional[torch.Tensor] = None,  # [M, B, h, w, 4] ancestral draws (euler_ancestral)
    win_steps: Optional[torch.Tensor] = None,  # [M, h, w, 4] recycled-edge entering-states
    win_mask: Optional[torch.Tensor] = None,  # [B] bool — rows whose parent-1 is the window
    pin_steps=None,  # [B] int — step each row is pinned at (0 = edge)
) -> torch.Tensor:
    """The fused single-level tree loop: one call computes the edge
    trajectories and every stem of the level; returns [M, B, h, w, 4].

    Each row's crossfeed target is the parental slerp of the CURRENT states
    of two rows of the batch (a parent's state entering step i is its
    trajectory entry i-1). A stem injected at step i0 carries junk before
    i0 (it evolves from a finite placeholder) and is pinned at i0 by mix
    coefficient 1.0: the slerp returns the parental mix exactly.

    win_steps/win_mask: rows with win_mask take their parent-1 state from
    the per-step window (a recycled edge 1) instead of a live row; this
    also carries branch1 crossfeed for edge 2 (parent_fract 0).

    pin_steps gates the dpmpp_2m 2nd-order term per row: it engages only
    after the row's pin step, so pre-pin junk never enters the history.
    """
    M = plan.exec_steps
    dev = latents_start.device
    if plan.sched == "euler_ancestral" and noise is None:
        raise ValueError("plan.sched='euler_ancestral' needs `noise` (the call's per-step draws)")
    pe, pool, tids = _fold_cfg(plan, cond)
    tables = _step_tables(plan, sigmas, timesteps)
    sig_w, sigp_w, sign_w, t_w = (torch.as_tensor(a, device=dev) for a in tables[:4])
    B = latents_start.shape[0]
    pins = np.zeros((B,), np.int64) if pin_steps is None else np.asarray(pin_steps, np.int64)
    # per-row validity of the solver history: only after the row's pin step
    use2_mat = torch.as_tensor(tables[4][:, None] & (np.arange(M)[:, None] > pins[None, :]), device=dev)
    mix_coeffs = mix_coeffs.to(device=dev, dtype=torch.float32)
    parent_fract = parent_fract.to(device=dev, dtype=torch.float32).contiguous()
    p1 = parent_idx[:, 0].to(device=dev, dtype=torch.long).contiguous()
    p2 = parent_idx[:, 1].to(device=dev, dtype=torch.long).contiguous()
    wmask = None
    if win_steps is not None:
        win_steps = win_steps.to(device=dev, dtype=latents_start.dtype).contiguous()
        wmask = torch.as_tensor(win_mask, dtype=torch.bool, device=dev)

    latents = latents_start
    old_denoised = torch.zeros(latents.shape, dtype=torch.float32, device=dev)
    traj = []
    for j in range(M):
        with profiling.span("step", device=dev, step=plan.idx_start + j, rows=B):
            # live parental mix, then the crossfeed slerp toward it — one
            # launch of kernel K1's tree step on the GPU
            latents = slerp_tree_step(latents, p1, p2, parent_fract, mix_coeffs[j].contiguous(),
                                      None if win_steps is None else win_steps[j], wmask)
            latents, old_denoised = _eps_and_step(
                plan, unet_apply, pe, pool, tids, guidance_scale, latents, old_denoised,
                sig_w[j], sigp_w[j], sign_w[j], t_w[j], None if noise is None else noise[j],
                use2_mat[j].reshape(-1, 1, 1, 1),
            )
        traj.append(latents)
    return torch.stack(traj, dim=0)


def _cond_prefix(cond: Conditioning, rows: int) -> Conditioning:
    """The conditioning of the first `rows` batch rows."""
    fields = (getattr(cond, f.name) for f in dataclasses.fields(cond))
    return Conditioning(*(None if x is None else x[:rows] for x in fields))


def denoise_scan_tree_seg(
    unet_apply: Callable,
    plan: DenoisePlan,  # plan.segs = ((start_step, batch), ...)
    latents_start: torch.Tensor,  # [B0, h, w, 4] — the rows live from step 0 (edges)
    cond: Conditioning,  # [B_total, ...]
    parent_idx: np.ndarray,  # [B_total, 2] int, on the host — in-batch parent rows
    parent_fract: torch.Tensor,  # [B_total] f32 — parental mix fraction per row
    mix_coeffs: torch.Tensor,  # [N, B_total] crossfeed fraction per step & row
    sigmas: np.ndarray,  # [N+1]
    timesteps: np.ndarray,  # [N]
    guidance_scale: torch.Tensor,  # [B_total]
    noise=None,  # N ancestral draws, step i of shape [B_s, h, w, 4] (euler_ancestral)
    win_steps: Optional[torch.Tensor] = None,  # [N, h, w, 4] recycled-edge entering-states
    win_mask=None,  # [B_total] bool — rows whose parent-1 is the window
    pin_steps=None,  # [B_total] int — step each row is pinned at (0 = edge)
) -> tuple:
    """The segmented multi-level tree loop: a whole multi-level branching
    plan in one call. Segment s runs steps [i0_s, i0_{s+1}) over the live
    rows [0, B_s); rows are ordered by injection step, so the batch only
    grows. Each step is one K1 tree step (live parental mix and crossfeed)
    and one UNet eval over the live rows.

    A row entering at segment s starts from its parent-1 state (any finite
    value would do) and is pinned by its crossfeed coefficient 1.0 at its
    first step: the slerp replaces its state with the live parental mix,
    which equals the per-level path's latents_start = mix_traj[i0-1].
    Parents are always in earlier segments, so their rows are live.

    Returns a tuple of per-segment trajectories [len_s, B_s, h, w, 4]; the
    state of row r after global step i of segment s is trajs[s][i - i0_s, r].
    """
    segs = plan.segs
    if not segs or plan.idx_start != 0:
        raise ValueError("denoise_scan_tree_seg needs plan.segs and idx_start 0")
    N = plan.num_steps
    dev = latents_start.device
    if plan.sched == "euler_ancestral" and noise is None:
        raise ValueError("plan.sched='euler_ancestral' needs `noise` (the call's per-step draws)")
    pidx = np.asarray(parent_idx, np.int64)
    B_total = pidx.shape[0]
    tables = _step_tables(plan, sigmas, timesteps)
    sig_w, sigp_w, sign_w, t_w = (torch.as_tensor(a, device=dev) for a in tables[:4])
    pins = np.zeros((B_total,), np.int64) if pin_steps is None else np.asarray(pin_steps, np.int64)
    # per-(step, row) validity of the dpmpp_2m history: after the row's pin
    use2_mat = torch.as_tensor(tables[4][:, None] & (np.arange(N)[:, None] > pins[None, :]), device=dev)
    mix_coeffs = mix_coeffs.to(device=dev, dtype=torch.float32)
    parent_fract = parent_fract.to(device=dev, dtype=torch.float32)
    guidance_scale = guidance_scale.to(device=dev, dtype=torch.float32)
    wmask = None
    if win_steps is not None:
        win_steps = win_steps.to(device=dev, dtype=latents_start.dtype).contiguous()
        wmask = torch.as_tensor(np.asarray(win_mask, bool), device=dev)

    # every segment's index tensors, copied to the device before the loop
    # (a blocking host→device copy synchronizes the stream); the parent
    # indices are range checked on the host, so the K1 wrapper reads nothing
    # back. Entering rows start from parent 1's current state, a finite
    # placeholder: the coefficient-1.0 slerp at their first step is the pin.
    starts = [latents_start.shape[0]] + [Bs for _, Bs in segs[:-1]]
    if any(Bs < Bprev for (_, Bs), Bprev in zip(segs, starts)):
        raise ValueError(f"segment batches must not shrink: {segs}")
    enter_idx = [torch.from_numpy(np.clip(pidx[Bprev:Bs, 0], 0, Bprev - 1)).to(dev)
                 for (_, Bs), Bprev in zip(segs, starts)]
    parents = [(host_checked_index(pidx[:Bs, 0], Bs, dev), host_checked_index(pidx[:Bs, 1], Bs, dev))
               for _, Bs in segs]

    latents = latents_start
    old_denoised = torch.zeros(latents.shape, dtype=torch.float32, device=dev)
    trajs = []
    for s, (i0, Bs) in enumerate(segs):
        i1 = segs[s + 1][0] if s + 1 < len(segs) else N
        if Bs > latents.shape[0]:
            enter = latents[enter_idx[s]]
            latents = torch.cat([latents, enter], dim=0)
            old_denoised = torch.cat([old_denoised, old_denoised.new_zeros(enter.shape)], dim=0)
        # the segment's operands, sliced once
        p1, p2 = parents[s]
        pf, g = parent_fract[:Bs].contiguous(), guidance_scale[:Bs]
        wm = None if wmask is None else wmask[:Bs].contiguous()
        mc = mix_coeffs[i0:i1, :Bs].contiguous()
        use2 = use2_mat[i0:i1, :Bs].reshape(i1 - i0, Bs, 1, 1, 1)
        pe, pool, tids = _fold_cfg(plan, _cond_prefix(cond, Bs))
        ys = []
        for j, i in enumerate(range(i0, i1)):
            with profiling.span("step", device=dev, step=i, rows=Bs):
                latents = slerp_tree_step(latents, p1, p2, pf, mc[j], None if win_steps is None else win_steps[i],
                                          wm)
                latents, old_denoised = _eps_and_step(
                    plan, unet_apply, pe, pool, tids, g, latents, old_denoised,
                    sig_w[i], sigp_w[i], sign_w[i], t_w[i], None if noise is None else noise[i], use2[j],
                )
            ys.append(latents)
        trajs.append(torch.stack(ys, dim=0) if ys else latents.new_empty((0,) + tuple(latents.shape)))
    return tuple(trajs)


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
