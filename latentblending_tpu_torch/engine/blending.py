"""BlendingEngine — the diffusion-tree orchestrator, in PyTorch.

Counterpart of latentblending_tpu/engine/blending.py, per-level path only:
`run_transition` computes both keyframe trajectories (one batch of 2 when
they are independent), then each injection level as rounds of sibling stems
— plan placements by predicted gap splitting, one batched parental mix
(kernel K1), one batched denoise, one batched VAE decode, one batched NLPD
pass over all gaps (the measured placement policy). Keyframes come back as
uint8 [H,W,3] numpy arrays. The fused and segmented single-call transitions,
LPIPS, image keyframes, movie writing, sessions and the tree cache are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from latentblending_tpu_torch.models.perceptual import NLPDScorer
from latentblending_tpu_torch.ops.interp import interpolate_linear_pytree
from latentblending_tpu_torch.ops.schedules import (
    branch1_crossfeed_coeffs,
    get_closest_idx,
    guidance_mid_dampening,
    parental_crossfeed_coeffs,
    turbo_branching_plan,
)
from latentblending_tpu_torch.ops.slerp import slerp_rows
from latentblending_tpu_torch.profiling import PhaseTimer, TransitionReport
from latentblending_tpu_torch.runtime.denoise import Conditioning
from latentblending_tpu_torch.runtime.holder import SDXLHolder


def _sync(x: torch.Tensor) -> None:
    """Wait for the device work producing x, so a phase timer around it
    measures that work (CUDA runs asynchronously to the host)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _parental_mix(p1: torch.Tensor, p2: torch.Tensor, fract: torch.Tensor) -> torch.Tensor:
    """Per-step batched slerp of two parent trajectories: p1, p2 [N,B,h,w,4],
    fract [B] → [N,B,h,w,4]; every (step, stem) row is one slerp (K1)."""
    N, B = p1.shape[0], p1.shape[1]
    flat1 = p1.reshape((N * B,) + tuple(p1.shape[2:])).contiguous()
    flat2 = p2.reshape((N * B,) + tuple(p2.shape[2:])).contiguous()
    f = fract.to(device=p1.device, dtype=torch.float32).repeat(N)
    return slerp_rows(flat1, flat2, f).reshape(p1.shape)


class BlendingEngine:
    def __init__(
        self,
        dh: SDXLHolder,
        guidance_scale_mid_damper: float = 0.5,
        mid_compression_scaler: float = 1.2,
    ):
        if not 0.0 < guidance_scale_mid_damper <= 1.0:
            raise ValueError(f"guidance_scale_mid_damper must be in (0,1], got {guidance_scale_mid_damper}")
        if not dh.is_sdxl_turbo:
            # the time-based branching plan needs the speed benchmark, which
            # is not ported yet
            raise NotImplementedError("the port's engine supports the turbo branching plan only")
        self.dh = dh
        self.guidance_scale_mid_damper = guidance_scale_mid_damper
        self.mid_compression_scaler = mid_compression_scaler
        self.seed1 = 0
        self.seed2 = 0
        self.prompt1 = ""
        self.prompt2 = ""
        self.negative_prompt = ""

        self.tree_latents: list = [None, None]
        self.tree_fracts: list = [0.0, 1.0]
        self.tree_final_imgs: list = []
        self.tree_idx_injection: list = [0, 0]
        self.tree_similarities: list = []
        # device-resident [-1,1] keyframes, parallel to tree_final_imgs
        self._imgs_dev: list = []
        self.text_embedding1 = None
        self.text_embedding2 = None
        self.timer = PhaseTimer()
        self.last_report = TransitionReport()

        self.set_guidance_scale()
        self.set_guidance_rescale()
        self.lpips = NLPDScorer()
        self.set_prompt1("")
        self.set_prompt2("")
        self.set_branch1_crossfeed()
        self.set_parental_crossfeed()
        self.set_num_inference_steps()
        self.set_branching()

    # ------------------------------------------------------------- settings

    def set_dimensions(self, size_output: Optional[tuple[int, int]] = None):
        self.dh.set_dimensions(size_output)

    def set_guidance_scale(self, guidance_scale: Optional[float] = None):
        if guidance_scale is None:
            guidance_scale = 0.0 if self.dh.is_sdxl_turbo else 4.0
        self.guidance_scale_base = float(guidance_scale)
        self.guidance_scale = float(guidance_scale)
        self.dh.guidance_scale = float(guidance_scale)

    def set_guidance_rescale(self, guidance_rescale: float = 0.0):
        self.guidance_rescale = float(np.clip(guidance_rescale, 0.0, 1.0))
        self.dh.guidance_rescale = self.guidance_rescale

    def set_negative_prompt(self, negative_prompt: str):
        self.negative_prompt = negative_prompt
        self.dh.set_negative_prompt(negative_prompt)

    def _guidance_at(self, fract_mixing: float) -> float:
        return guidance_mid_dampening(fract_mixing, self.guidance_scale_base, self.guidance_scale_mid_damper)

    def set_branch1_crossfeed(self, crossfeed_power=0.0, crossfeed_range=0.0, crossfeed_decay=0.0):
        self.branch1_crossfeed_power = float(np.clip(crossfeed_power, 0, 1))
        self.branch1_crossfeed_range = float(np.clip(crossfeed_range, 0, 1))
        self.branch1_crossfeed_decay = float(np.clip(crossfeed_decay, 0, 1))

    def set_parental_crossfeed(self, crossfeed_power=None, crossfeed_range=None, crossfeed_decay=None):
        """Defaults: turbo 1/1/1, base 0.3/0.6/0.9; user arguments always win."""
        d_power, d_range, d_decay = (1.0, 1.0, 1.0) if self.dh.is_sdxl_turbo else (0.3, 0.6, 0.9)
        self.parental_crossfeed_power = float(np.clip(d_power if crossfeed_power is None else crossfeed_power, 0, 1))
        self.parental_crossfeed_range = float(np.clip(d_range if crossfeed_range is None else crossfeed_range, 0, 1))
        self.parental_crossfeed_decay = float(np.clip(d_decay if crossfeed_decay is None else crossfeed_decay, 0, 1))

    def set_prompt1(self, prompt: str):
        self.prompt1 = prompt.replace("_", " ")
        self.text_embedding1 = self.dh.get_text_embedding(self.prompt1)

    def set_prompt2(self, prompt: str):
        self.prompt2 = prompt.replace("_", " ")
        self.text_embedding2 = self.dh.get_text_embedding(self.prompt2)

    def set_num_inference_steps(self, num_inference_steps: Optional[int] = None):
        if num_inference_steps is None:
            num_inference_steps = 4 if self.dh.is_sdxl_turbo else 30
        changed = getattr(self, "num_inference_steps", None) != int(num_inference_steps)
        self.num_inference_steps = int(num_inference_steps)
        self.dh.set_num_inference_steps(self.num_inference_steps)
        if changed and getattr(self, "_branching_args", None) is not None:
            self.set_branching(*self._branching_args)

    def set_branching(self, depth_strength=None, t_compute_max_allowed=None, nmb_max_branches=None):
        if t_compute_max_allowed is not None:
            raise ValueError("time-based branching not supported for SDXL Turbo")
        self._branching_args = (depth_strength, t_compute_max_allowed, nmb_max_branches)
        self.list_idx_injection, self.list_nmb_stems = turbo_branching_plan(
            self.num_inference_steps, depth_strength, nmb_max_branches
        )

    def get_noise(self, seed: int) -> torch.Tensor:
        return self.dh.get_noise(seed)

    # -------------------------------------------------------------- main run

    def run_transition(self, recycle_img1: Optional[bool] = False, recycle_img2: Optional[bool] = False,
                       fixed_seeds: Optional[List[int]] = None) -> list:
        """Compute the keyframe transition; returns the uint8 [H,W,3] keyframes."""
        if self.text_embedding1 is None or self.text_embedding2 is None:
            raise RuntimeError("set both prompts (set_prompt1/2) before run_transition")
        if fixed_seeds is not None:
            if fixed_seeds == "randomize":
                fixed_seeds = list(np.random.randint(0, 1000000, 2).astype(np.int32))
            elif len(fixed_seeds) != 2:
                raise ValueError("fixed_seeds needs 2 entries")
            self.seed1, self.seed2 = int(fixed_seeds[0]), int(fixed_seeds[1])
        self._run_transition_core(recycle_img1, recycle_img2)
        self.tree_final_imgs = [np.asarray(im.cpu()) for im in self.tree_final_imgs]
        self.last_report.num_keyframes = len(self.tree_final_imgs)
        self.last_report.lpips_gaps = [float(s) for s in self.tree_similarities]
        self.last_report.phases = self.timer.summary()
        self.last_report.wall_s = time.time() - self._t_run0
        return self.tree_final_imgs

    @torch.no_grad()
    def _run_transition_core(self, recycle_img1: Optional[bool] = False, recycle_img2: Optional[bool] = False):
        N = self.num_inference_steps
        self._t_run0 = time.time()
        self.timer = PhaseTimer()
        self.last_report = TransitionReport(num_steps=N)
        self.dh.reset_noise_stream((int(self.seed1) * 1_000_003 + int(self.seed2)) & 0x7FFFFFFF)

        ok1 = bool(recycle_img1) and self.tree_latents[0] is not None and len(self.tree_latents[0]) == N
        ok2 = bool(recycle_img2) and self.tree_latents[-1] is not None and len(self.tree_latents[-1]) == N
        if ok1 and ok2:
            list_latents1, list_latents2 = self.tree_latents[0], self.tree_latents[-1]
        elif not ok1 and not ok2 and self.branch1_crossfeed_power == 0.0:
            with self.timer.phase("denoise"):
                list_latents1, list_latents2 = self._compute_edge_latents_batched()
                _sync(list_latents2[-1])
        else:
            with self.timer.phase("denoise"):
                list_latents1 = self.tree_latents[0] if ok1 else self.compute_latents1()
                list_latents2 = self.tree_latents[-1] if ok2 else self.compute_latents2()
                _sync(list_latents2[-1])

        self.tree_latents = [list_latents1, list_latents2]
        self.tree_fracts = [0.0, 1.0]
        with self.timer.phase("vae_decode"):
            edge_pm1 = self.dh.decode_to_pm1_batched(torch.cat([list_latents1[-1], list_latents2[-1]], dim=0))
            edge_u8 = self.dh.to_uint8_device(edge_pm1)
            _sync(edge_u8)
        self.tree_final_imgs = [edge_u8[0], edge_u8[1]]
        self._imgs_dev = [edge_pm1[0], edge_pm1[1]]
        self.tree_idx_injection = [0, 0]
        self.tree_similarities = self._batched_similarities()

        # each level's stems run as one batched round
        for nmb_stems, idx_injection in zip(self.list_nmb_stems, self.list_idx_injection):
            t_lvl = time.time()
            self._run_stem_round(int(nmb_stems), idx_injection)
            self.last_report.levels.append(
                {"idx_injection": int(idx_injection), "stems": int(nmb_stems), "wall_s": round(time.time() - t_lvl, 3)}
            )

    def compute_latents1(self) -> list:
        """First keyframe trajectory (single branch)."""
        cond = self.get_mixed_conditioning(0.0)
        self.dh.guidance_scale = self.guidance_scale
        out = self.dh.run_diffusion(cond, self.get_noise(self.seed1), idx_start=0)
        self.tree_latents[0] = out
        return out

    def compute_latents2(self) -> list:
        """Second keyframe trajectory, crossfed from the first when
        branch1 crossfeed is on."""
        cond = self.get_mixed_conditioning(1.0)
        self.dh.guidance_scale = self.guidance_scale
        latents_start = self.get_noise(self.seed2)
        if self.branch1_crossfeed_power > 0.0:
            coeffs = branch1_crossfeed_coeffs(
                self.num_inference_steps, self.branch1_crossfeed_power,
                self.branch1_crossfeed_range, self.branch1_crossfeed_decay,
            )
            out = self.dh.run_diffusion(cond, latents_start, idx_start=0,
                                        list_latents_mixing=self.tree_latents[0], mixing_coeffs=list(coeffs))
        else:
            out = self.dh.run_diffusion(cond, latents_start)
        self.tree_latents[-1] = out
        return out

    def _compute_edge_latents_batched(self):
        """Both keyframe trajectories as one batch of 2."""
        lat0 = torch.cat([self.get_noise(self.seed1), self.get_noise(self.seed2)], dim=0)
        cond = self._stack_conditionings([0.0, 1.0])
        g = torch.tensor([self._guidance_at(0.0), self._guidance_at(1.0)], dtype=torch.float32)
        traj = self.dh.run_diffusion_batched(cond, lat0, idx_start=0, guidance_scale=g)
        N = self.num_inference_steps
        return [traj[i, 0:1] for i in range(N)], [traj[i, 1:2] for i in range(N)]

    # ------------------------------------------------------ stem-round logic

    def _plan_placements(self, k: int, idx_injection: int):
        """Choose k insertion fracts by predicted gap splitting (a split gap
        is assumed to halve its distance); with k=1 this is the reference's
        argmax over measured similarities."""
        sims = [float(s) for s in self.tree_similarities]
        fracts = list(self.tree_fracts)
        placements = []
        for _ in range(k):
            g = int(np.argmax(sims))
            fract_mixing = (fracts[g] + fracts[g + 1]) / 2.0
            b_parent1, b_parent2 = self._find_parents(fract_mixing, idx_injection)
            placements.append((fract_mixing, b_parent1, b_parent2))
            sims[g : g + 1] = [sims[g] * 0.5, sims[g] * 0.5]
            fracts.insert(g + 1, fract_mixing)
        return placements, sims

    def _find_parents(self, fract_mixing: float, idx_injection: int) -> tuple[int, int]:
        """Nearest tree entries strictly shallower than the new branch."""
        if idx_injection < 1:
            raise ValueError("idx_injection must be >= 1 (depth 0 has no parental state)")
        b_parent1, b_parent2 = get_closest_idx(fract_mixing, self.tree_fracts)
        while self.tree_idx_injection[b_parent1] >= idx_injection:
            b_parent1 -= 1
        while self.tree_idx_injection[b_parent2] >= idx_injection:
            b_parent2 += 1
        return b_parent1, b_parent2

    def _branch_traj_array(self, b: int) -> torch.Tensor:
        """Tree branch b as a stacked [N, h, w, 4] tensor (None steps → zeros)."""
        entries = self.tree_latents[b]
        zero = torch.zeros_like(entries[-1][0])
        return torch.stack([zero if e is None else e[0] for e in entries[: self.num_inference_steps]], dim=0)

    def _run_stem_round(self, k: int, idx_injection: int):
        """Plan, compute and insert k sibling stems as one batched denoise +
        decode + similarity round."""
        N = self.num_inference_steps
        placements, _ = self._plan_placements(k, idx_injection)
        p1 = torch.stack([self._branch_traj_array(b1) for _, b1, _ in placements], dim=1)
        p2 = torch.stack([self._branch_traj_array(b2) for _, _, b2 in placements], dim=1)
        fract_parental = torch.tensor(
            [(f - self.tree_fracts[b1]) / (self.tree_fracts[b2] - self.tree_fracts[b1]) for f, b1, b2 in placements],
            dtype=torch.float32,
        )
        mix_traj = _parental_mix(p1, p2, fract_parental)  # [N, k, h, w, 4]
        coeffs = parental_crossfeed_coeffs(
            N, idx_injection, self.parental_crossfeed_power, self.parental_crossfeed_range,
            self.parental_crossfeed_decay,
        )
        cond = self._stack_conditionings([f for f, _, _ in placements])
        guidance = torch.tensor([self._guidance_at(f) for f, _, _ in placements], dtype=torch.float32)
        with self.timer.phase("denoise"):
            traj = self.dh.run_diffusion_batched(
                cond, mix_traj[idx_injection - 1], idx_start=idx_injection, mix_traj=mix_traj,
                mixing_coeffs=coeffs, guidance_scale=guidance,
            )  # [N - idx_injection, k, h, w, 4]
            _sync(traj)
        with self.timer.phase("vae_decode"):
            imgs_pm1 = self.dh.decode_to_pm1_batched(traj[-1])
            u8 = self.dh.to_uint8_device(imgs_pm1)
            _sync(u8)
        M = N - idx_injection
        with self.timer.phase("similarity"):
            for i in sorted(range(k), key=lambda i: placements[i][0]):
                fract_mixing = placements[i][0]
                b_parent1, _ = get_closest_idx(fract_mixing, self.tree_fracts)
                idx_insert = b_parent1 + 1
                self.tree_latents.insert(idx_insert, [None] * idx_injection + [traj[j, i : i + 1] for j in range(M)])
                self.tree_final_imgs.insert(idx_insert, u8[i])
                self._imgs_dev.insert(idx_insert, imgs_pm1[i])
                self.tree_fracts.insert(idx_insert, fract_mixing)
                self.tree_idx_injection.insert(idx_insert, idx_injection)
            self.tree_similarities = self._batched_similarities()

    # ----------------------------------------------------- conditioning mix

    def get_mixed_conditioning(self, fract_mixing: float):
        """4-tuple conditioning lerp."""
        return interpolate_linear_pytree(self.text_embedding1, self.text_embedding2, fract_mixing)

    def _stack_conditionings(self, fracts: list[float]) -> Conditioning:
        """Batched conditioning lerp for a whole stem round."""
        dev = self.dh.device
        f = torch.tensor(fracts, dtype=torch.float32, device=dev)[:, None, None]

        def mix(a, b, fr):
            return ((1.0 - fr) * a.float() + fr * b.float()).to(a.dtype)

        e1, e2 = self.text_embedding1, self.text_embedding2
        tids = self.dh.default_time_ids(len(fracts))
        return Conditioning(
            prompt_embeds=mix(e1[0], e2[0], f), pooled_embeds=mix(e1[2], e2[2], f[:, :, 0]), time_ids=tids,
            neg_prompt_embeds=mix(e1[1], e2[1], f), neg_pooled_embeds=mix(e1[3], e2[3], f[:, :, 0]),
            neg_time_ids=tids,
        )

    # ---------------------------------------------------------------- state

    def get_state_dict(self) -> dict:
        state_dict = {}
        for v in ("prompt1", "prompt2", "seed1", "seed2", "num_inference_steps", "guidance_scale",
                  "guidance_scale_mid_damper", "mid_compression_scaler", "negative_prompt",
                  "branch1_crossfeed_power", "branch1_crossfeed_range", "branch1_crossfeed_decay",
                  "parental_crossfeed_power", "parental_crossfeed_range", "parental_crossfeed_decay"):
            val = getattr(self, v)
            if v in ("seed1", "seed2"):
                val = int(val)
            elif isinstance(val, (np.floating, np.integer)):
                val = float(val)
            state_dict[v] = val
        state_dict["width"] = self.dh.width_img
        state_dict["height"] = self.dh.height_img
        return state_dict

    def swap_forward(self):
        """keyframe2 → keyframe1 for chained transitions."""
        self.tree_latents[0] = self.tree_latents[-1]
        self.prompt1 = self.prompt2
        self.text_embedding1 = self.text_embedding2
        self.tree_final_imgs = []
        self._imgs_dev = []

    # ------------------------------------------------------------- similarity

    def _batched_similarities(self) -> list[float]:
        """All adjacent-keyframe NLPD distances in one batched call."""
        if len(self._imgs_dev) < 2:
            return []
        d = self.lpips.distance_batch(torch.stack(self._imgs_dev[:-1]), torch.stack(self._imgs_dev[1:]))
        return d.double().cpu().tolist()
