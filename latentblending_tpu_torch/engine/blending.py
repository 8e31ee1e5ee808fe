"""BlendingEngine — the diffusion-tree orchestrator, in PyTorch.

Counterpart of latentblending_tpu/engine/blending.py, for SDXL-Turbo (the
one-level turbo plan) and SDXL-base (the time-based multi-level plan,
whose step and decode costs `benchmark_speed` measures at construction).
`run_transition` takes one of three execution shapes, chosen by the JAX
package's gate (`LB_FUSED`: unset/"auto", "0" or "1", plus the cost
model `predict_transition_time`):

- the fused single-level transition (`_run_transition_fused`, the default
  for a one-level plan): ONE denoise_scan_tree call computes both edges and
  every stem (one launch of kernel K1's tree step per denoise step: the
  live parental mix and the crossfeed), then
  decode → convert → host copy in chunks, in fract order;
- the segmented multi-level transition (`_run_transition_fused_multi`,
  the default for a multi-level plan under the predictive placement
  policy): ONE denoise_scan_tree_seg call whose batch grows as each level's
  stems enter at their injection step, then the same output pipeline;
- the per-level path (LB_FUSED=0, a recycled edge 2, stem_batch > 0, or a
  multi-level plan under the measured policy): both keyframe trajectories
  (one batch of 2 when they are independent), then each injection level
  as rounds of sibling stems — placements by predicted gap splitting, one
  batched parental mix (K1), one batched denoise, one batched VAE decode
  and, under the measured placement policy, one batched similarity pass over all
  gaps between rounds (the predictive policy adopts the predicted gap
  values instead and synchronizes once, after the last round).

Keyframes leave the device as uint8 RGB or packed I420 through pinned
host copies that are still in flight when the transition returns its
handles (`run_transition_streaming`, `resolve_image`); the last round's
gap similarities are deferred to `finalize_report`. `run_transition`
resolves both and returns uint8 [H,W,3] numpy keyframes.
`extend_transition` deepens a finished tree. An image can pin either
keyframe (`set_keyframe1_image` / `set_keyframe2_image`, then
`run_transition(recycle_img1/2=True)`): the VAE encodes it and a
forward-noised trajectory stands in for that edge's denoise.
`run_movie_transition` runs the transition and writes its movie while
later keyframes still stream to the host; `write_movie_transition` writes
the movie of a finished tree. Both encode on the holder's device
(video/writer.py); write_imgs_transition writes the keyframes as JPEGs
(video/jpeg.py) beside their settings (lowres.yaml).

The gap metric is NLPD (models/perceptual.py) or LPIPS (models/lpips.py),
chosen as the JAX package chooses it. The reference's single-branch loop
is here too: compute_latents1/2, get_mixing_parameters,
compute_latents_mix, insert_into_tree, get_tree_similarities,
run_diffusion and compute_preview_images (one batched denoise and decode
for N preview seeds).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from latentblending_tpu_torch.engine.config import EngineConfig
from latentblending_tpu_torch.models.lpips import LPIPSScorer
from latentblending_tpu_torch.models.perceptual import NLPDScorer
from latentblending_tpu_torch.ops.interp import interpolate_linear_pytree
from latentblending_tpu_torch.ops.schedules import (
    branch1_crossfeed_coeffs,
    get_closest_idx,
    guidance_mid_dampening,
    parental_crossfeed_coeffs,
    time_based_branching_plan,
    turbo_branching_plan,
)
from latentblending_tpu_torch.ops.slerp import slerp_rows
from latentblending_tpu_torch.profiling import PhaseTimer, TransitionReport
from latentblending_tpu_torch.runtime.denoise import Conditioning
from latentblending_tpu_torch.runtime.holder import SDXLHolder
from latentblending_tpu_torch.utils import get_logger
from latentblending_tpu_torch.video.i420 import to_rgb

log = get_logger(__name__)


def _sync(x: torch.Tensor) -> None:
    """Wait for the device work producing x, so a phase timer around it
    measures that work (CUDA runs asynchronously to the host)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


class _HostCopy:
    """A device→host copy in flight: a non_blocking copy into a pinned host
    tensor, and the CUDA event recorded after it. Reading it (np.asarray)
    waits on the event first, so the host never reads a buffer that is
    still being written."""

    __slots__ = ("host", "event")

    def __init__(self, dev: torch.Tensor):
        self.host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        with torch.cuda.device(dev.device):
            self.host.copy_(dev, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def __array__(self, dtype=None, copy=None):
        self.event.synchronize()
        arr = self.host.numpy()
        return arr if dtype is None else arr.astype(dtype)


def _fetch(x: torch.Tensor):
    """Start the host copy of x: a _HostCopy for a CUDA tensor, while a CPU
    tensor is its own host copy."""
    return _HostCopy(x) if x.is_cuda else x


def _fetch_chunk() -> int:
    """Keyframes per decode → convert → host-copy chunk (LB_FETCH_CHUNK)."""
    return max(1, int(os.environ.get("LB_FETCH_CHUNK", "4")))


class _PendingImage:
    """Placeholder in tree_final_imgs for a keyframe whose uint8 copy is
    still streaming device→host (resolved at the end of run_transition)."""

    __slots__ = ("batch", "row")

    def __init__(self, batch, row: int):
        self.batch = batch
        self.row = row


def resolve_image(im, batch_cache: dict) -> np.ndarray:
    """Materialize a keyframe handle: one host read per shared batch
    (cached in batch_cache), pass-through for plain arrays.

    Returns the keyframe in its fetch format — uint8 RGB [H,W,3], or a
    packed I420 plane buffer [H*3/2, W] when the engine shipped keyframes as
    4:2:0 YCbCr (run_transition_streaming(keyframe_format="i420"))."""
    if not isinstance(im, _PendingImage):
        return np.asarray(im)
    arr = batch_cache.get(id(im.batch))
    if arr is None:
        arr = np.asarray(im.batch)
        batch_cache[id(im.batch)] = arr
    return arr[im.row]


def _parental_mix(p1: torch.Tensor, p2: torch.Tensor, fract: torch.Tensor) -> torch.Tensor:
    """Per-step batched slerp of two parent trajectories: p1, p2 [N,B,h,w,4],
    fract [B] → [N,B,h,w,4]; every (step, stem) row is one slerp (K1)."""
    N, B = p1.shape[0], p1.shape[1]
    flat1 = p1.reshape((N * B,) + tuple(p1.shape[2:])).contiguous()
    flat2 = p2.reshape((N * B,) + tuple(p2.shape[2:])).contiguous()
    f = fract.to(device=p1.device, dtype=torch.float32).repeat(N)
    return slerp_rows(flat1, flat2, f).reshape(p1.shape)


_COST_MODELS = ("batched", "reference")
_PLACEMENT_POLICIES = ("measured", "predictive")
_METRICS = ("lpips", "nlpd")


class BlendingEngine:
    def __init__(
        self,
        dh: SDXLHolder,
        do_compile: bool = False,
        guidance_scale_mid_damper: float = 0.5,
        mid_compression_scaler: float = 1.2,
        stem_batch: int = 0,
        lpips_params=None,
        run_benchmark: Optional[bool] = None,
        cost_model: str = "batched",
        config: Optional[EngineConfig] = None,
        similarity_metric: Optional[str] = None,
    ):
        """The JAX engine's arguments, in its order. do_compile: accepted
        and ignored, as there. stem_batch: stems of a level per batched
        round (0: the whole level; 1: the reference's one stem at a time).
        lpips_params: LPIPS weights, a state dict under the `lpips`
        package's names (models/lpips.py). run_benchmark (default: on base
        engines, whose time-based plan reads the step costs): measure them
        now. cost_model: 'batched' times the B=2 edge denoise and decode the
        run itself uses; 'reference' the reference's single-branch step.
        config: an EngineConfig applied last. similarity_metric: 'lpips' or
        'nlpd'; None takes 'lpips' when weights are given, else 'nlpd' (a
        weight-free metric beats the random LPIPS stand-in); 'lpips' with no
        weights warns and uses the stand-in."""
        if not 0.0 < guidance_scale_mid_damper <= 1.0:
            raise ValueError(f"guidance_scale_mid_damper must be in (0,1], got {guidance_scale_mid_damper}")
        if cost_model not in _COST_MODELS:
            raise ValueError(f"cost_model must be one of {_COST_MODELS}, got {cost_model!r}")
        if similarity_metric is None:
            similarity_metric = "lpips" if lpips_params is not None else "nlpd"
        if similarity_metric not in _METRICS:
            raise ValueError(f"similarity_metric must be one of {_METRICS}, got {similarity_metric!r}")
        self.dh = dh
        self.guidance_scale_mid_damper = guidance_scale_mid_damper
        self.mid_compression_scaler = mid_compression_scaler
        self.stem_batch = int(stem_batch)
        self.cost_model = cost_model
        # 'measured' re-scores every gap between levels (the reference);
        # 'predictive' places all levels by predicted gap splitting, with no
        # device read between levels (and, for a multi-level plan, the
        # segmented fused transition)
        self.placement_policy = "measured"
        self.similarity_metric = similarity_metric
        # kept so that apply_config can switch back to 'lpips' with them
        self._lpips_params = lpips_params
        self.seed1 = 0
        self.seed2 = 0
        self.prompt1 = ""
        self.prompt2 = ""
        self.negative_prompt = ""
        self.image1_lowres = None
        self.image2_lowres = None

        self.tree_latents: list = [None, None]
        self.tree_fracts: list = [0.0, 1.0]
        self.tree_final_imgs: list = []
        self.tree_idx_injection: list = [0, 0]
        self.tree_similarities: list = []
        # device-resident [-1,1] keyframes, parallel to tree_final_imgs
        self._imgs_dev: list = []
        self.text_embedding1 = None
        self.text_embedding2 = None
        # keyframe device→host format: 'rgb' (uint8 HWC) or 'i420' (packed
        # 4:2:0 planes, 1.5 B/px; run_transition_streaming selects it)
        self._keyframe_fmt = "rgb"
        # the last round's deferred similarity pass, and the previous
        # streaming transition's last device op (drained before the next)
        self._sims_pending = None
        self._queue_tail = None
        self.timer = PhaseTimer()
        self.last_report = TransitionReport()
        # the last movie's writer backend and settled JPEG quality (note_writer)
        self.last_writer_backend: Optional[str] = None
        self.last_jpeg_quality: Optional[int] = None

        # cost model of the fused-vs-per-level gate (seconds). dt_unet_step
        # and dt_vae are placeholders until measured (turbo engines do not
        # run the speed benchmark by default); the rest is None until observed
        self.dt_unet_step = 0.01
        self.dt_vae = 0.01
        self._dt_unet_step_measured = False
        # per-(row,step) cost of the fused scan (every row runs all N steps)
        self.dt_unet_step_fused: Optional[float] = None
        # per useful (row,step) cost of the segmented scan (rows enter at
        # their injection step, the batch grows per segment)
        self.dt_unet_step_fused_multi: Optional[float] = None
        # one tiny synced op's wall: the per-round host↔device round trip
        self.dt_sync: Optional[float] = None
        # observed per-(row,step) per-level denoise cost by batch size
        self._dt_step_by_batch: dict[int, float] = {}
        # fused path's output tail: host wall from the scan landing to the
        # decode/host-copy/similarity dispatches being issued
        self._dt_fused_output: Optional[float] = None

        self.set_guidance_scale()
        self.set_guidance_rescale()
        if similarity_metric == "lpips" and lpips_params is None:
            log.warning(
                "similarity_metric='lpips' requested without weights — using the random-feature stand-in "
                "(valid for relative gap ranking only). Omit similarity_metric (or pass 'nlpd') for the "
                "deterministic weight-free metric."
            )
        self.lpips = self._scorer(similarity_metric)
        self.set_prompt1("")
        self.set_prompt2("")
        self.set_branch1_crossfeed()
        self.set_parental_crossfeed()
        self.set_num_inference_steps()
        if run_benchmark is None:
            # turbo's branching plan never reads the timings
            run_benchmark = not self.dh.is_sdxl_turbo
        if run_benchmark:
            self.benchmark_speed()
        self.set_branching()
        if config is not None:
            self.apply_config(config)

    @property
    def placement_policy(self) -> str:
        return self._placement_policy

    @placement_policy.setter
    def placement_policy(self, policy: str) -> None:
        if policy not in _PLACEMENT_POLICIES:
            raise ValueError(f"placement_policy must be one of {_PLACEMENT_POLICIES}, got {policy!r}")
        self._placement_policy = policy

    def _predictive(self) -> bool:
        """Whether rounds place by predicted splitting with no device read
        between them (the predictive policy over whole-level rounds)."""
        return self.placement_policy == "predictive" and self.stem_batch == 0

    # ------------------------------------------------------- unified config

    def get_config(self) -> EngineConfig:
        """Every engine knob in one EngineConfig."""
        d, t, n = self._branching_args
        return EngineConfig(
            width=self.dh.width_img, height=self.dh.height_img,
            num_inference_steps=self.num_inference_steps,
            guidance_scale=self.guidance_scale_base,
            guidance_rescale=self.guidance_rescale,
            guidance_scale_mid_damper=self.guidance_scale_mid_damper,
            mid_compression_scaler=self.mid_compression_scaler,
            negative_prompt=self.negative_prompt,
            seed1=self.seed1, seed2=self.seed2,
            branch1_crossfeed_power=self.branch1_crossfeed_power,
            branch1_crossfeed_range=self.branch1_crossfeed_range,
            branch1_crossfeed_decay=self.branch1_crossfeed_decay,
            parental_crossfeed_power=self.parental_crossfeed_power,
            parental_crossfeed_range=self.parental_crossfeed_range,
            parental_crossfeed_decay=self.parental_crossfeed_decay,
            depth_strength=d, t_compute_max_allowed=t, nmb_max_branches=n,
            stem_batch=self.stem_batch, cost_model=self.cost_model,
            placement_policy=self.placement_policy,
            similarity_metric=self.similarity_metric,
        )

    def _scorer(self, metric: str):
        """The gap metric's scorer on the holder's device."""
        if metric == "nlpd":
            return NLPDScorer(device=self.dh.device)
        return LPIPSScorer(params=self._lpips_params, device=self.dh.device)

    def apply_config(self, cfg: EngineConfig) -> None:
        """Apply an EngineConfig through the setters (None fields keep the
        model's defaults). A similarity_metric other than the engine's
        switches the scorer; 'lpips' takes the weights the constructor was
        given (the random stand-in without)."""
        if cfg.similarity_metric not in (None,) + _METRICS:
            raise ValueError(f"similarity_metric must be one of {_METRICS}, got {cfg.similarity_metric!r}")
        if cfg.cost_model not in _COST_MODELS:
            raise ValueError(f"cost_model must be one of {_COST_MODELS}, got {cfg.cost_model!r}")
        if cfg.width is not None and cfg.height is not None:
            self.set_dimensions((cfg.width, cfg.height))
        self.set_guidance_scale(cfg.guidance_scale)
        self.set_guidance_rescale(cfg.guidance_rescale)
        self.guidance_scale_mid_damper = cfg.guidance_scale_mid_damper
        self.mid_compression_scaler = cfg.mid_compression_scaler
        if cfg.negative_prompt:
            self.set_negative_prompt(cfg.negative_prompt)
        self.seed1, self.seed2 = int(cfg.seed1), int(cfg.seed2)
        self.set_branch1_crossfeed(cfg.branch1_crossfeed_power, cfg.branch1_crossfeed_range,
                                   cfg.branch1_crossfeed_decay)
        self.set_parental_crossfeed(cfg.parental_crossfeed_power, cfg.parental_crossfeed_range,
                                    cfg.parental_crossfeed_decay)
        self.stem_batch = int(cfg.stem_batch)
        self.cost_model = cfg.cost_model
        self.placement_policy = cfg.placement_policy
        if cfg.similarity_metric is not None and cfg.similarity_metric != self.similarity_metric:
            self.similarity_metric = cfg.similarity_metric
            self.lpips = self._scorer(cfg.similarity_metric)
        if cfg.num_inference_steps is not None:
            self.set_num_inference_steps(cfg.num_inference_steps)
        self.set_branching(cfg.depth_strength, cfg.t_compute_max_allowed, cfg.nmb_max_branches)

    # ------------------------------------------------------------- cost model

    def benchmark_speed(self):
        """Measure the per-step and decode costs the budget planner reads.

        cost_model='batched' times what the run itself executes: the B=2
        edge denoise and a B=2 decode, each the second of two calls, then
        the sync round trip (measure_sync_overhead). 'reference' takes the
        reference's single-branch measurement (SDXLHolder.benchmark_speed)."""
        if self.cost_model == "reference":
            self.dt_unet_step, self.dt_vae = self.dh.benchmark_speed()
            self._dt_unet_step_measured = True
            return
        N = self.dh.num_inference_steps
        lat0 = torch.cat([self.get_noise(0), self.get_noise(1)], dim=0)
        cond = self._stack_conditionings([0.0, 1.0])
        g = torch.tensor([self._guidance_at(0.0), self._guidance_at(1.0)], dtype=torch.float32)
        with torch.no_grad():
            _sync(self.dh.run_diffusion_batched(cond, lat0, idx_start=0, guidance_scale=g))
            t0 = time.time()
            traj = self.dh.run_diffusion_batched(cond, lat0, idx_start=0, guidance_scale=g)
            _sync(traj)
            sample = (time.time() - t0) / (2 * N)
            self._observe_unet_step(sample)
            self._dt_step_by_batch[2] = self._observe(self._dt_step_by_batch.get(2), sample)
            _sync(self.dh.decode_to_pm1_batched(traj[-1]))
            t0 = time.time()
            pm1 = self.dh.decode_to_pm1_batched(traj[-1])
            _sync(pm1)
            self.dt_vae = (time.time() - t0) / 2
        self.measure_sync_overhead(anchor=pm1)

    def measure_sync_overhead(self, reps: int = 3, anchor: Optional[torch.Tensor] = None) -> float:
        """(Re-)measure dt_sync as the MIN of `reps` tiny synchronized
        round trips (one tiny op, then torch.cuda.synchronize). `anchor` is
        any 4-D device tensor to chain the tiny op on (default: zeros on the
        holder's device)."""
        if anchor is None:
            anchor = torch.zeros((1, 1, 1, 1), dtype=torch.float32, device=self.dh.device)
        tiny = anchor[:1, :1, :1, :1] + 1.0
        _sync(tiny)
        best = None
        for i in range(max(1, reps)):
            t0 = time.time()
            tiny = anchor[:1, :1, :1, :1] + (2.0 + i)
            _sync(tiny)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        self.dt_sync = best
        return best

    def predict_transition_time(self, recycled1: bool = False) -> dict:
        """Cost-model prediction of the next run_transition's blocking wall.

        * fused path (single-level plans): denoise_scan_tree runs EVERY row
          for all N steps → N·B·dt_fused + the output-dispatch tail.
        * fused-multi path (multi-level plans under the predictive policy):
          denoise_scan_tree_seg runs only the useful row-steps → row-steps ·
          dt_fused_multi + the output-dispatch tail.
        * per-level path: edge steps + Σ(N−idx)·k per round of stem_batch
          stems, priced at each round's observed per-(row,step) cost for its
          batch size, plus decode per keyframe, and two sync round trips per
          round under the measured policy (one in all under the predictive).

        Returns {"path", "t_predicted_s", "t_fused_s", "t_fused_multi_s",
        "t_per_level_s"}; "path" is what the LB_FUSED=auto gate would pick."""
        N = self.num_inference_steps
        plan_idx = [int(i) for i in self.list_idx_injection]
        plan_stems = [int(n) for n in self.list_nmb_stems]
        sync = self.dt_sync or 0.0
        dt = lambda b: self._dt_step_by_batch.get(b, self.dt_unet_step)  # noqa: E731

        # ---- per-level path
        t_pl = N * dt(1) if recycled1 else 2 * N * dt(2)
        rounds = 0
        for idx, n in zip(plan_idx, plan_stems):
            for k in self._round_sizes(n):
                t_pl += (N - idx) * k * dt(k)
                rounds += 1
        t_pl += (sum(plan_stems) + 2) * self.dt_vae
        t_pl += sync if self._predictive() else 2.0 * sync * rounds

        out = self._dt_fused_output if self._dt_fused_output is not None else sync
        # ---- fused path (the gate's structural conditions)
        t_fused = None
        if self.stem_batch == 0 and len(plan_idx) == 1 and plan_stems[0] >= 1 and plan_idx[0] >= 1:
            B = (1 if recycled1 else 2) + plan_stems[0]
            dtf = self.dt_unet_step_fused if self.dt_unet_step_fused is not None else self.dt_unet_step
            t_fused = N * B * dtf + out

        # ---- segmented multi-level path: only the useful row-steps run
        t_fm = None
        if self._multilevel_fusable():
            _, row_steps = self._seg_plan(recycled1)
            dtfm = self.dt_unet_step_fused_multi
            if dtfm is None:
                dtfm = self.dt_unet_step_fused if self.dt_unet_step_fused is not None else self.dt_unet_step
            t_fm = row_steps * dtfm + out

        # the two fused paths exclude each other (the number of levels decides)
        gate = os.environ.get("LB_FUSED", "auto")
        if t_fused is not None:
            fused_name, fused_t, fused_cal = "fused", t_fused, self.dt_unet_step_fused
        elif t_fm is not None:
            fused_name, fused_t, fused_cal = "fused-multi", t_fm, self.dt_unet_step_fused_multi
        else:
            fused_name = fused_t = fused_cal = None
        if fused_t is None or gate == "0":
            path = "per-level"
        elif gate == "1" or self.dt_sync is None or fused_cal is None:
            path = fused_name
        else:
            path = fused_name if fused_t <= t_pl else "per-level"
        return {
            "path": path,
            "t_predicted_s": t_pl if path == "per-level" else fused_t,
            "t_fused_s": t_fused,
            "t_fused_multi_s": t_fm,
            "t_per_level_s": t_pl,
        }

    def _round_sizes(self, n: int) -> list[int]:
        """Batch sizes of the rounds a level of n stems runs in."""
        batch = n if self.stem_batch == 0 else self.stem_batch
        return [min(batch, n - done) for done in range(0, n, max(1, batch))]

    def _multilevel_fusable(self) -> bool:
        """Structural validity of the segmented scan: the placements of every
        level must be value-independent (the predictive policy), levels must
        deepen strictly (rows enter in segment order), all at depth >= 1."""
        idx = [int(i) for i in self.list_idx_injection]
        return (
            self._predictive()
            and len(idx) >= 2
            and all(i >= 1 for i in idx)
            and all(b > a for a, b in zip(idx, idx[1:]))
            and all(int(n) >= 1 for n in self.list_nmb_stems)
        )

    def _seg_plan(self, recycled1: bool) -> tuple[list[tuple[int, int]], int]:
        """Segment table ((start_step, batch), ...) of the current plan and
        its total useful row-step count."""
        N = self.num_inference_steps
        B = 1 if recycled1 else 2
        segs = [(0, B)]
        for idx, k in zip(self.list_idx_injection, self.list_nmb_stems):
            B += int(k)
            segs.append((int(idx), B))
        ends = [i0 for i0, _ in segs[1:]] + [N]
        return segs, sum((i1 - i0) * Bs for (i0, Bs), i1 in zip(segs, ends))

    def planner_calibrated(self, recycled1: bool = False) -> bool:
        """Whether predict_transition_time's active path has measured inputs
        (a warm fused or fused-multi run and the output tail; or observed
        per-batch step costs for every round size plus the sync round trip)
        instead of placeholder fallbacks."""
        path = self.predict_transition_time(recycled1=recycled1)["path"]
        if path == "fused":
            return self.dt_unet_step_fused is not None and self._dt_fused_output is not None
        if path == "fused-multi":
            return self.dt_unet_step_fused_multi is not None and self._dt_fused_output is not None
        sizes = {1 if recycled1 else 2}
        for n in self.list_nmb_stems:
            sizes.update(self._round_sizes(int(n)))
        return self.dt_sync is not None and all(b in self._dt_step_by_batch for b in sizes)

    def _fused_predicted_faster(self, recycled1: bool) -> bool:
        """Auto-gate arbitration (LB_FUSED unset): an uncalibrated engine
        (no sync measurement, or no warm run of the candidate fused path
        yet) takes the fused path; a calibrated one takes the path the cost
        model prices lower."""
        cal = self.dt_unet_step_fused if len(self.list_idx_injection) == 1 else self.dt_unet_step_fused_multi
        if self.dt_sync is None or cal is None:
            return True
        return self.predict_transition_time(recycled1=recycled1)["path"] != "per-level"

    @staticmethod
    def _observe(current: Optional[float], sample: float) -> float:
        """Fold a run-time calibration sample into `current` by MIN: observed
        walls only deviate up from the steady-state price."""
        return sample if current is None else min(current, sample)

    def _observe_unet_step(self, sample: float) -> None:
        """min-fold a per-row UNet step sample into dt_unet_step, treating
        the constructor's placeholder as never measured."""
        if self._dt_unet_step_measured:
            self.dt_unet_step = min(self.dt_unet_step, sample)
        else:
            self.dt_unet_step = sample
            self._dt_unet_step_measured = True

    # ------------------------------------------------------------- settings

    def set_dimensions(self, size_output: Optional[tuple[int, int]] = None):
        old = (self.dh.height_img, self.dh.width_img)
        self.dh.set_dimensions(size_output)
        if (self.dh.height_img, self.dh.width_img) != old:
            # step and output costs are resolution-specific: drop them
            self._dt_step_by_batch.clear()
            self.dt_unet_step_fused = None
            self.dt_unet_step_fused_multi = None
            self._dt_fused_output = None
            self._dt_unet_step_measured = False

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

    def set_guidance_mid_dampening(self, fract_mixing: float):
        """The guidance of a branch at fract_mixing (dampened towards the
        middle) for the single-branch calls that follow."""
        g = guidance_mid_dampening(fract_mixing, self.guidance_scale_base, self.guidance_scale_mid_damper)
        self.guidance_scale = g
        self.dh.guidance_scale = g

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

    def set_image1(self, image):
        self.image1_lowres = image

    def set_image2(self, image):
        self.image2_lowres = image

    def _image_noise(self, seed: int, shape: tuple) -> torch.Tensor:
        """The unit-normal ε of an image trajectory, float32 from a
        torch.Generator seeded with `seed` (the JAX package draws it with
        jax.random.normal; tests replace this method with that draw)."""
        gen = torch.Generator(device=self.dh.device).manual_seed(int(seed))
        return torch.randn(shape, generator=gen, device=self.dh.device, dtype=torch.float32)

    @torch.no_grad()
    def compute_latents_from_image(self, image, seed: int) -> list:
        """Keyframe trajectory from a real image: VAE-encode it to x0, then
        the diffusion states x_i = x0 + σ_{i+1}·ε with one fixed unit-noise
        draw (the forward-noised states an ideal denoiser would pass); the
        last entry is x0 (σ_N = 0)."""
        x0 = self.dh.image2latent(image)
        eps = self._image_noise(seed, tuple(x0.shape)).to(x0.dtype)
        sig = self.dh.schedule.sigmas
        return [x0 + float(sig[i + 1]) * eps for i in range(self.num_inference_steps)]

    def set_keyframe1_image(self, image, seed: Optional[int] = None):
        """Pin the first keyframe to a real image; run with
        run_transition(recycle_img1=True)."""
        self.set_image1(image)
        self.tree_latents[0] = self.compute_latents_from_image(image, self.seed1 if seed is None else seed)

    def set_keyframe2_image(self, image, seed: Optional[int] = None):
        """Pin the second keyframe to a real image; run with
        run_transition(recycle_img2=True)."""
        self.set_image2(image)
        traj = self.compute_latents_from_image(image, self.seed2 if seed is None else seed)
        if self.tree_latents[-1] is None or len(self.tree_latents) < 2:
            self.tree_latents = [self.tree_latents[0], traj]
        else:
            self.tree_latents[-1] = traj

    def set_num_inference_steps(self, num_inference_steps: Optional[int] = None):
        if num_inference_steps is None:
            num_inference_steps = 4 if self.dh.is_sdxl_turbo else 30
        changed = getattr(self, "num_inference_steps", None) != int(num_inference_steps)
        self.num_inference_steps = int(num_inference_steps)
        self.dh.set_num_inference_steps(self.num_inference_steps)
        if changed and getattr(self, "_branching_args", None) is not None:
            self.set_branching(*self._branching_args)

    def set_branching(self, depth_strength=None, t_compute_max_allowed=None, nmb_max_branches=None):
        """Turbo: the one-level plan. Base: the time-based plan (default
        depth 0.5 and a 20 s budget; a budget and a branch count exclude
        each other)."""
        if self.dh.is_sdxl_turbo and t_compute_max_allowed is not None:
            raise ValueError("time-based branching not supported for SDXL Turbo")
        self._branching_args = (depth_strength, t_compute_max_allowed, nmb_max_branches)
        if self.dh.is_sdxl_turbo:
            self.list_idx_injection, self.list_nmb_stems = turbo_branching_plan(
                self.num_inference_steps, depth_strength, nmb_max_branches
            )
            return
        if depth_strength is None:
            depth_strength = 0.5
        if t_compute_max_allowed is None and nmb_max_branches is None:
            t_compute_max_allowed = 20
        elif t_compute_max_allowed is not None and nmb_max_branches is not None:
            raise ValueError("Either specify t_compute_max_allowed or nmb_max_branches")
        self.list_idx_injection, self.list_nmb_stems = self.get_time_based_branching(
            depth_strength, t_compute_max_allowed, nmb_max_branches
        )

    def get_time_based_branching(self, depth_strength, t_compute_max_allowed=None, nmb_max_branches=None):
        return time_based_branching_plan(
            self.num_inference_steps, depth_strength, self.dt_unet_step, self.dt_vae,
            t_compute_max_allowed, nmb_max_branches,
        )

    def get_noise(self, seed: int) -> torch.Tensor:
        return self.dh.get_noise(seed)

    # -------------------------------------------------------------- main run

    def run_transition(self, recycle_img1: Optional[bool] = False, recycle_img2: Optional[bool] = False,
                       fixed_seeds: Optional[List[int]] = None) -> list:
        """Compute the keyframe transition; returns the uint8 [H,W,3] keyframes."""
        self._run_transition_core(recycle_img1, recycle_img2, fixed_seeds)
        with self.timer.phase("keyframe_fetch"):
            self._resolve_keyframes()
        self._finalize_report()
        return self.tree_final_imgs

    def run_transition_streaming(self, recycle_img1: Optional[bool] = False, recycle_img2: Optional[bool] = False,
                                 fixed_seeds: Optional[List[int]] = None, keyframe_format: str = "auto") -> list:
        """Dispatch the whole transition and return the keyframe HANDLES
        without waiting for their device→host copies.

        The list parallels tree_final_imgs and may hold pending handles;
        materialize each with resolve_image (one batch_cache per consumer).
        Then call finalize_report() to land the deferred similarity pass,
        and resolve_keyframes() if tree_final_imgs should become uint8 RGB.

        keyframe_format: 'rgb' (uint8 HWC), 'i420' (packed 4:2:0 planes,
        half the bytes), or 'auto' (i420 whenever the dimensions allow it
        and LB_KEYFRAME_I420 is not '0')."""
        if keyframe_format == "auto":
            keyframe_format = "i420" if self._i420_fetch_ok() else "rgb"
        if keyframe_format not in ("rgb", "i420"):
            raise ValueError(f"keyframe_format must be 'auto', 'rgb' or 'i420', got {keyframe_format!r}")
        self._keyframe_fmt = keyframe_format
        try:
            self._run_transition_core(recycle_img1, recycle_img2, fixed_seeds)
        finally:
            self._keyframe_fmt = "rgb"
        return list(self.tree_final_imgs)

    def finalize_report(self, sync_sims: bool = True) -> TransitionReport:
        """Land any deferred similarity pass and seal last_report — the
        closing half of the run_transition_streaming contract. With
        sync_sims=False the pending handle goes to
        last_report.sims_pending (TransitionReport.resolve_sims lands it)
        and lpips_gaps stays empty until then."""
        self._finalize_report(sync_sims=sync_sims)
        return self.last_report

    def resolve_keyframes(self, batch_cache: Optional[dict] = None) -> list:
        """Materialize tree_final_imgs to uint8 RGB."""
        self._resolve_keyframes(batch_cache)
        return self.tree_final_imgs

    @torch.no_grad()
    def _run_transition_core(self, recycle_img1: Optional[bool] = False, recycle_img2: Optional[bool] = False,
                             fixed_seeds: Optional[List[int]] = None):
        """Everything up to (excluding) keyframe resolution: on exit the tree
        is final, tree_final_imgs may hold _PendingImage handles and the
        last round's similarities may still be in flight (_sims_pending)."""
        if self.text_embedding1 is None or self.text_embedding2 is None:
            raise RuntimeError("set both prompts (set_prompt1/2) before run_transition")
        if fixed_seeds is not None:
            if fixed_seeds == "randomize":
                fixed_seeds = list(np.random.randint(0, 1000000, 2).astype(np.int32))
            elif len(fixed_seeds) != 2:
                raise ValueError("fixed_seeds needs 2 entries")
            self.seed1, self.seed2 = int(fixed_seeds[0]), int(fixed_seeds[1])

        # drain a previous streaming transition's deferred device tail
        # outside any phase timer, so the next denoise phase does not absorb it
        if self._queue_tail is not None:
            np.asarray(self._queue_tail)
            self._queue_tail = None

        N = self.num_inference_steps
        self._t_run0 = time.time()
        self.timer = PhaseTimer()
        self.last_report = TransitionReport(num_steps=N)
        self._sims_pending = None
        self.dh.reset_noise_stream((int(self.seed1) * 1_000_003 + int(self.seed2)) & 0x7FFFFFFF)

        ok1 = bool(recycle_img1) and self.tree_latents[0] is not None and len(self.tree_latents[0]) == N
        ok2 = bool(recycle_img2) and self.tree_latents[-1] is not None and len(self.tree_latents[-1]) == N

        # the JAX gate also needs no device mesh: the port runs on one device
        structural_ok = (
            not ok2
            and self.stem_batch == 0
            and len(self.list_idx_injection) == 1
            and int(self.list_nmb_stems[0]) >= 1
            and int(self.list_idx_injection[0]) >= 1
        )
        gate = os.environ.get("LB_FUSED", "auto")
        take_fused = gate == "1" or (gate != "0" and self._fused_predicted_faster(ok1))
        if structural_ok and take_fused:
            self._run_transition_fused(recycled1=ok1)
            return
        if not ok2 and self._multilevel_fusable() and take_fused:
            # the whole multi-level plan as ONE segmented call: valid under
            # the predictive policy only (placements across all levels are
            # then value-independent)
            self._run_transition_fused_multi(recycled1=ok1)
            return

        if ok1 and ok2:
            list_latents1, list_latents2 = self.tree_latents[0], self.tree_latents[-1]
        elif not ok1 and not ok2 and self.branch1_crossfeed_power == 0.0:
            with self.timer.phase("denoise"):
                list_latents1, list_latents2 = self._compute_edge_latents_batched()
        else:
            with self.timer.phase("denoise"):
                list_latents1 = self.tree_latents[0] if ok1 else self.compute_latents1()
                list_latents2 = self.tree_latents[-1] if ok2 else self.compute_latents2()
                _sync(list_latents2[-1])

        self.tree_latents = [list_latents1, list_latents2]
        self.tree_fracts = [0.0, 1.0]
        with self.timer.phase("vae_decode"):
            edge_pm1 = self.dh.decode_to_pm1_batched(torch.cat([list_latents1[-1], list_latents2[-1]], dim=0))
            edge_u8 = _fetch(self._fetch_keyframes_u8(edge_pm1))
        self.tree_final_imgs = [_PendingImage(edge_u8, 0), _PendingImage(edge_u8, 1)]
        self._imgs_dev = [edge_pm1[0], edge_pm1[1]]
        self.tree_idx_injection = [0, 0]
        # predictive policy: no device value is read between levels, so the
        # rounds chain on the device and the host syncs once, at the end
        self.tree_similarities = [1.0] if self._predictive() else self._batched_similarities()
        self._run_levels(self.list_idx_injection, self.list_nmb_stems)

    def _run_levels(self, list_idx_injection, list_nmb_stems, extended: bool = False) -> None:
        """Each level's stems in rounds of stem_batch (0: the whole level).
        The last round's similarities are report-only, so they are deferred;
        a predictive round syncs only if it is the last."""
        predictive = self._predictive()
        n_levels = len(list_idx_injection)
        for s_idx, (idx_injection, nmb_stems) in enumerate(zip(list_idx_injection, list_nmb_stems)):
            idx_injection, nmb_stems = int(idx_injection), int(nmb_stems)
            t_lvl = time.time()
            done = 0
            for k in self._round_sizes(nmb_stems):
                done += k
                is_last = s_idx == n_levels - 1 and done >= nmb_stems
                self._run_stem_round(k, idx_injection, defer_sims=is_last, predicted=predictive,
                                     sync=(not predictive) or is_last)
            level = {"idx_injection": idx_injection, "stems": nmb_stems}
            if extended:
                level["extended"] = True
            level["wall_s"] = round(time.time() - t_lvl, 3)
            self.last_report.levels.append(level)

    def extend_transition(self, list_idx_injection, list_nmb_stems) -> list:
        """Deepen the current tree with more stem levels; no existing
        trajectory is recomputed. Valid after run_transition; each new stem
        costs only its N − idx_injection steps. Placement follows the
        placement policy against the live gap similarities, so run([a]) +
        extend([b]) gives the tree of run([a, b]) for deterministic solvers.
        Returns the extended keyframe list, like run_transition."""
        if not (len(self.tree_latents) >= 2 and len(self.tree_fracts) == len(self.tree_latents)
                and all(lat is not None for lat in self.tree_latents)):
            raise RuntimeError("extend_transition needs an existing tree: run_transition() first")
        N = self.num_inference_steps
        list_idx_injection = [int(i) for i in list_idx_injection]
        list_nmb_stems = [int(n) for n in list_nmb_stems]
        if len(list_idx_injection) != len(list_nmb_stems):
            raise ValueError("list_idx_injection and list_nmb_stems differ in length")
        for idx in list_idx_injection:
            if not 1 <= idx < N:
                raise ValueError(f"idx_injection {idx} outside [1, {N - 1}]")
        self.timer = PhaseTimer()
        self.last_report = TransitionReport(num_steps=N)
        self._t_run0 = time.time()
        # a previous run's deferred similarity pass lands before placement reads it
        if self._sims_pending is not None:
            self.tree_similarities = np.asarray(self._sims_pending, np.float64).tolist()
            self._sims_pending = None
        if len(self.tree_similarities) != len(self.tree_fracts) - 1:
            self.tree_similarities = (
                [1.0] * (len(self.tree_fracts) - 1) if self._predictive() else self._batched_similarities()
            )
        with torch.no_grad():
            self._run_levels(list_idx_injection, list_nmb_stems, extended=True)
        self._resolve_keyframes()
        self._finalize_report()
        return self.tree_final_imgs

    def _run_transition_fused(self, recycled1: bool = False):
        """The whole single-level transition as ONE denoise call.

        denoise_scan_tree computes the edge trajectories and all k stems in
        one batch: stem rows are pinned to the live parental mix of the edge
        rows at their injection step (crossfeed coefficient 1.0) and follow
        the parental crossfeed schedule after — per-stem results equal the
        per-level path's for deterministic solvers.

        recycled1 (chained transitions): edge 1's stored trajectory rides
        along as a per-step window instead of being recomputed. branch1
        crossfeed is expressed the same way: edge 2's mix target is edge 1's
        entering state (live row or window)."""
        N = self.num_inference_steps
        idx_injection = int(self.list_idx_injection[0])
        k = int(self.list_nmb_stems[0])

        # plan against the virgin two-edge tree: predicted bisection of the
        # single gap is value-independent, so no measurement is needed
        win_list = self.tree_latents[0] if recycled1 else None
        self.tree_fracts = [0.0, 1.0]
        self.tree_idx_injection = [0, 0]
        self.tree_similarities = [1.0]
        placements, _ = self._plan_placements(k, idx_injection)
        fracts = [f for f, _, _ in placements]
        # batch rows: [edge1?, edge2, stems...]; edge 1 is a row only when
        # computed live, else it is the window input
        n_edges = 1 if recycled1 else 2
        B = n_edges + k
        e2 = n_edges - 1  # batch row of edge 2
        row_of = {0: 0, 1: e2}  # tree row → batch row

        noise2 = self.get_noise(self.seed2)
        # stem rows need a FINITE placeholder state before their pin
        # (outputs discarded there); edge starts are the seeded noises
        if recycled1:
            lat0 = torch.cat([noise2] * (1 + k), dim=0)
            cond_fracts = [1.0] + fracts
            win_stack = torch.cat(list(win_list), dim=0)  # [N,h,w,4]
            # step i mixes toward trajectory entry i-1; entry 0 is never
            # read (coefficient 0 at step 0)
            win_steps = torch.cat([win_stack[:1], win_stack[:-1]], dim=0)
            win_mask = np.ones((B,), bool)  # parent 1 of every row is edge 1
            win_mask[e2] = self.branch1_crossfeed_power > 0.0
        else:
            noise1 = self.get_noise(self.seed1)
            lat0 = torch.cat([noise1, noise2] + [noise1] * k, dim=0)
            cond_fracts = [0.0, 1.0] + fracts
            win_steps = win_mask = None
        cond = self._stack_conditionings(cond_fracts)
        guidance = torch.tensor([self._guidance_at(f) for f in cond_fracts], dtype=torch.float32)

        parent_idx = np.zeros((B, 2), np.int64)  # edges: themselves
        parent_fract = np.zeros((B,), np.float32)
        # edge 2's branch1-crossfeed target is edge 1 at fract 0
        parent_idx[e2] = (0, 0)
        for r, (f, b1, b2) in enumerate(placements):
            # single-level plan: the parents are the two edges
            parent_idx[n_edges + r] = (row_of[b1], row_of[b2])
            parent_fract[n_edges + r] = (f - self.tree_fracts[b1]) / (self.tree_fracts[b2] - self.tree_fracts[b1])
        base = parental_crossfeed_coeffs(
            N, idx_injection, self.parental_crossfeed_power,
            self.parental_crossfeed_range, self.parental_crossfeed_decay,
        )
        coeffs = np.zeros((N, B), np.float32)
        coeffs[:, n_edges:] = np.asarray(base, np.float32)[:, None]
        coeffs[:idx_injection, n_edges:] = 0.0
        # the pin: fraction 1.0 starts the stem exactly from the parental
        # mix state idx-1
        coeffs[idx_injection, n_edges:] = 1.0
        if self.branch1_crossfeed_power > 0.0:
            coeffs[:, e2] = branch1_crossfeed_coeffs(
                N, self.branch1_crossfeed_power, self.branch1_crossfeed_range, self.branch1_crossfeed_decay,
            )
        # per-row pin step: edges are real from step 0, stems from their pin
        pins = np.zeros((B,), np.int64)
        pins[n_edges:] = idx_injection
        with self.timer.phase("denoise"):
            t0 = time.time()
            traj = self.dh.run_tree_batched(
                cond, lat0, parent_idx, parent_fract, coeffs, guidance,
                win_steps=win_steps, win_mask=win_mask, pin_steps=pins,
            )
            _sync(traj)
            if self.dh.last_run_was_warm:
                # every row runs all N steps: a calibration of its own,
                # apart from the per-level path's
                self.dt_unet_step_fused = self._observe(self.dt_unet_step_fused, (time.time() - t0) / (N * B))

        # ONE decode pipeline for edges and stems; a recycled edge 1's final
        # latent joins it so its keyframe is rebuilt (swap_forward cleared it)
        t_out0 = time.time()
        sorted_stems = sorted(range(k), key=lambda i: fracts[i])
        finals = traj[-1] if not recycled1 else torch.cat([win_stack[-1:], traj[-1]], dim=0)
        # decode row of: edge1 = 0, edge2 = e2 + off, stem i = n_edges + off + i
        off = 1 if recycled1 else 0
        order_rows = [0] + [n_edges + off + i for i in sorted_stems] + [e2 + off]
        with self.timer.phase("vae_decode"):
            pm1_of, chunk_of = self._decode_fetch_chunks(finals, order_rows)

        M = N - idx_injection
        list1 = list(win_list) if recycled1 else [traj[i, 0:1] for i in range(N)]
        list2 = [traj[i, e2 : e2 + 1] for i in range(N)]
        self.tree_latents = (
            [list1]
            + [
                [None] * idx_injection + [traj[idx_injection + j, n_edges + i : n_edges + 1 + i] for j in range(M)]
                for i in sorted_stems
            ]
            + [list2]
        )
        self.tree_fracts = [0.0] + [fracts[i] for i in sorted_stems] + [1.0]
        self.tree_idx_injection = [0] + [idx_injection] * k + [0]
        self.tree_final_imgs = [_PendingImage(*chunk_of[row]) for row in order_rows]
        self._imgs_dev = [pm1_of[row] for row in order_rows]
        with self.timer.phase("similarity"):
            self._sims_pending = _fetch(self._dispatch_similarities())
        if self.dh.last_run_was_warm:
            # host wall of the output dispatches (warm runs only)
            self._dt_fused_output = self._observe(self._dt_fused_output, time.time() - t_out0)
        self.last_report.levels.append({"idx_injection": idx_injection, "stems": k, "fused": True,
                                        "recycled": recycled1})

    def _plan_multilevel(self, recycled1: bool):
        """The predictive per-level placement loop over ALL levels, simulated
        on the virgin two-edge tree: valid because predictive placements
        read no measured value (gap similarities halve by prediction, and
        parents are found by the bracketing, strictly-shallower walk against
        the tree each level sees).

        Returns (stems, sims): stems[i] describes batch row n_edges + i as
        (fract, (p1_row, p2_row), parent_fract, level_idx, win1), rows in
        level order then placement order (the scan's batch order); sims is
        the final predicted gap-similarity list in tree order."""
        n_edges = 1 if recycled1 else 2
        fracts = [0.0, 1.0]
        sims = [1.0]
        idxinj = [0, 0]
        # batch row of each tree position; a recycled edge 1 has no row (a
        # dummy 0: win_mask substitutes the window for its state)
        rowmap = [0, n_edges - 1]
        win1 = [recycled1, False]
        stems = []
        next_row = n_edges
        for idx_injection, k in zip(self.list_idx_injection, self.list_nmb_stems):
            idx_injection, k = int(idx_injection), int(k)
            lf, ls = list(fracts), list(sims)
            placed = []
            for _ in range(k):
                g = int(np.argmax(ls))
                fm = (lf[g] + lf[g + 1]) / 2.0
                b1, b2 = get_closest_idx(fm, fracts)
                while idxinj[b1] >= idx_injection:
                    b1 -= 1
                while idxinj[b2] >= idx_injection:
                    b2 += 1
                placed.append((fm, b1, b2))
                ls[g : g + 1] = [ls[g] * 0.5, ls[g] * 0.5]
                lf.insert(g + 1, fm)
            rows_of_level = []
            for fm, b1, b2 in placed:
                pf = (fm - fracts[b1]) / (fracts[b2] - fracts[b1])
                stems.append((fm, (rowmap[b1], rowmap[b2]), pf, idx_injection, win1[b1]))
                rows_of_level.append((fm, next_row))
                next_row += 1
            # the level joins the simulated tree in fract order
            for fm, row in sorted(rows_of_level):
                pos = get_closest_idx(fm, fracts)[0] + 1
                fracts.insert(pos, fm)
                idxinj.insert(pos, idx_injection)
                rowmap.insert(pos, row)
                win1.insert(pos, False)
            sims = ls
        return stems, sims

    def _run_transition_fused_multi(self, recycled1: bool = False):
        """A whole multi-level transition as ONE denoise_scan_tree_seg call:
        segments of steps whose batch grows as each level's stems enter at
        their injection step, pinned to the live parental mix by crossfeed
        coefficient 1.0; deeper stems parent on shallower stem rows of the
        same batch. Runs exactly the per-level path's useful row-steps, each
        in the largest batch alive at its depth, with no per-level
        dispatches. Per-stem results equal the predictive per-level path's
        for deterministic solvers.

        recycled1 and branch1 crossfeed ride along as in
        _run_transition_fused (a per-step window and edge 2's mix
        schedule); then ONE decode → convert → host copy pipeline in fract
        order, and the similarity pass deferred."""
        N = self.num_inference_steps
        n_edges = 1 if recycled1 else 2
        e2 = n_edges - 1
        win_list = self.tree_latents[0] if recycled1 else None
        self.tree_fracts = [0.0, 1.0]
        self.tree_idx_injection = [0, 0]
        self.tree_similarities = [1.0]
        stems, plan_sims = self._plan_multilevel(recycled1)
        k_total = len(stems)
        B = n_edges + k_total
        segs, row_steps = self._seg_plan(recycled1)
        fracts = [f for f, _, _, _, _ in stems]

        noise2 = self.get_noise(self.seed2)
        if recycled1:
            lat0 = noise2  # entering stem rows are initialised in the scan
            cond_fracts = [1.0] + fracts
            win_stack = torch.cat(list(win_list), dim=0)  # [N,h,w,4]
            # step i mixes toward trajectory entry i-1; entry 0 is never
            # read (coefficient 0 at step 0)
            win_steps = torch.cat([win_stack[:1], win_stack[:-1]], dim=0)
            win_mask = np.zeros((B,), bool)
            win_mask[e2] = self.branch1_crossfeed_power > 0.0
            win_mask[n_edges:] = [w1 for _, _, _, _, w1 in stems]
        else:
            lat0 = torch.cat([self.get_noise(self.seed1), noise2], dim=0)
            cond_fracts = [0.0, 1.0] + fracts
            win_steps = win_mask = None
        cond = self._stack_conditionings(cond_fracts)
        guidance = torch.tensor([self._guidance_at(f) for f in cond_fracts], dtype=torch.float32)

        # edges parent on themselves; edge 2's branch1-crossfeed target is
        # edge 1 at fract 0
        parent_idx = np.zeros((B, 2), np.int64)
        parent_fract = np.zeros((B,), np.float32)
        coeffs = np.zeros((N, B), np.float32)
        pins = np.zeros((B,), np.int64)
        base_by_level: dict[int, np.ndarray] = {}
        for i, (_, prows, pf, level, _) in enumerate(stems):
            r = n_edges + i
            parent_idx[r] = prows
            parent_fract[r] = pf
            if level not in base_by_level:
                base_by_level[level] = np.asarray(parental_crossfeed_coeffs(
                    N, level, self.parental_crossfeed_power, self.parental_crossfeed_range,
                    self.parental_crossfeed_decay,
                ), np.float32)
            coeffs[:, r] = base_by_level[level]
            coeffs[:level, r] = 0.0
            # the pin: fraction 1.0 starts the stem exactly from the parental
            # mix state level-1
            coeffs[level, r] = 1.0
            pins[r] = level
        if self.branch1_crossfeed_power > 0.0:
            coeffs[:, e2] = branch1_crossfeed_coeffs(
                N, self.branch1_crossfeed_power, self.branch1_crossfeed_range, self.branch1_crossfeed_decay,
            )

        with self.timer.phase("denoise"):
            t0 = time.time()
            trajs = self.dh.run_tree_seg_batched(
                cond, lat0, parent_idx, parent_fract, coeffs, guidance, segs,
                win_steps=win_steps, win_mask=win_mask, pin_steps=pins,
            )
            _sync(trajs[-1])
            if self.dh.last_run_was_warm:
                self.dt_unet_step_fused_multi = self._observe(
                    self.dt_unet_step_fused_multi, (time.time() - t0) / row_steps
                )

        # ONE decode pipeline for edges and stems; a recycled edge 1's final
        # latent joins it so its keyframe is rebuilt
        t_out0 = time.time()
        sorted_stems = sorted(range(k_total), key=lambda i: fracts[i])
        finals = trajs[-1][-1] if not recycled1 else torch.cat([win_stack[-1:], trajs[-1][-1]], dim=0)
        off = 1 if recycled1 else 0
        order_rows = [0] + [n_edges + off + i for i in sorted_stems] + [e2 + off]
        with self.timer.phase("vae_decode"):
            pm1_of, chunk_of = self._decode_fetch_chunks(finals, order_rows)

        ends = [i0 for i0, _ in segs[1:]] + [N]

        def row_entries(r: int) -> list:
            """Per-step [1,h,w,4] states of batch row r from its entry step
            on (global step i of segment s is trajs[s][i - i0_s])."""
            return [traj[j, r : r + 1] for (i0, Bs), i1, traj in zip(segs, ends, trajs) if Bs > r
                    for j in range(i1 - i0)]

        self.tree_latents = (
            [list(win_list) if recycled1 else row_entries(0)]
            + [[None] * stems[i][3] + row_entries(n_edges + i) for i in sorted_stems]
            + [row_entries(e2)]
        )
        self.tree_fracts = [0.0] + [fracts[i] for i in sorted_stems] + [1.0]
        self.tree_idx_injection = [0] + [stems[i][3] for i in sorted_stems] + [0]
        self.tree_similarities = list(plan_sims)
        self.tree_final_imgs = [_PendingImage(*chunk_of[row]) for row in order_rows]
        self._imgs_dev = [pm1_of[row] for row in order_rows]
        with self.timer.phase("similarity"):
            self._sims_pending = _fetch(self._dispatch_similarities())
        if self.dh.last_run_was_warm:
            self._dt_fused_output = self._observe(self._dt_fused_output, time.time() - t_out0)
        for idx_injection, k in zip(self.list_idx_injection, self.list_nmb_stems):
            self.last_report.levels.append({"idx_injection": int(idx_injection), "stems": int(k), "fused": True,
                                            "seg": True, "recycled": recycled1})

    def _decode_fetch_chunks(self, finals: torch.Tensor, order_rows: list[int]):
        """Decode → convert → host copy in chunks of LB_FETCH_CHUNK rows, in
        fract (left-to-right) order, so the first keyframes can be consumed
        while later chunks still decode. Returns ({row: pm1_row},
        {row: (handle, index in the chunk)})."""
        csize = _fetch_chunk()
        pm1_of: dict[int, torch.Tensor] = {}
        chunk_of: dict[int, tuple] = {}
        for j0 in range(0, len(order_rows), csize):
            rows = order_rows[j0 : j0 + csize]
            pm1 = self.dh.decode_to_pm1_batched(finals[rows])
            chunk = _fetch(self._fetch_keyframes_u8(pm1))
            for r, row in enumerate(rows):
                pm1_of[row] = pm1[r]
                chunk_of[row] = (chunk, r)
        return pm1_of, chunk_of

    def _i420_fetch_ok(self) -> bool:
        """Whether keyframes can ship as packed I420 planes: opt-out via
        LB_KEYFRAME_I420=0; the packing needs H % 4 == 0 and even W."""
        return (
            os.environ.get("LB_KEYFRAME_I420", "auto") != "0"
            and self.dh.height_img % 4 == 0
            and self.dh.width_img % 2 == 0
        )

    def _fetch_keyframes_u8(self, imgs_pm1: torch.Tensor) -> torch.Tensor:
        """Device-side uint8 keyframe batch in the active fetch format: RGB
        [B,H,W,3] or packed I420 [B,H*3/2,W]."""
        if self._keyframe_fmt == "i420":
            return self.dh.to_i420_device(imgs_pm1)
        return self.dh.to_uint8_device(imgs_pm1)

    def _resolve_keyframes(self, batch_cache: Optional[dict] = None):
        """Materialize every pending keyframe (one host read per shared
        batch; copies already in batch_cache are reused), converting I420
        keyframes so tree_final_imgs is always uint8 RGB."""
        batch_cache = {} if batch_cache is None else batch_cache
        self.tree_final_imgs = [
            to_rgb(resolve_image(im, batch_cache)) if isinstance(im, _PendingImage) else im
            for im in self.tree_final_imgs
        ]

    def _finalize_report(self, sync_sims: bool = True):
        deferred = False
        if self._sims_pending is not None:
            if sync_sims:
                with self.timer.phase("similarity_sync"):
                    self.tree_similarities = np.asarray(self._sims_pending, np.float64).tolist()
            else:
                self.last_report.sims_pending = self._sims_pending
                # this transition's last device op: the next one drains it
                # outside its phase timers
                self._queue_tail = self._sims_pending
                self.tree_similarities = []
                deferred = True
            self._sims_pending = None
        self.last_report.num_keyframes = len(self.tree_final_imgs)
        if not deferred:
            self.last_report.lpips_gaps = [float(s) for s in self.tree_similarities]
        self.last_report.phases = self.timer.summary()
        self.last_report.wall_s = time.time() - self._t_run0

    def compute_latents1(self, return_image: bool = False):
        """First keyframe trajectory (single branch); with return_image its
        uint8 keyframe instead."""
        cond = self.get_mixed_conditioning(0.0)
        self.dh.guidance_scale = self.guidance_scale
        t0 = time.time()
        out = self.dh.run_diffusion(cond, self.get_noise(self.seed1), idx_start=0)
        _sync(out[-1])
        if self.dh.last_run_was_warm:
            sample = (time.time() - t0) / self.num_inference_steps
            self._observe_unet_step(sample)
            self._dt_step_by_batch[1] = self._observe(self._dt_step_by_batch.get(1), sample)
        self.tree_latents[0] = out
        if return_image:
            return self.dh.latent2image(out[-1])
        return out

    def compute_latents2(self, return_image: bool = False):
        """Second keyframe trajectory, crossfed from the first when
        branch1 crossfeed is on; with return_image its uint8 keyframe
        instead."""
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
        if return_image:
            return self.dh.latent2image(out[-1])
        return out

    @torch.no_grad()
    def compute_preview_images(self, seeds: List[int]) -> list:
        """Preview keyframes of prompt1, one per seed, in seed order: ONE
        batched denoise and ONE batched decode (the reference's UI computes
        them one by one). Leaves seed1/seed2 and the tree as they were."""
        if not seeds:
            return []
        lat0 = torch.cat([self.get_noise(int(s)) for s in seeds], dim=0)
        cond = self._stack_conditionings([0.0] * len(seeds))
        g = torch.tensor([self._guidance_at(0.0)] * len(seeds), dtype=torch.float32)
        traj = self.dh.run_diffusion_batched(cond, lat0, idx_start=0, guidance_scale=g)
        return self.dh.latents2images_batched(traj[-1])

    def _compute_edge_latents_batched(self):
        """Both keyframe trajectories as one batch of 2."""
        lat0 = torch.cat([self.get_noise(self.seed1), self.get_noise(self.seed2)], dim=0)
        cond = self._stack_conditionings([0.0, 1.0])
        g = torch.tensor([self._guidance_at(0.0), self._guidance_at(1.0)], dtype=torch.float32)
        N = self.num_inference_steps
        t0 = time.time()
        traj = self.dh.run_diffusion_batched(cond, lat0, idx_start=0, guidance_scale=g)
        _sync(traj)
        if self.dh.last_run_was_warm:
            sample = (time.time() - t0) / (2 * N)
            self._observe_unet_step(sample)
            self._dt_step_by_batch[2] = self._observe(self._dt_step_by_batch.get(2), sample)
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

    def get_mixing_parameters(self, idx_injection: int):
        """The reference's single placement: (fract_mixing, b_parent1,
        b_parent2) of the next branch at idx_injection."""
        return self._plan_placements(1, idx_injection)[0][0]

    def _branch_traj_array(self, b: int) -> torch.Tensor:
        """Tree branch b as a stacked [N, h, w, 4] tensor (None steps → zeros)."""
        entries = self.tree_latents[b]
        zero = torch.zeros_like(entries[-1][0])
        return torch.stack([zero if e is None else e[0] for e in entries[: self.num_inference_steps]], dim=0)

    def _stem_trajectories(self, placements: list, idx_injection: int, cond, guidance: torch.Tensor) -> torch.Tensor:
        """The denoised trajectories [N - idx_injection, k, h, w, 4] of k
        stems placed at (fract_mixing, b_parent1, b_parent2): their
        parents' trajectories slerped per step (K1), each stem started from
        the mix at idx_injection - 1 and crossfed towards it after, under
        the stems' conditioning and guidance."""
        p1 = torch.stack([self._branch_traj_array(b1) for _, b1, _ in placements], dim=1)
        p2 = torch.stack([self._branch_traj_array(b2) for _, _, b2 in placements], dim=1)
        fract_parental = torch.tensor(
            [(f - self.tree_fracts[b1]) / (self.tree_fracts[b2] - self.tree_fracts[b1]) for f, b1, b2 in placements],
            dtype=torch.float32,
        )
        mix_traj = _parental_mix(p1, p2, fract_parental)  # [N, k, h, w, 4]
        coeffs = parental_crossfeed_coeffs(
            self.num_inference_steps, idx_injection, self.parental_crossfeed_power, self.parental_crossfeed_range,
            self.parental_crossfeed_decay,
        )
        return self.dh.run_diffusion_batched(
            cond, mix_traj[idx_injection - 1], idx_start=idx_injection, mix_traj=mix_traj, mixing_coeffs=coeffs,
            guidance_scale=guidance,
        )

    def _run_stem_round(self, k: int, idx_injection: int, defer_sims: bool = False, predicted: bool = False,
                        sync: bool = True):
        """Plan, compute and insert k sibling stems as one batched denoise +
        decode + similarity round. With defer_sims the gap-similarity pass
        is dispatched but left in flight (_sims_pending): only valid for the
        final round, whose similarities no placement consumes.

        predicted (the predictive policy): the gap similarities become the
        planner's predicted values instead of a measurement; with
        sync=False the round only dispatches (no host wait, no step-cost
        sample: its wall would not be its own)."""
        N = self.num_inference_steps
        placements, plan_sims = self._plan_placements(k, idx_injection)
        cond = self._stack_conditionings([f for f, _, _ in placements])
        guidance = torch.tensor([self._guidance_at(f) for f, _, _ in placements], dtype=torch.float32)
        with self.timer.phase("denoise"):
            t0 = time.time()
            traj = self._stem_trajectories(placements, idx_injection, cond, guidance)
            if sync:
                _sync(traj)
                if self.dh.last_run_was_warm and not predicted:
                    # observed per-(row,step) cost at THIS batch size; under
                    # the predictive policy the final sync drains every
                    # chained round, so its wall is not this round's cost
                    self._dt_step_by_batch[k] = self._observe(
                        self._dt_step_by_batch.get(k), (time.time() - t0) / ((N - idx_injection) * k)
                    )
        order = sorted(range(k), key=lambda i: placements[i][0])
        with self.timer.phase("vae_decode"):
            imgs_pm1 = self.dh.decode_to_pm1_batched(traj[-1])
            u8_dev = self._fetch_keyframes_u8(imgs_pm1)
            # host copies in chunks ordered by fract
            csize = _fetch_chunk()
            chunk_of: dict[int, tuple] = {}
            for j0 in range(0, k, csize):
                rows = order[j0 : j0 + csize]
                chunk = _fetch(u8_dev if rows == list(range(k)) else u8_dev[rows])
                for r, i in enumerate(rows):
                    chunk_of[i] = (chunk, r)
        M = N - idx_injection
        with self.timer.phase("similarity"):
            for i in order:
                fract_mixing = placements[i][0]
                b_parent1, _ = get_closest_idx(fract_mixing, self.tree_fracts)
                idx_insert = b_parent1 + 1
                self.tree_latents.insert(idx_insert, [None] * idx_injection + [traj[j, i : i + 1] for j in range(M)])
                self.tree_final_imgs.insert(idx_insert, _PendingImage(*chunk_of[i]))
                self._imgs_dev.insert(idx_insert, imgs_pm1[i])
                self.tree_fracts.insert(idx_insert, fract_mixing)
                self.tree_idx_injection.insert(idx_insert, idx_injection)
            if predicted:
                # the planner's post-insert predicted gap values, wholesale
                self.tree_similarities = list(plan_sims)
            if defer_sims:
                self._sims_pending = _fetch(self._dispatch_similarities())
            elif not predicted:
                self.tree_similarities = self._batched_similarities()

    def insert_into_tree(self, fract_mixing: float, idx_injection: int, list_latents: list, img_insert=None):
        """The reference's single-branch insert: decode the branch's last
        latent (unless img_insert, a uint8 keyframe, is given), score it
        against its two neighbours and insert it in fract order. The
        device keyframes (_imgs_dev) take it only while they are aligned
        with tree_final_imgs; otherwise they are dropped, and
        get_tree_similarities scores the host keyframes."""
        if img_insert is None:
            img_insert = self.dh.latent2image(list_latents[-1])
        b_parent1, b_parent2 = get_closest_idx(fract_mixing, self.tree_fracts)
        left_sim = self.get_lpips_similarity(img_insert, self.tree_final_imgs[b_parent1])
        right_sim = self.get_lpips_similarity(img_insert, self.tree_final_imgs[b_parent2])
        idx_insert = b_parent1 + 1
        self.tree_latents.insert(idx_insert, list_latents)
        self.tree_final_imgs.insert(idx_insert, img_insert)
        if len(self._imgs_dev) == len(self.tree_final_imgs) - 1:
            self._imgs_dev.insert(idx_insert, self.lpips._prep(img_insert, self.dh.device)[0])
        else:
            self._imgs_dev = []
        self.tree_fracts.insert(idx_insert, fract_mixing)
        self.tree_idx_injection.insert(idx_insert, idx_injection)
        self.tree_similarities[b_parent1] = left_sim
        self.tree_similarities.insert(idx_insert, right_sim)

    @torch.no_grad()
    def compute_latents_mix(self, fract_mixing: float, b_parent1: int, b_parent2: int, idx_injection: int) -> list:
        """The reference's single-branch trajectory at fract_mixing: its
        parents' trajectories slerped per step (K1), the branch started
        from the mix at idx_injection - 1 and crossfed towards the mix
        after; the engine's current guidance (set_guidance_mid_dampening).
        Returns the full-length list, None before idx_injection."""
        cond = self.dh._conditioning(self.get_mixed_conditioning(fract_mixing), 1)
        traj = self._stem_trajectories([(fract_mixing, b_parent1, b_parent2)], idx_injection, cond,
                                       torch.tensor([self.guidance_scale], dtype=torch.float32))
        return [None] * idx_injection + list(traj)

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

    def get_text_embeddings(self, prompt: str):
        return self.dh.get_text_embedding(prompt)

    def run_diffusion(self, list_conditionings, latents_start=None, idx_start: int = 0, list_latents_mixing=None,
                      mixing_coeffs=0.0, return_image: bool = False):
        """The reference's engine-level denoise: the holder's run_diffusion
        at the engine's step count and current guidance."""
        self.dh.set_num_inference_steps(self.num_inference_steps)
        self.dh.guidance_scale = self.guidance_scale
        te = list_conditionings[0] if isinstance(list_conditionings, list) else list_conditionings
        return self.dh.run_diffusion(te, latents_start, idx_start=idx_start, list_latents_mixing=list_latents_mixing,
                                     mixing_coeffs=mixing_coeffs, return_image=return_image)

    # ---------------------------------------------------------------- output

    def write_imgs_transition(self, dp_img: str):
        """The keyframes as lowres_img_NNNN.jpg (quality 75, 4:2:0: PIL's
        defaults, which the JAX package writes with), encoded on the
        holder's device (video/jpeg.encode_rgb: J1's RGB route and J3), and
        the engine's settings as lowres.yaml."""
        from latentblending_tpu_torch.video.jpeg import encode_rgb
        from latentblending_tpu_torch.yaml_text import yml_save

        os.makedirs(dp_img, exist_ok=True)
        if self.tree_final_imgs:
            frames = torch.stack([torch.as_tensor(np.asarray(im)) for im in self.tree_final_imgs])
            for i, data in enumerate(encode_rgb(frames.to(self.dh.device), quality=75)):
                with open(os.path.join(dp_img, f"lowres_img_{str(i).zfill(4)}.jpg"), "wb") as f:
                    f.write(data)
        yml_save(os.path.join(dp_img, "lowres.yaml"), self.get_state_dict())

    def _movie_saver(self, fp_movie: str, fps: int):
        from latentblending_tpu_torch.video.writer import MovieSaver

        return MovieSaver(fp_movie, fps=fps, shape_hw=(self.dh.height_img, self.dh.width_img), device=self.dh.device)

    def write_movie_transition(self, fp_movie: str, duration_transition: float, fps: int = 30):
        """Write the movie of the current tree: its keyframes filled up to
        fps × duration frames (video/writer.write_frames_interp, on the
        holder's device). LB_DEVICE_FILLUP=1 lerps all frames on the device
        first and encodes them as frames."""
        from latentblending_tpu_torch.video.frames import add_frames_linear_interp_device
        from latentblending_tpu_torch.video.writer import write_frames, write_frames_interp

        target = int(round(fps * duration_transition))
        ms = self._movie_saver(fp_movie, fps)
        if os.environ.get("LB_DEVICE_FILLUP") == "1":
            write_frames(ms, add_frames_linear_interp_device(self.tree_final_imgs, target, self.dh.device))
        else:
            write_frames_interp(ms, self.tree_final_imgs, target)
        ms.finalize()
        self.note_writer(ms)
        log.info(f"wrote {ms.nmb_frames} frames to {fp_movie}")

    def run_movie_transition(self, fp_movie: str, duration_transition: float, fps: int = 30,
                             recycle_img1: Optional[bool] = False, recycle_img2: Optional[bool] = False,
                             fixed_seeds: Optional[List[int]] = None) -> list:
        """The transition and its movie in one call: the writer starts on
        the first keyframe while later keyframes' device→host copies and
        the last round's similarity pass are still in flight. Keyframes
        ship as packed I420 planes (half the bytes; the encoder takes the
        planes) unless LB_KEYFRAME_I420=0 or LB_DEVICE_FILLUP=1. Returns
        the keyframe list like run_transition."""
        from latentblending_tpu_torch.video.frames import add_frames_linear_interp_device
        from latentblending_tpu_torch.video.writer import write_frames, write_frames_interp

        device_fillup = os.environ.get("LB_DEVICE_FILLUP") == "1"
        self._keyframe_fmt = "i420" if (not device_fillup and self._i420_fetch_ok()) else "rgb"
        try:
            self._run_transition_core(recycle_img1, recycle_img2, fixed_seeds)
        finally:
            self._keyframe_fmt = "rgb"
        target = int(round(fps * duration_transition))
        batch_cache: dict = {}

        def resolve(im):
            with self.timer.phase("keyframe_fetch"):
                return resolve_image(im, batch_cache)

        with self.timer.phase("movie_write"):
            ms = self._movie_saver(fp_movie, fps)
            if device_fillup:
                self._resolve_keyframes(batch_cache)
                write_frames(ms, add_frames_linear_interp_device(self.tree_final_imgs, target, self.dh.device))
            else:
                write_frames_interp(ms, self.tree_final_imgs, target, resolve=resolve)
            ms.finalize()
        self.note_writer(ms)
        log.info(f"wrote {ms.nmb_frames} frames to {fp_movie}")
        self._resolve_keyframes(batch_cache)
        self._finalize_report()
        return self.tree_final_imgs

    def note_writer(self, ms) -> None:
        """Record which movie backend ran ("mjpeg", "+coef-lerp" when the
        coefficient lerp made the in-between frames) and the settled JPEG
        quality. Callers that own their MovieSaver (engine/session.py) call
        this after finalize."""
        backend = getattr(ms, "backend", None)
        if backend and getattr(ms, "used_coef_lerp", False):
            backend += "+coef-lerp"
        self.last_writer_backend = backend
        self.last_jpeg_quality = getattr(ms, "jpeg_quality", None)

    _note_writer = note_writer  # back-compat alias

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

    def get_lpips_similarity(self, imgA, imgB) -> float:
        """The gap metric between two uint8 keyframes, on the holder's device."""
        return self.lpips.distance(imgA, imgB)

    def get_closest_idx(self, fract_mixing: float):
        return get_closest_idx(fract_mixing, self.tree_fracts)

    def get_tree_similarities(self) -> list[float]:
        """Every adjacent-keyframe distance: from the device keyframes when
        they are aligned with tree_final_imgs, else from the host ones."""
        if len(self._imgs_dev) == len(self.tree_final_imgs) and len(self._imgs_dev) >= 2:
            return self._batched_similarities()
        if len(self.tree_final_imgs) < 2:
            return []
        imgs = self.lpips._prep(np.stack([np.asarray(im) for im in self.tree_final_imgs]), self.dh.device)
        return self.lpips.distance_batch(imgs[:-1], imgs[1:]).double().cpu().tolist()

    def _dispatch_similarities(self) -> Optional[torch.Tensor]:
        """All adjacent-keyframe distances (the engine's metric) as one
        batched call, left on the device ([K-1]); None with fewer than 2
        keyframes."""
        if len(self._imgs_dev) < 2:
            return None
        return self.lpips.distance_batch(torch.stack(self._imgs_dev[:-1]), torch.stack(self._imgs_dev[1:]))

    def _batched_similarities(self) -> list[float]:
        """All adjacent-keyframe distances, on the host."""
        d = self._dispatch_similarities()
        return [] if d is None else d.double().cpu().tolist()
