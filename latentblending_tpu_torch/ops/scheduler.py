"""Euler-discrete noise scheduler (SDXL / SDXL-Turbo), in PyTorch.

Counterpart of latentblending_tpu/ops/scheduler.py. The σ tables
(make_schedule) are host numpy and copied unchanged; the per-step solver
math below works on torch tensors, in float32 whatever the latent dtype.
The JAX module's notes follow.

The reference delegates to diffusers' EulerDiscreteScheduler
(diffusers_holder.py:42,53,330,356). We re-derive the same σ-schedule so
latent trajectories match:

- betas: scaled_linear, β0=0.00085, β1=0.012, 1000 train steps
- σ_t  = sqrt((1-ᾱ_t)/ᾱ_t), linear interpolation onto the chosen timesteps
- timestep_spacing: "leading" (+steps_offset=1) for SDXL-base,
  "trailing" for SDXL-Turbo (their scheduler_config.json values)
- prediction_type: epsilon
- scale_model_input: x / sqrt(σ²+1)
- step: x_{t-1} = x_t + ε̂ · (σ_{t-1} − σ_t)
- init_noise_sigma: σ_max for trailing/linspace, sqrt(σ_max²+1) for leading

The σ table is computed on host in float64 and shipped to the device as a
small float32 vector; the per-step math runs in the denoise loop
(runtime/denoise.py).

SD3's FlowMatchEulerDiscreteScheduler (`FlowMatchSchedulerConfig`,
scheduler type "flow_euler") shares the step: the model predicts the
velocity v and x_{t-1} = x_t + v · (σ_{t-1} − σ_t), `euler_step`'s own
update. Its table (make_flow_schedule) is diffusers' set_timesteps:
σ = linspace(1, σ_min, N) with σ_min the shifted 1/T, then
σ ← s·σ / (1 + (s − 1)·σ), t = T·σ, a terminal 0; no input scaling and an
initial noise σ of 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    timestep_spacing: str = "leading"  # "leading" | "trailing" | "linspace"
    steps_offset: int = 1
    prediction_type: str = "epsilon"
    # "euler" (EulerDiscreteScheduler) | "euler_ancestral"
    # (EulerAncestralDiscreteScheduler). The reference is scheduler-agnostic —
    # it drives whatever the checkpoint ships (diffusers_holder.py:330,:356);
    # stable-diffusion-xl-base-1.0 ships Euler, sdxl-turbo ships
    # EulerAncestral (their scheduler_config.json _class_name).
    scheduler_type: str = "euler"


SDXL_BASE_SCHEDULER = SchedulerConfig(timestep_spacing="leading", steps_offset=1)
SDXL_TURBO_SCHEDULER = SchedulerConfig(
    timestep_spacing="trailing", steps_offset=1, scheduler_type="euler_ancestral"
)
# the pre-round-2 turbo default (deterministic Euler on the turbo spacing) —
# still selectable for ablation
SDXL_TURBO_EULER_SCHEDULER = SchedulerConfig(timestep_spacing="trailing", steps_offset=1)

@dataclasses.dataclass(frozen=True)
class FlowMatchSchedulerConfig:
    """diffusers' FlowMatchEulerDiscreteScheduler with a static shift."""

    num_train_timesteps: int = 1000
    shift: float = 3.0
    scheduler_type: str = "flow_euler"


SD3_SCHEDULER = FlowMatchSchedulerConfig()

_CLASS_NAME_TO_TYPE = {
    "EulerDiscreteScheduler": "euler",
    "EulerAncestralDiscreteScheduler": "euler_ancestral",
    # approximated by our σ-space DPM-Solver++(2M) (diffusers' default
    # algorithm_type for SD checkpoints is dpmsolver++, solver_order 2)
    "DPMSolverMultistepScheduler": "dpmpp_2m",
}


def scheduler_config_from_hf(cfg_json: dict, default: "SchedulerConfig") -> "SchedulerConfig":
    """Build a SchedulerConfig from a checkpoint's scheduler_config.json —
    the reference's behavior is defined by this file, not by code."""
    cls = cfg_json.get("_class_name", "")
    if cls == "FlowMatchEulerDiscreteScheduler":
        return _flow_config_from_hf(cfg_json)
    stype = _CLASS_NAME_TO_TYPE.get(cls)
    pred = str(cfg_json.get("prediction_type", "epsilon"))
    if pred != "epsilon":
        # every solver here applies the epsilon update; loading a
        # v_prediction/sample checkpoint would silently generate garbage
        raise NotImplementedError(
            f"prediction_type={pred!r} is not supported (epsilon only); "
            f"checkpoint scheduler: {cls or '<unknown>'}"
        )
    # same guard philosophy for the σ-table knobs: the tables below are
    # hard-coded scaled_linear/non-Karras — a checkpoint shipping anything
    # else would load onto a silently-wrong trajectory
    beta_schedule = str(cfg_json.get("beta_schedule", "scaled_linear"))
    if beta_schedule != "scaled_linear":
        raise NotImplementedError(
            f"beta_schedule={beta_schedule!r} is not supported (scaled_linear only); "
            f"checkpoint scheduler: {cls or '<unknown>'}"
        )
    if cfg_json.get("use_karras_sigmas"):
        raise NotImplementedError(
            "use_karras_sigmas=true is not supported (the σ table is the "
            f"scaled_linear train grid); checkpoint scheduler: {cls or '<unknown>'}"
        )
    if stype is None:
        # unknown scheduler class → keep the spec default, which matches the
        # reference family's shipped configs
        return default
    return SchedulerConfig(
        num_train_timesteps=int(cfg_json.get("num_train_timesteps", 1000)),
        beta_start=float(cfg_json.get("beta_start", 0.00085)),
        beta_end=float(cfg_json.get("beta_end", 0.012)),
        timestep_spacing=str(cfg_json.get("timestep_spacing", default.timestep_spacing)),
        steps_offset=int(cfg_json.get("steps_offset", 1)),
        prediction_type=str(cfg_json.get("prediction_type", "epsilon")),
        scheduler_type=stype,
    )


def _flow_config_from_hf(cfg_json: dict) -> FlowMatchSchedulerConfig:
    """A FlowMatchEulerDiscreteScheduler config; the knobs that would change
    the σ table away from a static shift are refused."""
    for key in ("use_dynamic_shifting", "use_karras_sigmas", "use_exponential_sigmas", "use_beta_sigmas",
                "invert_sigmas", "stochastic_sampling"):
        if cfg_json.get(key):
            raise NotImplementedError(f"FlowMatchEulerDiscreteScheduler with {key}=true is not supported")
    if cfg_json.get("shift_terminal"):
        raise NotImplementedError("FlowMatchEulerDiscreteScheduler with shift_terminal is not supported")
    return FlowMatchSchedulerConfig(num_train_timesteps=int(cfg_json.get("num_train_timesteps", 1000)),
                                    shift=float(cfg_json.get("shift", 1.0)))


def _training_sigmas(cfg: SchedulerConfig) -> np.ndarray:
    betas = (
        np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_timesteps, dtype=np.float64)
        ** 2
    )
    alphas_cumprod = np.cumprod(1.0 - betas)
    return np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)


@dataclasses.dataclass(frozen=True)
class SchedulerState:
    """Immutable per-(config, num_steps) schedule tables.

    sigmas has length num_steps+1 (terminal 0 appended); timesteps length
    num_steps, descending.
    """

    config: SchedulerConfig
    num_steps: int
    timesteps: np.ndarray  # float32 [N]
    sigmas: np.ndarray  # float32 [N+1]

    @property
    def init_noise_sigma(self) -> float:
        if isinstance(self.config, FlowMatchSchedulerConfig):
            return 1.0
        if self.config.timestep_spacing in ("linspace", "trailing"):
            return float(self.sigmas.max())
        return float((self.sigmas.max() ** 2 + 1.0) ** 0.5)


def make_flow_schedule(cfg: FlowMatchSchedulerConfig, num_steps: int) -> SchedulerState:
    """FlowMatchEulerDiscreteScheduler.set_timesteps with a static shift s:
    σ = linspace(σ_max, σ_min, N) between the ends of the shifted training
    grid (σ_max = 1, σ_min = s/T / (1 + (s-1)/T)), then shifted once more,
    σ ← s·σ / (1 + (s-1)·σ), as diffusers does; timesteps T·σ; a terminal 0."""
    T, s = cfg.num_train_timesteps, cfg.shift

    def shifted(x):
        return s * x / (1.0 + (s - 1.0) * x)

    sigmas = shifted(np.linspace(shifted(1.0), shifted(1.0 / T), num_steps, dtype=np.float64)).astype(np.float32)
    return SchedulerState(
        config=cfg,
        num_steps=num_steps,
        timesteps=sigmas * np.float32(T),
        sigmas=np.concatenate([sigmas, np.zeros(1, np.float32)]),
    )


def make_schedule(cfg, num_steps: int) -> SchedulerState:
    """Equivalent of the scheduler's set_timesteps: EulerDiscreteScheduler
    for SDXL configs, FlowMatchEulerDiscreteScheduler for SD3's."""
    if isinstance(cfg, FlowMatchSchedulerConfig):
        return make_flow_schedule(cfg, num_steps)
    T = cfg.num_train_timesteps
    if cfg.timestep_spacing == "linspace":
        timesteps = np.linspace(0, T - 1, num_steps, dtype=np.float64)[::-1].copy()
    elif cfg.timestep_spacing == "leading":
        step_ratio = T // num_steps
        timesteps = (np.arange(num_steps, dtype=np.float64) * step_ratio).round()[::-1].copy()
        timesteps += cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = T / num_steps
        timesteps = np.round(np.arange(T, 0, -step_ratio, dtype=np.float64)).copy()
        timesteps -= 1
    else:
        raise ValueError(f"unknown timestep_spacing {cfg.timestep_spacing}")

    train_sigmas = _training_sigmas(cfg)
    sigmas = np.interp(timesteps, np.arange(T, dtype=np.float64), train_sigmas)
    sigmas = np.concatenate([sigmas, [0.0]])
    return SchedulerState(
        config=cfg,
        num_steps=num_steps,
        timesteps=timesteps.astype(np.float32),
        sigmas=sigmas.astype(np.float32),
    )


def scale_model_input(sample: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """x / sqrt(σ²+1) — Karras-style input scaling for the epsilon UNet."""
    return (sample.float() / torch.sqrt(sigma.float() ** 2 + 1.0)).to(sample.dtype)


def euler_step(
    sample: torch.Tensor, model_output: torch.Tensor, sigma: torch.Tensor, sigma_next: torch.Tensor
) -> torch.Tensor:
    """One Euler step, epsilon prediction: x + ε̂·(σ_next − σ), in float32."""
    out = sample.float() + model_output.float() * (sigma_next.float() - sigma.float())
    return out.to(sample.dtype)


def ancestral_sigmas(sigma: torch.Tensor, sigma_next: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(σ_up, σ_down) of EulerAncestralDiscreteScheduler.step:

      σ_up²  = σ_next² · (σ² − σ_next²) / σ²
      σ_down = sqrt(σ_next² − σ_up²)

    σ_next = 0 (the terminal step) yields σ_up = 0, σ_down = 0.
    """
    s2 = sigma.float() ** 2
    sn2 = sigma_next.float() ** 2
    up2 = sn2 * (s2 - sn2) / torch.clamp(s2, min=1e-20)
    sigma_up = torch.sqrt(torch.clamp(up2, min=0.0))
    sigma_down = torch.sqrt(torch.clamp(sn2 - up2, min=0.0))
    return sigma_up, sigma_down


def dpmpp_2m_step(
    sample: torch.Tensor,  # x_i (σ-space state)
    denoised: torch.Tensor,  # x0 prediction at step i, float32
    old_denoised: torch.Tensor,  # x0 prediction at step i-1, float32
    sigma_prev: torch.Tensor,
    sigma: torch.Tensor,
    sigma_next: torch.Tensor,
    use_second,  # bool, or a bool tensor broadcastable to sample (per row)
) -> torch.Tensor:
    """One DPM-Solver++(2M) update in σ-space (Lu et al. 2023,
    arXiv:2211.01095, as in k-diffusion's sample_dpmpp_2m):

      t(σ) = −ln σ,  h = t(σ_next) − t(σ),  r = (t(σ) − t(σ_prev)) / h
      D = (1 + 1/2r)·x0_i − (1/2r)·x0_{i-1}          (2nd order)
      x_next = (σ_next/σ)·x − expm1(−h)·D

    The first executed step and the terminal σ_next = 0 step use the
    1st-order update (D = x0_i). A tensor `use_second` selects the order
    per element (the fused tree scan gates it per row by pin step)."""
    x = sample.float()
    s = sigma.float()
    sn = sigma_next.float()
    sp = sigma_prev.float()
    ratio = sn / s
    h = torch.log(s) - torch.log(torch.clamp(sn, min=1e-20))
    ema = -torch.expm1(-h)
    h_last = torch.log(sp) - torch.log(s)
    r = h_last / torch.clamp(h, min=1e-20)
    coeff = 1.0 / torch.clamp(2.0 * r, min=1e-20)
    if isinstance(use_second, torch.Tensor):
        d = torch.where(use_second, (1.0 + coeff) * denoised - coeff * old_denoised, denoised)
    else:
        d = (1.0 + coeff) * denoised - coeff * old_denoised if use_second else denoised
    return (ratio * x + ema * d).to(sample.dtype)


def euler_ancestral_step(
    sample: torch.Tensor,
    model_output: torch.Tensor,
    sigma: torch.Tensor,
    sigma_next: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """One Euler-ancestral step, epsilon prediction:
    x + ε̂·(σ_down − σ) + z·σ_up with a caller-supplied draw z ~ N(0,1)."""
    sigma_up, sigma_down = ancestral_sigmas(sigma, sigma_next)
    out = sample.float() + model_output.float() * (sigma_down - sigma.float()) + noise.float() * sigma_up
    return out.to(sample.dtype)
