"""The sampler and the latent-blending tree rules, written from their
published descriptions: diffusers' EulerDiscreteScheduler and
EulerAncestralDiscreteScheduler (epsilon prediction, scaled_linear betas,
"leading" and "trailing" spacing), and the latent blending engine of
lunarring/latentblending (slerp, crossfeed schedules, guidance dampening,
placement of stems by bisecting the gap with the largest distance).
"""
from __future__ import annotations

import numpy as np
import torch

# the scheduler classes the reference replays: class -> ancestral
SAMPLERS = {"EulerDiscreteScheduler": False, "EulerAncestralDiscreteScheduler": True}


def is_ancestral(sched: dict) -> bool:
    """Whether the configuration's scheduler draws noise each step; refuses
    a scheduler the reference does not replay."""
    if sched["_class_name"] not in SAMPLERS or sched.get("prediction_type", "epsilon") != "epsilon" or (
            sched.get("beta_schedule", "scaled_linear") != "scaled_linear" or sched.get("use_karras_sigmas")):
        raise ValueError(f"the reference has no sampler for {sched}")
    return SAMPLERS[sched["_class_name"]]


def schedule(sched: dict, n: int) -> tuple[np.ndarray, np.ndarray, float]:
    """(timesteps [n], sigmas [n+1] with a terminal 0, init_noise_sigma)."""
    T = sched["num_train_timesteps"]
    if sched["timestep_spacing"] == "leading":
        t = (np.arange(n, dtype=np.float64) * (T // n)).round()[::-1] + sched["steps_offset"]
    elif sched["timestep_spacing"] == "trailing":
        t = np.round(np.arange(T, 0, -T / n, dtype=np.float64)) - 1
    else:
        raise ValueError(sched["timestep_spacing"])
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, T, dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    train = np.sqrt((1.0 - ac) / ac)
    sig = np.concatenate([np.interp(t, np.arange(T, dtype=np.float64), train), [0.0]])
    init = sig.max() if sched["timestep_spacing"] == "trailing" else (sig.max() ** 2 + 1.0) ** 0.5
    return t, sig, float(init)


def euler_step(x, eps, sigma: float, sigma_next: float, noise=None):
    """x + eps (sigma_down - sigma) + z sigma_up; sigma_down = sigma_next and
    sigma_up = 0 for plain Euler (noise None)."""
    if noise is None:
        return x + eps * (sigma_next - sigma)
    up2 = sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2
    up = max(up2, 0.0) ** 0.5
    down = max(sigma_next ** 2 - up2, 0.0) ** 0.5
    return x + eps * (down - sigma) + noise * up


def slerp(a: torch.Tensor, b: torch.Tensor, fract) -> torch.Tensor:
    """Spherical interpolation per row of [B, ...] (each row one flat vector),
    cosine clamped to ±(1 - 1e-7); fract a float or [B]."""
    red = tuple(range(1, a.ndim))
    dot = (a * b).sum(red) / torch.sqrt((a * a).sum(red) * (b * b).sum(red)).clamp(min=1e-20)
    theta = torch.arccos(dot.clamp(-1 + 1e-7, 1 - 1e-7))
    f = torch.as_tensor(fract, dtype=a.dtype, device=a.device)
    s0 = torch.sin(theta - theta * f) / torch.sin(theta)
    s1 = torch.sin(theta * f) / torch.sin(theta)
    shape = (-1,) + (1,) * (a.ndim - 1)
    return a * s0.reshape(shape) + b * s1.reshape(shape)


def parental_crossfeed(n: int, idx: int, power: float, range_: float, decay: float) -> list[float]:
    """Crossfeed of a stem toward its parental mix at each step: `power`
    until the injection step, then a linear decay to power*decay until step
    round(n*range), then 0."""
    stop = int(round(n * range_))
    c = [power] * idx
    if stop - idx > 0:
        c += np.linspace(power, power * decay, stop - idx).tolist()
    c += [0.0] * (n - len(c))
    return c[:n]


def guidance_at(fract: float, base: float, damper: float) -> float:
    """Guidance lowered linearly toward the middle of the transition."""
    return base - (base * (1.0 - damper) - 1.0) * (1.0 - abs(fract - 0.5) / 0.5)


def bracket(f: float, fracts: list[float]) -> tuple[int, int]:
    """The two adjacent tree positions around f (a hit at fracts[k] gives (k, k+1))."""
    hi = int(np.searchsorted(np.asarray(fracts), f, side="right"))
    hi = min(max(hi, 1), len(fracts) - 1)
    return hi - 1, hi


def place(k: int, fracts: list[float], sims: list[float]) -> tuple[list[float], list[float]]:
    """k new fractions, each the middle of the gap with the largest distance
    (the first on a tie), a split gap counted at half its distance; and the
    gap distances so predicted for the tree with the k inserted."""
    fr, s, out = list(fracts), list(sims), []
    for _ in range(k):
        g = int(np.argmax(s))
        m = (fr[g] + fr[g + 1]) / 2.0
        out.append(m)
        s[g:g + 1] = [s[g] * 0.5, s[g] * 0.5]
        fr.insert(g + 1, m)
    return out, s


def placement_regret(k: int, fracts: list[float], sims: list[float], chosen: list[float]) -> float:
    """How far a level's chosen fractions fall short of the rule on these
    gap distances: at each pick the largest gap distance minus that of the
    gap a chosen fraction splits, over the largest; the worst pick. 1.0 when
    a chosen fraction is not the middle of any gap."""
    fr, s, left, worst = list(fracts), list(sims), list(chosen), 0.0
    if len(chosen) != k:
        return 1.0
    for _ in range(k):
        mids = {(fr[g] + fr[g + 1]) / 2.0: g for g in range(len(s))}
        cand = [(s[mids[m]], m) for m in left if m in mids]
        if not cand:
            return 1.0
        best = max(s)
        val, m = max(cand)
        worst = max(worst, (best - val) / best if best > 0 else 0.0)
        g = mids[m]
        left.remove(m)
        s[g:g + 1] = [s[g] * 0.5, s[g] * 0.5]
        fr.insert(g + 1, m)
    return worst
