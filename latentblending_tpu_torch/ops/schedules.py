"""Host-side schedule math: crossfeed coefficients, guidance dampening,
branch planners, tree helpers.

These are tiny numpy computations that steer the on-device work; they
reproduce the reference's observable schedules exactly (citations inline)
while fixing its latent bugs (SURVEY.md §3.6).
"""
from __future__ import annotations

import numpy as np


def branch1_crossfeed_coeffs(num_steps: int, power: float, range_: float, decay: float) -> np.ndarray:
    """Crossfeed coefficients for branch-2's trajectory toward branch-1.

    Reference: blending_engine.py:406-408 — linspace(power, power*decay)
    over round(num_steps*range) steps, zero-padded to num_steps.
    """
    idx_stop = int(round(num_steps * range_))
    coeffs = np.zeros(num_steps, dtype=np.float32)
    if power > 0.0 and idx_stop > 0:
        coeffs[:idx_stop] = np.linspace(power, power * decay, idx_stop, dtype=np.float32)
    return coeffs


def parental_crossfeed_coeffs(
    num_steps: int, idx_injection: int, power: float, range_: float, decay: float
) -> np.ndarray:
    """Crossfeed coefficients for a mid-tree branch toward its parental mix.

    Reference: blending_engine.py:452-457 — constant `power` for the first
    idx_injection steps (those are skipped anyway), then a linspace decay
    until round(num_steps*range), then zeros.
    """
    idx_stop = int(round(num_steps * range_))
    coeffs = [power] * idx_injection
    nmb_mixing = idx_stop - idx_injection
    if nmb_mixing > 0:
        coeffs.extend(np.linspace(power, power * decay, nmb_mixing).tolist())
    coeffs.extend([0.0] * (num_steps - len(coeffs)))
    return np.asarray(coeffs[:num_steps], dtype=np.float32)


def guidance_mid_dampening(
    fract_mixing: float, guidance_scale_base: float, mid_damper: float
) -> float:
    """Linear dip of guidance scale toward the middle of the transition.

    Reference: blending_engine.py:155-164.
    """
    mid_factor = 1.0 - abs(fract_mixing - 0.5) / 0.5
    max_guidance_reduction = guidance_scale_base * (1.0 - mid_damper) - 1.0
    return float(guidance_scale_base - max_guidance_reduction * mid_factor)


def turbo_branching_plan(
    num_steps: int, depth_strength: float | None, nmb_max_branches: int | None
) -> tuple[list[int], list[int]]:
    """SDXL-Turbo branching: one injection level.

    Reference: blending_engine.py:273-283. Injection depth is clamped to
    [1, num_steps-1]: depth 0 has no parental state to start from (the
    reference crashes there too — negative indexing in get_mixing_parameters).
    """
    idx_inject = int(round(num_steps * depth_strength)) if depth_strength is not None else 2
    idx_inject = int(np.clip(idx_inject, 1, num_steps - 1))
    if nmb_max_branches is None:
        nmb_max_branches = 10
    return [idx_inject], [nmb_max_branches]


def time_based_branching_plan(
    num_steps: int,
    depth_strength: float,
    dt_unet_step: float,
    dt_vae: float,
    t_compute_max_allowed: float | None = None,
    nmb_max_branches: int | None = None,
) -> tuple[list[int], list[int]]:
    """Greedy compute-budget planner for SDXL-base.

    Exact re-derivation of reference blending_engine.py:467-529 including the
    undersample path (:521-524). Cost model (:504-507):
      t = Σ(steps/branch)·dt_unet_step + n_branches·dt_vae
          + 2·(N·dt_unet_step + dt_vae)
    """
    idx_injection_base = max(1, int(np.floor(num_steps * depth_strength)))
    steps = int(np.ceil(num_steps / 10))
    list_idx_injection = np.arange(idx_injection_base, num_steps, steps)
    list_nmb_stems = np.ones(len(list_idx_injection), dtype=np.int32)

    if nmb_max_branches is None:
        if t_compute_max_allowed is None:
            raise ValueError("Either specify t_compute_max_allowed or nmb_max_branches")
        stop_criterion = "t_compute_max_allowed"
    elif t_compute_max_allowed is None:
        stop_criterion = "nmb_max_branches"
        nmb_max_branches -= 2  # discount the two outer branches
    else:
        raise ValueError("Either specify t_compute_max_allowed or nmb_max_branches")

    stop = False
    is_first_iteration = True
    while not stop:
        list_compute_steps = (num_steps - list_idx_injection) * list_nmb_stems
        t_compute = (
            np.sum(list_compute_steps) * dt_unet_step
            + dt_vae * np.sum(list_nmb_stems)
            + 2 * (num_steps * dt_unet_step + dt_vae)
        )
        increase_done = False
        for s_idx in range(len(list_nmb_stems) - 1):
            if list_nmb_stems[s_idx + 1] / list_nmb_stems[s_idx] >= 1:
                list_nmb_stems[s_idx] += 1
                increase_done = True
                break
        if not increase_done:
            list_nmb_stems[-1] += 1

        if stop_criterion == "t_compute_max_allowed" and t_compute > t_compute_max_allowed:
            stop = True
        elif stop_criterion == "nmb_max_branches" and np.sum(list_nmb_stems) >= nmb_max_branches:
            stop = True
            if is_first_iteration:
                list_idx_injection = np.linspace(
                    list_idx_injection[0], list_idx_injection[-1], nmb_max_branches
                ).astype(np.int32)
                list_nmb_stems = np.ones(len(list_idx_injection), dtype=np.int32)
        else:
            is_first_iteration = False

    return [int(i) for i in list_idx_injection], [int(i) for i in list_nmb_stems]


def get_closest_idx(fract_mixing: float, tree_fracts: list[float]) -> tuple[int, int]:
    """Indices of the two ADJACENT tree entries bracketing fract_mixing.

    Reference: blending_engine.py:767-789 — but computed by bisection on
    the sorted fract list (an engine invariant) instead of the reference's
    argmin over signed distances, which returns a NON-adjacent pair when
    two fracts are so close that subtracting them from the query rounds to
    the same float (hypothesis-found), and pairs (0, last) for a query at
    exactly 1.0. Exact-hit semantics match the reference: a query equal to
    tree_fracts[k] brackets as (k, k+1).
    """
    arr = np.asarray(tree_fracts)
    hi = int(np.searchsorted(arr, fract_mixing, side="right"))
    hi = min(max(hi, 1), len(arr) - 1)
    return hi - 1, hi


def frame_insert_counts(nmb_keyframes: int, nmb_frames_target: int) -> np.ndarray:
    """How many interpolated frames to insert into each of the K-1 gaps so the
    total frame count is exactly nmb_frames_target.

    Deterministic re-derivation of reference utils.py:148-165, which used
    rejection sampling over random masks; we place the remainder frames with
    an even stride so the count is exact by construction and reproducible.
    """
    nmb_gaps = nmb_keyframes - 1
    nmb_missing = nmb_frames_target - nmb_keyframes
    if nmb_gaps <= 0 or nmb_missing < 1:
        return np.zeros(max(nmb_gaps, 0), dtype=np.int32)
    base, rem = divmod(nmb_missing, nmb_gaps)
    counts = np.full(nmb_gaps, base, dtype=np.int32)
    if rem > 0:
        # spread the remainder evenly across the gaps
        pos = np.linspace(0, nmb_gaps - 1, rem).round().astype(np.int32)
        pos = np.unique(pos)
        # collisions from rounding: fill the remaining slots deterministically
        extra = rem - len(pos)
        if extra > 0:
            unused = np.setdiff1d(np.arange(nmb_gaps), pos)[:extra]
            pos = np.concatenate([pos, unused])
        counts[pos] += 1
    assert counts.sum() == nmb_missing
    return counts
