"""Observability: phase timers and transition reports.

A copy of latentblending_tpu/profiling.py without its jax.profiler
`trace()` hook.

The reference's only runtime metrics are two printed wall-clock numbers and
tqdm bars (SURVEY.md §5 'Tracing / profiling'). This module provides:

- PhaseTimer: named wall-clock phases with a structured summary
- TransitionReport: what run_transition did (branch count, per-level
  timings, LPIPS gap histogram) — engine fills one per run
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k], "mean_s": round(v / self.counts[k], 4)}
            for k, v in sorted(self.totals.items())
        }


@dataclasses.dataclass
class TransitionReport:
    num_keyframes: int = 0
    num_steps: int = 0
    levels: list = dataclasses.field(default_factory=list)  # per-level dicts
    lpips_gaps: list = dataclasses.field(default_factory=list)
    phases: dict = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    # deferred gap-similarity device handle (finalize_report(sync_sims=False)):
    # chained-movie sessions stash it here so no part's sync blocks the next
    # part's dispatch, and resolve all parts after the last one is in flight
    sims_pending: object = None

    def resolve_sims(self) -> None:
        """Land a deferred similarity handle into lpips_gaps (no-op if
        already resolved). One host copy per part."""
        if self.sims_pending is not None:
            import numpy as np

            self.lpips_gaps = [float(s) for s in np.asarray(self.sims_pending, np.float64)]
            self.sims_pending = None

    def as_dict(self) -> dict:
        gaps = self.lpips_gaps
        return {
            "num_keyframes": self.num_keyframes,
            "num_steps": self.num_steps,
            "wall_s": round(self.wall_s, 3),
            "levels": self.levels,
            "lpips_gaps": {
                "values": [round(g, 4) for g in gaps],
                "max": round(max(gaps), 4) if gaps else None,
                "mean": round(sum(gaps) / len(gaps), 4) if gaps else None,
            },
            "phases": self.phases,
        }

    @classmethod
    def merged(cls, reports: list["TransitionReport"]) -> "TransitionReport":
        """Aggregate per-transition reports from a chained-movie run into
        one report: phase totals/counts summed, levels and gap values
        concatenated, walls summed. Keyframe count sums the unique frames
        (each recycled seam keyframe is counted once)."""
        out = cls()
        for i, r in enumerate(reports):
            r.resolve_sims()
            out.num_steps = r.num_steps or out.num_steps
            out.num_keyframes += r.num_keyframes - (1 if i > 0 and r.num_keyframes else 0)
            out.levels.extend(r.levels)
            out.lpips_gaps.extend(r.lpips_gaps)
            out.wall_s += r.wall_s
            for name, p in (r.phases or {}).items():
                cur = out.phases.setdefault(name, {"total_s": 0.0, "count": 0, "mean_s": 0.0})
                cur["total_s"] = round(cur["total_s"] + p["total_s"], 4)
                cur["count"] += p["count"]
                cur["mean_s"] = round(cur["total_s"] / cur["count"], 4)
        return out

