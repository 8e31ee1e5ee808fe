"""The system under test: the program's engine, built by the
configuration's architecture module (benchmark/systems/<architecture>.py)
from the configuration and the run's seed and set to the configuration's
transition, and one transition as a client calls it.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import architecture, calls


@dataclasses.dataclass
class Record:
    """One completed transition, as the check and the readers need it."""

    request: object
    keyframes: np.ndarray  # uint8 [K,H,W,3]
    finals: list  # device final latents, one [1,h,w,c] per keyframe
    fracts: list
    idx: list
    path: str
    denoise_s: float
    embed_s: float
    wall_s: float
    product: object = None  # what the call made besides the keyframes (a movie's file)
    movie_write_s: float | None = None  # the engine's movie_write phase, where it ran


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        run = cfg["run"]
        self.arch = architecture.load("systems", cfg)
        eng = self.arch.build(cfg, seed, device)
        eng.set_dimensions((run["width"], run["height"]))
        eng.set_num_inference_steps(run["num_inference_steps"])
        b = run["engine"]["branching"]
        eng.set_branching(depth_strength=b["depth_strength"], nmb_max_branches=b["nmb_max_branches"])
        eng.placement_policy = traffic["placement_policy"]
        plan = ([int(i) for i in eng.list_idx_injection], [int(k) for k in eng.list_nmb_stems])
        if plan != (run["plan"]["idx_injection"], run["plan"]["stems"]):
            raise ValueError(f"the engine's plan {plan} is not the configuration's {run['plan']}")
        cf = run["parental_crossfeed"]
        if (eng.parental_crossfeed_power, eng.parental_crossfeed_range, eng.parental_crossfeed_decay) != (
                cf["power"], cf["range"], cf["decay"]) or eng.guidance_scale_base != run["guidance_scale"]:
            raise ValueError("the engine's crossfeed or guidance is not the configuration's")
        self.engine = eng
        self.cuda = torch.device(device).type == "cuda"
        self.call = calls.load(traffic["call"]).Call(traffic)
        self.plan = plan
        self._n = 0

    def transition(self, req) -> Record:
        """One client transition: the prompts set (their embedding synced and
        timed as embed_s), then the cell's call until its product is on the host."""
        eng = self.engine
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench::embed"):
            eng.set_negative_prompt(req.negative)
            eng.set_prompt1(req.prompt1)
            eng.set_prompt2(req.prompt2)
            if self.cuda:
                torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench::transition"):
            imgs, product = self.call.call(eng, req, self._n)
        t2 = time.perf_counter()
        self._n += 1
        phases = eng.last_report.phases
        levels = eng.last_report.levels
        fused = [lv.get("fused", False) for lv in levels]
        path = ("fused" if len(levels) == 1 else "fused-multi") if fused and all(fused) else "per-level"
        return Record(
            request=req, keyframes=np.stack([np.asarray(im) for im in imgs]),
            finals=[lat[-1] for lat in eng.tree_latents], fracts=list(eng.tree_fracts),
            idx=[int(i) for i in eng.tree_idx_injection], path=path,
            denoise_s=float(phases.get("denoise", {}).get("total_s", 0.0)),
            embed_s=t1 - t0, wall_s=t2 - t0, product=product,
            movie_write_s=float(phases["movie_write"]["total_s"]) if "movie_write" in phases else None,
        )

    def module_hooks(self) -> list:
        """Forward hooks that put the denoiser's and the decoder's launches
        (the architecture module's `hooked`) in record_function ranges
        (bench::unet, bench::vae), for traced runs."""
        handles = []
        for name, mod in zip(("bench::unet", "bench::vae"), self.arch.hooked(self.engine)):
            stack = []

            def pre(_m, _a, name=name, stack=stack):
                rf = torch.profiler.record_function(name)
                rf.__enter__()
                stack.append(rf)

            def post(_m, _a, _o, stack=stack):
                stack.pop().__exit__(None, None, None)

            handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
        return handles

    def close(self) -> None:
        """Let go of the program's modules and state (what the calls wrote
        stays until `self.call` is cleaned up)."""
        self.engine = None
