"""The general traffic generator: a closed loop of one client whose
requests come from a mix file's parameters and the run's seed.

Each request is a prompt pair (two distinct prompts of the mix's list), a
negative prompt and the two keyframe seeds, drawn from a generator seeded
by the run's seed; the warm-up request is drawn from a stream of its own,
so every seed gives the window the same kind of work in another order.
"""
from __future__ import annotations

import random

from benchmark.reference.transition import Request


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self._window = random.Random(f"window:{seed}")
        self._warm = random.Random(f"warmup:{seed}")

    def _draw(self, rng: random.Random) -> Request:
        p1, p2 = rng.sample(self.mix["prompts"], 2)
        return Request(prompt1=p1, prompt2=p2, negative=rng.choice(self.mix["negative_prompts"]),
                       seed1=rng.randrange(self.mix["keyframe_seed_max"]),
                       seed2=rng.randrange(self.mix["keyframe_seed_max"]))

    def warmup(self) -> Request:
        return self._draw(self._warm)

    def next(self) -> Request:
        return self._draw(self._window)
