"""BlendingEngine.run_transition: one transition's keyframes, complete
when the uint8 keyframes are on the host. Adds no check number."""
from __future__ import annotations

KEYFRAME_FORMAT = "rgb"
NUMBERS = ()


class Call:
    def __init__(self, mix: dict):
        self.mix = mix

    def call(self, engine, req, n: int):
        return engine.run_transition(fixed_seeds=[req.seed1, req.seed2]), None

    def cleanup(self) -> None:
        pass


def judge(dec_pm1, tree, product, mix: dict) -> dict:
    return {}
