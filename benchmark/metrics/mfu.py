"""Whole-step share of the chip's peak, in %: the model work the window's
completed transitions need (benchmark/yardstick/work.py's counts, costed
by the architecture's yardstick module), each part at the published peak
of its configured dtype, over the window's wall."""
from benchmark import architecture


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    at_peak = architecture.load("yardstick", run.cfg).model_seconds_at_peak(run.cfg)
    return 100.0 * len(run.records) * at_peak / run.window_s
