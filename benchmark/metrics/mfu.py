"""Whole-step share of the chip's peak, in %: the UNet and decode work the
window's completed transitions need (benchmark/yardstick/work.py), each
part at the published peak of its configured dtype, over the window's wall."""
from benchmark.yardstick import work


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    return 100.0 * len(run.records) * work.model_seconds_at_peak(run.cfg) / run.window_s
