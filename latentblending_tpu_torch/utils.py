"""Cross-cutting host helpers (yaml IO, time strings, logging).

Reference counterpart: latentblending/utils.py:203-262.
"""
from __future__ import annotations

import datetime
import json
import logging
import time


_progress_hook = None


def set_progress_hook(fn) -> None:
    """Register a zero-arg liveness callback. The engine calls
    tick_progress() after each completed device call in long phases
    (speed benchmark, per-level rounds, decode chunks) so an external
    watchdog (bench.py's milestone detector) can distinguish a SLOW relay
    (ticks keep flowing, one per call) from a WEDGED one (a single device
    call never returns — ticks stop). Pass None to unregister."""
    global _progress_hook
    _progress_hook = fn


def tick_progress() -> None:
    hook = _progress_hook
    if hook is not None:
        try:
            hook()
        except Exception:
            pass


def get_logger(name: str = "latentblending_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def get_time(resolution: str | None = None) -> str:
    """Formatted time string, e.g. 221117_1620 (reference utils.py:203-221)."""
    resolution = resolution or "second"
    if resolution == "day":
        return time.strftime("%y%m%d", time.localtime())
    if resolution == "minute":
        return time.strftime("%y%m%d_%H%M", time.localtime())
    if resolution == "second":
        return time.strftime("%y%m%d_%H%M%S", time.localtime())
    if resolution == "millisecond":
        t = time.strftime("%y%m%d_%H%M%S", time.localtime())
        ms = int(datetime.datetime.now().microsecond / 1000)
        return f"{t}_{ms:03d}"
    raise ValueError(f"bad resolution provided: {resolution}")


def get_spacing(nmb_points: int, scaling: float):
    """Nonlinear [0,1] spacing, denser around 0.5 (reference utils.py:181-200;
    exported by the reference package __init__, so it is public API)."""
    import numpy as np

    if scaling < 1.7:
        return np.linspace(0, 1, nmb_points)
    nmb_points_per_side = nmb_points // 2 + 1
    left = np.abs(np.linspace(1, 0, nmb_points_per_side) ** scaling / 2 - 0.5)
    if nmb_points % 2 != 0:
        right = 1 - left[::-1][1:]
    else:
        left = left[:-1]
        right = 1 - left[::-1]
    return np.hstack([left, right])


def yml_load(fp_yml: str) -> dict:
    import yaml

    with open(fp_yml) as f:
        return dict(yaml.load(f, Loader=yaml.SafeLoader))


def yml_save(fp_yml: str, dict_stuff: dict) -> None:
    import yaml

    with open(fp_yml, "w") as f:
        yaml.dump(dict_stuff, f, sort_keys=False, default_flow_style=False)


def compare_dicts(a: dict, b: dict) -> dict:
    """Shared keys whose values differ, as {key: [a_val, b_val]}
    (reference utils.py:224 — kept for migration completeness)."""
    return {k: [a[k], b[k]] for k in a if k in b and a[k] != b[k]}


def json_load(fp: str):
    with open(fp) as f:
        return json.load(f)


def json_save(fp: str, obj) -> None:
    with open(fp, "w") as f:
        json.dump(obj, f, indent=2)
