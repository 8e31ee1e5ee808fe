"""Metric readers, one module per metric named as in BENCHMARK.json, or
as what precedes the first dot of its name. Each has
`read(run) -> float | None`: `run` is a `Run`, and None means the run holds
nothing to read, so the metric is left out of the result line (never 0 for
a share of a roofline or a peak)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Run:
    cfg: dict  # the configuration file
    records: list  # system.Record of the window's transitions (after the profiles, in a traced run)
    window_s: float  # host wall of those transitions
    setup_s: float = 0.0  # host wall from the process's start to the window
    peak_bytes: int = 0  # torch.cuda.max_memory_allocated over the window
    trace: object = None  # trace.Trace of the device alone over the first traced transitions, or None
    traced: int = 0  # transitions inside it
    scoped: object = None  # trace.Trace with the host's bench:: ranges, over the next ones, or None
    scoped_n: int = 0  # transitions inside it
