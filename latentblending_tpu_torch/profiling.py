"""Observability: the port's tracer, its counters and the transition report.

One transition is one span tree. The engine opens a `Trace` for each
`run_transition`, `run_transition_streaming`, `extend_transition` and
`run_movie_transition`: its root span `transition` carries the engine's
transition id, and every span opened under it, on the engine's thread or
on a thread that records into it (`recording`), is a child. A span has a
name, its parent, its transition, its host start and end
(`time.perf_counter_ns`) and a few integer attributes; a span opened
with a CUDA `device` also records a pooled CUDA event pair on the
device's current stream, which the trace resolves into the span's device
interval when the transition is finalized.

- `span(name, device=None, carry=None, **attrs)`: a span of the trace
  this thread records into; with no transition open it is recorded
  nowhere, unless `carry`, a list its owner hands to the next Trace (the
  holder keeps its `embed` spans so: set_prompt runs before the
  transition starts).
- `wait(reason)`: the one way the program's own code blocks the host on
  the device: a `sync.<reason>` span, and the `host_syncs` counter.
- `count(name, n)`: the counter registry (the kernels' launches by site,
  `host_syncs`); a trace keeps each transition's deltas.
- `PhaseTimer`: named phases, each a span, summed by name (the report's
  `phases`).
- `TransitionReport`: what a transition did; `as_dict()` is the one
  exporter of its spans.

While a torch.profiler session records, each recorded span also opens a
host range `lb::<name>` on the profiler's timeline, which CUPTI's device
timestamps share; a range of the profiler's function scope, so the
profiler makes no device-side copy of it. Outside a profile nothing goes
to the profiler. A Python garbage collection that runs on a recording
thread is a `gc` span (gc.callbacks).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import threading
import time
from typing import Optional

import torch

# the profiler's host range, of the function scope: the profiler records
# no device copy of it (a user-scope record_function gets one, which a
# trace reader would take for a kernel)
_RANGE = torch._C._profiler._RecordFunctionFast
_CARRY_MAX = 16  # carried spans a carry list keeps for the next transition

_counters: collections.Counter = collections.Counter()
_counters_lock = threading.Lock()  # the movie writer's threads count too


def count(name: str, n: int = 1) -> None:
    """Add n to the registry's counter `name`."""
    with _counters_lock:
        _counters[name] += n


def counter(name: str) -> int:
    return _counters[name]


def counters() -> dict:
    """A copy of every counter of the registry."""
    with _counters_lock:
        return dict(_counters)


class _Local(threading.local):
    def __init__(self):
        self.trace: Optional[Trace] = None  # the trace this thread records into
        self.stack: list = []  # this thread's open recorded spans
        self.gc_span: Optional[Span] = None


_local = _Local()

_free_events: dict = collections.defaultdict(list)  # device index -> timing events free for reuse


def _event_pair(device: torch.device) -> tuple:
    index = device.index if device.index is not None else torch.cuda.current_device()
    pool = _free_events[index]
    return tuple(pool.pop() if pool else torch.cuda.Event(enable_timing=True) for _ in range(2)) + (index,)


class Span:
    """One timed interval; a context manager (`with span(...) as s`). The
    host interval is set whether or not the span is recorded."""

    __slots__ = ("name", "attrs", "id", "parent", "transition_id", "start_ns", "end_ns", "device_s",
                 "_device", "_carry", "_events", "_range", "_recorded")

    def __init__(self, name: str, device=None, carry: Optional[list] = None, attrs: Optional[dict] = None):
        self.name = name
        self.attrs = attrs or {}
        self.id = self.parent = self.transition_id = None
        self.start_ns = self.end_ns = None
        self.device_s: Optional[float] = None
        self._device = device if device is not None and device.type == "cuda" else None
        self._carry = carry
        self._events = self._range = None
        self._recorded = False

    @property
    def host_s(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        loc = _local
        trace = loc.trace
        if trace is not None or self._carry is not None:
            stack = loc.stack
            if trace is not None:
                trace._add(self, stack[-1].id if stack else trace.root.id)
            else:
                self._carry.append(self)
                del self._carry[:-_CARRY_MAX]
            stack.append(self)
            self._recorded = True
            if torch.autograd._profiler_enabled():
                self._range = _RANGE("lb::" + self.name)
                self._range.__enter__()
            if self._device is not None:
                self._events = _event_pair(self._device)
                self._events[0].record(torch.cuda.current_stream(self._events[2]))
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._recorded:
            if self._events is not None:
                self._events[1].record(torch.cuda.current_stream(self._events[2]))
            if self._range is not None:
                self._range.__exit__(None, None, None)
                self._range = None
            stack = _local.stack
            if stack and stack[-1] is self:
                stack.pop()
        return False

    def _resolve(self) -> None:
        """The device interval from the event pair, where its end has
        completed; the pair goes back to the pool. An open span, or one
        whose end is still queued, keeps None."""
        ev = self._events
        if ev is None or self.end_ns is None:
            return
        self._events = None
        if ev[1].query():
            self.device_s = ev[0].elapsed_time(ev[1]) / 1e3
            _free_events[ev[2]].extend(ev[:2])

    def as_dict(self) -> dict:
        out = {"name": self.name, "id": self.id, "parent": self.parent, "transition_id": self.transition_id,
               "start_ns": self.start_ns, "end_ns": self.end_ns}
        if self.device_s is not None:
            out["device_s"] = self.device_s
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        return out


def span(name: str, device=None, carry: Optional[list] = None, **attrs) -> Span:
    """A span of the trace this thread records into (see the module
    docstring); `device` a torch.device whose current stream also times it."""
    return Span(name, device, carry, attrs)


def wait(reason: str) -> Span:
    """Wrap a place where the program blocks the host on the device: a
    `sync.<reason>` span, counted in `host_syncs` (also where the device
    is the CPU, where the block returns at once)."""
    count("host_syncs")
    return Span("sync." + reason)


def _on_gc(phase: str, info: dict) -> None:
    loc = _local
    if loc.trace is None:
        return
    if phase == "start":
        loc.gc_span = Span("gc", attrs={"generation": info["generation"]}).__enter__()
    elif loc.gc_span is not None:
        s, loc.gc_span = loc.gc_span, None
        s.attrs["collected"] = info["collected"]
        s.__exit__(None, None, None)


class Trace:
    """One transition's span tree. Created inside `recording()`, it becomes
    the trace of the creating thread until that block ends, takes the
    spans of `carried` (emptied) as children of its root and starts the
    root span `transition` now; `finish()` ends it."""

    def __init__(self, transition_id: int, carried: Optional[list] = None):
        self.transition_id = transition_id
        self.spans: list[Span] = []
        self.counters: dict = {}  # the registry's deltas over the transition, set by finish()
        self._ids = itertools.count()
        self._counters0 = counters()
        loc = _local
        loc.trace, loc.stack = self, []
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)
        self.root = Span("transition", attrs={"transition_id": transition_id})
        self._add(self.root, None)
        for s in carried or ():
            self._add(s, self.root.id)
        if carried:
            carried.clear()
        if torch.autograd._profiler_enabled():
            self.root._range = _RANGE("lb::transition")
            self.root._range.__enter__()
        self.root.start_ns = time.perf_counter_ns()

    def _add(self, s: Span, parent: Optional[int]) -> None:
        s.id, s.parent, s.transition_id = next(self._ids), parent, self.transition_id
        self.spans.append(s)

    @property
    def host_syncs(self) -> int:
        return sum(s.name.startswith("sync.") for s in self.spans)

    def finish(self) -> None:
        """End the root span, resolve the device intervals whose events
        have completed, and keep the counters' deltas."""
        root = self.root
        root.end_ns = time.perf_counter_ns()
        if root._range is not None:
            root._range.__exit__(None, None, None)
            root._range = None
        for s in self.spans:
            s._resolve()
        now = counters()
        self.counters = {k: v - self._counters0.get(k, 0) for k, v in now.items() if v != self._counters0.get(k, 0)}


@contextlib.contextmanager
def recording(trace: Optional[Trace] = None):
    """Spans opened on this thread inside the block go to `trace`, or, from
    its creation on, to a Trace created inside the block; before that, and
    after the block, to this thread's earlier trace."""
    loc = _local
    saved = loc.trace, loc.stack
    loc.trace, loc.stack = trace, []
    try:
        yield
    finally:
        loc.trace, loc.stack = saved


class PhaseTimer:
    """Named phases, each a span of the transition being recorded, with
    their host seconds summed by name."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        s = Span(name)
        try:
            with s:
                yield
        finally:
            self.totals[name] += s.host_s
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
    wall_s: float = 0.0  # the root span's host seconds
    # deferred gap-similarity device handle (finalize_report(sync_sims=False)):
    # chained-movie sessions stash it here so no part's sync blocks the next
    # part's dispatch, and resolve all parts after the last one is in flight
    sims_pending: object = None
    transition_id: Optional[int] = None  # the engine's count of its transitions; None when merged
    traces: list = dataclasses.field(default_factory=list)  # the span tree of each transition it covers

    @property
    def spans(self) -> list:
        return [s for t in self.traces for s in t.spans]

    @property
    def host_syncs(self) -> int:
        return sum(t.host_syncs for t in self.traces)

    @property
    def counters(self) -> dict:
        out: collections.Counter = collections.Counter()
        for t in self.traces:
            out.update(t.counters)
        return dict(out)

    def resolve_sims(self) -> None:
        """Land a deferred similarity handle into lpips_gaps (no-op if
        already resolved). One host copy per part."""
        if self.sims_pending is not None:
            import numpy as np

            with wait("sims"):
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
            "transition_id": self.transition_id,
            "host_syncs": self.host_syncs,
            "counters": self.counters,
            "spans": [s.as_dict() for s in self.spans],
        }

    @classmethod
    def merged(cls, reports: list["TransitionReport"]) -> "TransitionReport":
        """Aggregate per-transition reports from a chained-movie run into
        one report: phase totals/counts summed, levels, gap values and span
        trees concatenated, walls summed. Keyframe count sums the unique
        frames (each recycled seam keyframe is counted once)."""
        out = cls()
        for i, r in enumerate(reports):
            r.resolve_sims()
            out.num_steps = r.num_steps or out.num_steps
            out.num_keyframes += r.num_keyframes - (1 if i > 0 and r.num_keyframes else 0)
            out.levels.extend(r.levels)
            out.lpips_gaps.extend(r.lpips_gaps)
            out.traces.extend(r.traces)
            out.wall_s += r.wall_s
            for name, p in (r.phases or {}).items():
                cur = out.phases.setdefault(name, {"total_s": 0.0, "count": 0, "mean_s": 0.0})
                cur["total_s"] = round(cur["total_s"] + p["total_s"], 4)
                cur["count"] += p["count"]
                cur["mean_s"] = round(cur["total_s"] / cur["count"], 4)
        return out
