"""A device trace of a traced run, reduced to what the readers need.

torch.profiler (CUPTI) records the kernels and the host launches, and,
where it records host activity too, the benchmark's record_function
ranges. Each device operation is attributed to the innermost benchmark
range (bench::*) that was open on the host when it was launched, through
the launch's correlation id, which also covers the program's ctypes
(driver API) launches; in a trace of device activity alone every scope is
empty.
"""
from __future__ import annotations

import bisect
import dataclasses

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Op:
    name: str
    kind: str
    start_ns: int
    end_ns: int
    scope: str  # innermost bench:: range at launch, "" if none


@dataclasses.dataclass
class Trace:
    ops: list  # device ops sorted by start
    window_s: float

    def kernels(self) -> list:
        return [o for o in self.ops if o.kind == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        busy, end = 0, None
        for o in self.ops:
            if end is None or o.start_ns > end:
                busy += o.end_ns - o.start_ns
                end = o.end_ns
            elif o.end_ns > end:
                busy += o.end_ns - end
                end = o.end_ns
        return busy / 1e9

    def device_s(self, pred) -> float:
        return sum(o.end_ns - o.start_ns for o in self.ops if pred(o)) / 1e9

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for o in self.ops:
            tot[o.name] = tot.get(o.name, 0) + o.end_ns - o.start_ns
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps between device operations, each named by the
        bench:: range the host was in when it launched the op that ended it,
        and that op's name."""
        gaps, end = [], None
        for o in self.ops:
            if end is not None and o.start_ns > end:
                gaps.append((o.start_ns - end, f"{o.scope or 'host'} > {o.name[:60]}"))
            end = o.end_ns if end is None else max(end, o.end_ns)
        return [[name, g / 1e9] for g, name in sorted(gaps, reverse=True)[:n]]


def _kind(e) -> str:
    """The event's activity, from its device and name: device events are
    kernels unless named Memcpy/Memset (the device copy of a bench:: range
    is an annotation); host events named cuda*/cu* are runtime or driver
    calls."""
    name = e.name()
    if not str(e.device_type()).endswith("CPU"):
        if name.startswith("bench::"):
            return "gpu_user_annotation"
        return "gpu_memcpy" if name.startswith("Memcpy") else ("gpu_memset" if name.startswith("Memset")
                                                               else "kernel")
    if name.startswith("bench::"):
        return "user_annotation"
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return "cuda_runtime"
    return "cpu_op"


def reduce(prof, window_s: float) -> Trace:
    """The device ops of a finished torch.profiler session."""
    events = prof.profiler.kineto_results.events()
    ranges, launches, device = [], {}, []
    for e in events:
        kind = _kind(e)
        if kind in _DEVICE_KINDS:
            device.append((e, kind))
        elif kind in _LAUNCH_KINDS:
            launches[e.correlation_id()] = e.start_ns()
        elif kind == "user_annotation" and e.name().startswith("bench::"):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    # the innermost open range over time: (time, name) from each boundary on
    marks = sorted([(s, 1, e, n) for s, e, n in ranges] + [(e, 0, e, n) for s, e, n in ranges])
    times, names, stack = [], [], []
    for t, is_start, end, name in marks:
        if is_start:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
        times.append(t)
        names.append(stack[-1] if stack else "")

    def scope(t: int) -> str:
        i = bisect.bisect_right(times, t) - 1
        return names[i] if i >= 0 else ""

    ops = []
    for e, kind in device:
        t = launches.get(e.correlation_id())
        start = e.start_ns()
        ops.append(Op(e.name(), kind, start, start + e.duration_ns(), "" if t is None else scope(t)))
    ops.sort(key=lambda o: o.start_ns)
    return Trace(ops, window_s)
