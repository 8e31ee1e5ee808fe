"""The tracer's numbers on one of the benchmark's cells, on the card.

    python3 -m latentblending_tpu_torch.tools.span_report --workload base1024.transition --seed 7 \\
        --transitions 3

from the root of a checkout. Builds the cell's system as the benchmark
does (benchmark/system.py: its configuration, weights made from the seed,
its traffic mix), warms up one transition, then prints a JSON line a
transition with what its report's span tree gives: host_syncs by reason,
the denoise steps' host (dispatch) and device ms (total over count), the
denoiser's `unet` spans' host ms (the UNet's or SD3's MMDiT's), the
similarity passes', decodes', embeds' and T5's (inside SD3's embeds)
device seconds, K2's launches at a length no multiple of 128 (K2_tail), the root's children's host seconds, the garbage collections and
the phases. Last, two transitions under a profile of host and device (so
that the gap between them, the client's and the next embed's, is inside):
the device's busy and window seconds, the longest idle gaps, each named by
the innermost program span (lb::) open on the host when it began, and the
idle seconds by the innermost span open on the host while the device
idled ("host" where none was).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys


def _numbers(rep, wall_s: float) -> dict:
    """One transition's report, reduced."""
    spans = rep.spans
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)

    def total(name: str, attr: str) -> float:
        return sum(getattr(s, attr) or 0.0 for s in by_name[name])

    steps = by_name["step"]
    root = spans[0]
    children = collections.defaultdict(float)
    for s in spans:
        if s.parent == root.id:
            children[s.name] += s.host_s or 0.0
    return {
        "transition_id": rep.transition_id, "wall_s": wall_s, "report_wall_s": rep.wall_s, "spans": len(spans),
        "host_syncs": rep.host_syncs,
        "syncs": dict(collections.Counter(s.name for s in spans if s.name.startswith("sync."))),
        "sync_host_s": {k: sum(s.host_s for s in spans if s.name == k) for k in
                        sorted({s.name for s in spans if s.name.startswith("sync.")})},
        "steps": len(steps),
        "step_dispatch_ms": 1e3 * total("step", "host_s") / len(steps) if steps else None,
        "step_device_ms": 1e3 * total("step", "device_s") / len(steps) if steps else None,
        "unet_host_ms": 1e3 * total("unet", "host_s") / len(by_name["unet"]) if by_name["unet"] else None,
        "similarity_s": total("similarity.pass", "device_s"),
        "similarity_passes": len(by_name["similarity.pass"]),
        "vae_decode_device_s": total("vae.decode", "device_s"),
        "embed_device_s": total("embed", "device_s"), "embed_host_s": total("embed", "host_s"),
        "t5_device_s": total("t5", "device_s"), "t5_host_s": total("t5", "host_s"),
        "K2_tail": rep.counters.get("K2_tail", 0),
        "unresolved": sum(1 for s in spans if s.name in ("step", "vae.decode", "similarity.pass", "embed", "t5")
                          and s.device_s is None),
        "root_children_host_s": dict(children),
        "gc": [len(by_name["gc"]), total("gc", "host_s")],
        "phases": {k: v["total_s"] for k, v in rep.phases.items()},
        "counters": rep.counters,
    }


def _is_host(e) -> bool:
    return str(e.device_type()).endswith("CPU")


def named_gaps(events, n: int = 12) -> dict:
    """Busy and window seconds of the device, its n longest idle gaps, each
    named `lb::<span> > <op>` by the innermost program span open on the
    host when the gap began and the op that ended it, and the idle seconds
    by the innermost span open on the host during them. Device ranges
    (bench::, lb::) are not ops."""
    ranges, ops = [], []
    for e in events:
        name = e.name()
        if _is_host(e):
            if name.startswith("lb::"):
                ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif not name.startswith(("bench::", "lb::")):
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    ops.sort()
    # the innermost open range over time: (time, name) from each boundary on
    marks = sorted([(s, 1, n_) for s, _, n_ in ranges] + [(t, 0, n_) for _, t, n_ in ranges])
    times, names, stack = [], [], []
    for t, is_start, name in marks:
        if is_start:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        times.append(t)
        names.append(stack[-1] if stack else "host")

    def span_at(t: int) -> str:
        i = bisect.bisect_right(times, t) - 1
        return names[i] if i >= 0 else "host"

    gaps, busy, end = [], 0, None
    for s, e, name in ops:
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end, name))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_span: collections.Counter = collections.Counter()
    for g, t, _ in gaps:
        # the gap [t, t + g) split at the boundaries of the host's spans
        i = bisect.bisect_right(times, t)
        cursor, name = t, span_at(t)
        while i < len(times) and times[i] < t + g:
            by_span[name] += (times[i] - cursor) / 1e9
            cursor, name = times[i], names[i]
            i += 1
        by_span[name] += (t + g - cursor) / 1e9
    top = sorted(gaps, reverse=True)[:n]
    return {"busy_s": busy / 1e9, "window_s": (end - ops[0][0]) / 1e9 if ops else 0.0, "ops": len(ops),
            "idle_gaps": [[f"{span_at(t)} > {name[:60]}", g / 1e9] for g, t, name in top],
            "idle_s_by_span": dict(by_span.most_common(12))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--transitions", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=".", help="where BENCHMARK.json and the files it names lie")
    args = ap.parse_args(argv)
    import torch

    from benchmark.run import cell_files, load
    from benchmark.system import System
    from benchmark.traffic import Traffic

    _, cfg, mix, _ = cell_files(load("BENCHMARK.json", args.root), args.workload, args.root)
    system = System(cfg, mix, args.seed, args.device)
    traffic = Traffic(mix, args.seed)
    cuda = args.device.startswith("cuda")
    try:
        system.transition(traffic.warmup())
        for _ in range(args.transitions):
            rec = system.transition(traffic.next())
            print(json.dumps({"workload": args.workload, "path": rec.path,
                              **_numbers(system.engine.last_report, rec.wall_s)}), flush=True)
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts) as prof:
            walls = [system.transition(traffic.next()).wall_s for _ in range(2)]
            if cuda:
                torch.cuda.synchronize()
        out = {"workload": args.workload, "profiled_walls_s": walls,
               **named_gaps(prof.profiler.kineto_results.events())}
        out["device"] = torch.cuda.get_device_name(0) if cuda else "cpu"
        print(json.dumps(out), flush=True)
    finally:
        system.call.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
