"""The benchmark of latentblending_tpu_torch on NVIDIA GPUs: one run of one
cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A run builds the cell's configuration with
weights made on the card from the seed, warms up one transition of the
cell's shapes (set-up, `setup_s`), then runs transitions back to back for
--seconds as one closed-loop client (the transition in flight when the
time is up finishes and counts), frees the program, checks a sample of the
window's transitions against the plain reference and prints one JSON line.
--trace 0 reports the cell's end-to-end metrics; --trace 1 profiles the
window's first transitions twice over (the mix's `trace_seconds` each):
the device alone, for the device's busy and window seconds, its kernels and
its top operations, then the host too, whose ranges attribute device time
to the models and name the idle gaps; it reports the per-layer metrics,
the host-clock ones from the transitions after the profiles.
Everything is named by BENCHMARK.json and found by name: the configuration
file, the traffic mix, the cell's check file, one reader per metric, and
the configuration's architecture modules (benchmark/architecture.py).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

from benchmark import architecture

T_START = time.perf_counter()
ROOT = os.getcwd()
# the program's and the libraries' caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".bench_cache", _sub))
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = {"jax", "jaxlib", "flax", "latentblending_tpu"}


def load(path: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, path)) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str, root: str = ROOT) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic mix, check file) of a cell by name; a
    configuration whose architecture lacks a module is refused."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load(conf["file"], root)
    architecture.check(cfg)
    return (cell, cfg, load(f"benchmark/traffic/{cell['traffic']}.json", root),
            load(f"benchmark/checks/{workload}.json", root))


def metric_names(bench: dict, kind: str, workload: str) -> list[dict]:
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & FORBIDDEN)


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
             root: str = ROOT) -> dict:
    """Set-up, window, metrics and check of one run; the result line's dict.
    `root` holds the files BENCHMARK.json names."""
    import torch

    from benchmark import check as chk
    from benchmark.metrics import Run
    from benchmark.system import System
    from benchmark.trace import reduce
    from benchmark.traffic import Traffic

    cell, cfg, mix, cell_check = cell_files(bench, workload, root)
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_build = time.perf_counter()
    system = System(cfg, mix, seed, device)
    traffic = Traffic(mix, seed)
    t_warm = time.perf_counter()
    system.transition(traffic.warmup())
    if trace:
        # a second warm-up under the device's profile, then a short profile of
        # the host too: CUPTI's first sessions and each kernel's first launch
        # under them pay their one-time costs here, in set-up
        with torch.profiler.profile(activities=_profiles(torch, cuda)[0]):
            system.transition(traffic.warmup())
            sync()
        with torch.profiler.profile(activities=_profiles(torch, cuda)[1]):
            torch.zeros(1, device=device).add_(1)
            sync()
    sync()
    setup_s = time.perf_counter() - T_START
    print(json.dumps({"workload": workload, "plan": {"idx_injection": system.plan[0], "stems": system.plan[1]},
                      "placement_policy": mix["placement_policy"], "imports_s": t_build - T_START,
                      "build_s": t_warm - t_build, "warmup_s": setup_s - (t_warm - T_START)}), flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # --trace 1: the window's first transitions (at least the mix's
    # trace_seconds) under a profile of the device alone, the next under one
    # of the host too, whose ranges attribute device time; the rest untraced
    records, todo, traces = [], list(_profiles(torch, cuda)) if trace else [], []
    prof, hooks, first = None, [], 0
    t0 = t_after = time.perf_counter()
    n_after = 0
    while True:
        if prof is None and todo:
            acts = todo.pop(0)
            if torch.profiler.ProfilerActivity.CPU in acts:
                hooks = system.module_hooks()
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            t_seg, first = time.perf_counter(), len(records)
        records.append(system.transition(traffic.next()))
        now = time.perf_counter()
        if prof is not None and now - t_seg >= mix["trace_seconds"]:
            sync()
            traces.append((prof, time.perf_counter() - t_seg, len(records) - first))
            prof.stop()
            prof = None
            for h in hooks:
                h.remove()
            hooks = []
            if not todo:
                t_after, n_after = time.perf_counter(), len(records)
        if now - t0 >= seconds and prof is None and not todo and len(records) > n_after:
            break
    t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(json.dumps({"transitions": len(records), "paths": sorted({r.path for r in records}),
                      "traced": [n for _, _, n in traces], "walls": [round(r.wall_s, 4) for r in records]}),
          flush=True)

    # with --trace 1, host-clock rates are read after the traces: the
    # profiler's host overhead and its flush stay out of them
    tr = [(reduce(p, seg_s), n) for p, seg_s, n in traces]
    run = Run(cfg=cfg, records=records[n_after:], window_s=t_end - t_after, setup_s=setup_s, peak_bytes=peak,
              **({"trace": tr[0][0], "traced": tr[0][1], "scoped": tr[1][0], "scoped_n": tr[1][1]} if tr else {}))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metric_names(bench, kind, workload):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"attempted": len(records), "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": int(peak)}}
    if tr:
        # the idle share from the device's own profile; gaps named from the
        # attributed one (their lengths there include the host profile's cost)
        result["device"].update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.scoped.idle_gaps()}

    kept = [chk.keep(records[i]) for i in chk.sample(len(records), cell_check["sample_transitions"], seed)]
    call = system.call
    del records, run, tr, traces
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    try:
        numbers = chk.check(cfg, cell_check, mix, kept, seed, device)
    finally:
        call.cleanup()
    print(json.dumps({"checked": len(kept), "check_s": time.perf_counter() - t_check}), flush=True)
    correct, table = chk.verdict(numbers, cell_check["limits"])
    result = {"correct": correct, **result, "check": table}
    return result


def _profiles(torch, cuda: bool) -> tuple[list, list]:
    """The traced run's two profiles' activities: the device alone (CUPTI's
    kernels and launches: busy and window seconds, kernels, top ops), then
    the host too (the bench:: ranges that attribute device time)."""
    cpu, dev = torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
    return ([dev], [cpu, dev]) if cuda else ([cpu], [cpu])


def reader(metric: str):
    """A metric's reader, benchmark/metrics/<name>.py; a name with a dot
    (transition_s.predictive) is read by the reader of what precedes it, for
    the cells that report it under that name."""
    return importlib.import_module(f"benchmark.metrics.{metric.split('.')[0]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load("BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the benchmark may not load: {bad}", file=sys.stderr)
        return 3
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
