"""Readings that the cells' limits are set from (benchmark/checks/*.json):
the program's numbers over many seeds (the lower readings) and the
control's (the upper readings), at the cell's own size, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 [--control-seeds 1 2 3]

For each seed the program is built from it, runs one warm-up transition
and the first `--transitions` requests of the cell's traffic, and is freed;
the reference replays them and judges them as a run does. With a control
seed, the control replays the same transitions too and is judged the same
way: the plain reference put in the program's place, computed one step
below the configuration's precisions (the float32 parts on TF32, and
where the architecture module says, SDXL's UNet, matmuls and convolutions
through float8 e4m3). Prints one JSON line per seed and side. Not run by
the benchmark's runs.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark import calls, check as chk
from benchmark.reference.transition import Models, Transition, Tree
from benchmark.run import cell_files, load


def readings(bench: dict, workload: str, seed: int, transitions: int, control: bool, device: str,
             root: str | None = None) -> list[dict]:
    from benchmark.system import System
    from benchmark.traffic import Traffic

    kw = {} if root is None else {"root": root}
    _, cfg, mix, cell_check = cell_files(bench, workload, **kw)
    system = System(cfg, mix, seed, device)
    traffic = Traffic(mix, seed)
    system.transition(traffic.warmup())
    kept = [chk.keep(system.transition(traffic.next())) for _ in range(transitions)]
    system.close()
    system.call.cleanup()
    del system
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    policy, path = mix["placement_policy"], cell_check["path"]
    fmt = calls.load(mix["call"]).KEYFRAME_FORMAT
    models = Models(cfg, seed, device)
    refs = []
    rows = []
    for req, tree, _movie in kept:
        ref = Transition(models, req, policy, keyframe_format=fmt)
        out = ref.run(tree)
        refs.append((ref, out))
        rows.append(dict(side="program", seed=seed, **chk.judge(ref, out, tree, path)[0]))
    if control:
        ctl_models = Models(cfg, seed, device, control=True)
        for (req, tree, _movie), (ref, out) in zip(kept, refs):
            ctl = Transition(ctl_models, req, policy, control=True, keyframe_format=fmt).run(tree)
            ctree = Tree(ctl["fracts"], ctl["idx"], ctl["keyframes"].cpu().numpy(), ctl["finals"], path)
            rows.append(dict(side="control", seed=seed, **chk.judge(ref, out, ctree, path)[0]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--transitions", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = load("BENCHMARK.json")
    for seed in args.seeds:
        for row in readings(bench, args.workload, seed, args.transitions, seed in args.control_seeds, "cuda"):
            print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
