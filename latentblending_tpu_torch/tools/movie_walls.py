"""Warm walls of the transition and of its movie on one card, to compare
two checkouts of the port in one call.

    python3 latentblending_tpu_torch/tools/movie_walls.py [--root DIR] [--reps 6]

Imports the latentblending_tpu_torch package under DIR (default: this
file's checkout) and takes the workload from this checkout's chip_smoke.py,
so that it is the one chip_smoke.py's movie phase checks: its SDXL-Turbo
512² engine (`_run_engine`: random weights from seed 0, its prompts), its
SEEDS, MOVIE_SECONDS and MOVIE_FPS. Runs one transition and one movie
cold, then `reps` turns of run_transition and run_movie_transition, fused
(LB_FUSED=1), each ended by torch.cuda.synchronize() and timed by the host
clock. Prints the card (nvidia-smi name and power limit)
and one JSON line: each turn's walls, the movie's movie_write phase (the
writer, from the first keyframe's encode to the file's end), their medians
and the JPEG kernels' calls in the last movie. To compare two checkouts,
run it from each in turns (parent, change, change, parent) in one call.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (it imports the port lazily,
    so its engine is built from whichever package sys.path finds first)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(CHECKOUT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    smoke = _chip_smoke()
    ap.add_argument("--root", default=CHECKOUT)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=smoke.MOVIE_SECONDS)
    ap.add_argument("--fps", type=int, default=smoke.MOVIE_FPS)
    args = ap.parse_args(argv)
    seeds = smoke.SEEDS
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.modules["jax"] = None  # the port runs without JAX
    os.environ["LB_FUSED"] = "1"
    import torch

    if not torch.cuda.is_available():
        print("movie_walls: needs a CUDA device", file=sys.stderr)
        return 2
    from latentblending_tpu_torch.precision import disable_tf32
    from latentblending_tpu_torch.video import jpeg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    disable_tf32()
    be = smoke._run_engine(torch, "sdxl-turbo", "cuda", torch.bfloat16)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls: dict = {"transition": [], "movie": [], "movie_write": []}
    with tempfile.TemporaryDirectory(prefix="lb_walls_") as tmp:
        fp = os.path.join(tmp, "movie.mp4")

        def movie():
            be.run_movie_transition(fp, args.seconds, fps=args.fps, fixed_seeds=seeds)

        cold = {"transition": timed(lambda: be.run_transition(fixed_seeds=seeds)), "movie": timed(movie)}
        for _ in range(args.reps):
            walls["transition"].append(timed(lambda: be.run_transition(fixed_seeds=seeds)))
            walls["movie"].append(timed(movie))
            walls["movie_write"].append(be.last_report.phases["movie_write"]["total_s"])
        calls = {k: be.last_report.counters.get(k, 0) for k in ("J1", "J2", "J3")}
        size = os.path.getsize(fp)
    medians = {k: statistics.median(v) for k, v in walls.items()}
    medians["movie - transition"] = medians["movie"] - medians["transition"]
    print(json.dumps({"root": root, "package": os.path.dirname(os.path.dirname(jpeg.__file__)), "card": card,
                      "cold": cold, "walls": walls, "medians": medians, "last_movie_calls": calls,
                      "movie_bytes": size}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
