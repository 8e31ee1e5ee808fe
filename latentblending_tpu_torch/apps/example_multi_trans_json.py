"""Replay a saved movie-project JSON (the JAX package's
apps/example_multi_trans_json.py): a settings header at data[0], then one
prompt/negative/seed record per keyframe, as MovieProject.save writes.

    python -m latentblending_tpu_torch.apps.example_multi_trans_json project.json --snapshot /path/to/sdxl-turbo
"""
from __future__ import annotations

import argparse

import torch

from latentblending_tpu_torch.engine.blending import BlendingEngine
from latentblending_tpu_torch.engine.session import MovieProject, run_multi_transition
from latentblending_tpu_torch.precision import disable_tf32
from latentblending_tpu_torch.runtime.holder import SDXLHolder


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("fp_json", type=str, help="movie project json")
    p.add_argument("--snapshot", type=str, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, or cpu)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--duration_single_trans", type=float, default=10.0)
    args = p.parse_args(argv)

    disable_tf32()
    project = MovieProject.load(args.fp_json)
    if args.tiny or args.snapshot is None:
        dh = SDXLHolder.from_random("tiny-turbo", dtype=torch.float32, device=args.device)
        project.width, project.height = dh.spec.default_size
    else:
        dh = SDXLHolder.from_pretrained(args.snapshot, device=args.device)

    be = BlendingEngine(dh)
    fp_out = args.out or args.fp_json.replace(".json", ".mp4")
    run_multi_transition(be, project, fp_out, duration_single_trans=args.duration_single_trans)
    return be


if __name__ == "__main__":
    main()
