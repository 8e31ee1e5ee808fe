"""Chained multi-prompt movie (the JAX package's apps/example_multi_trans.py):
four prompts, latent recycling between consecutive transitions, all parts
into one movie.

    python -m latentblending_tpu_torch.apps.example_multi_trans --snapshot /path/to/sdxl-turbo
    python -m latentblending_tpu_torch.apps.example_multi_trans --tiny --loop
"""
from __future__ import annotations

import argparse

import torch

from latentblending_tpu_torch.engine.blending import BlendingEngine
from latentblending_tpu_torch.engine.session import Keyframe, MovieProject, run_multi_transition
from latentblending_tpu_torch.precision import disable_tf32
from latentblending_tpu_torch.runtime.holder import SDXLHolder


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--snapshot", type=str, default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, or cpu)")
    p.add_argument("--out", type=str, default="movie_example2.mp4")
    p.add_argument("--duration_single_trans", type=float, default=10.0)
    p.add_argument("--scheduler", default=None, choices=["euler", "euler_ancestral", "dpmpp_2m"])
    p.add_argument("--similarity_metric", default=None, choices=["lpips", "nlpd"])
    p.add_argument("--placement_policy", default="measured", choices=["measured", "predictive"],
                   help="'predictive' places all levels by predicted gap splitting, with no device read "
                        "between levels")
    p.add_argument("--loop", action="store_true",
                   help="append a final transition back to the first keyframe (seamless loop)")
    args = p.parse_args(argv)

    disable_tf32()
    if args.tiny or args.snapshot is None:
        dh = SDXLHolder.from_random("tiny-turbo", dtype=torch.float32, device=args.device)
        size, steps = (128, 128), 4
    else:
        dh = SDXLHolder.from_pretrained(args.snapshot, device=args.device)
        size, steps = (1024, 1024), 30 if not dh.is_sdxl_turbo else 4

    if args.scheduler:
        dh.set_scheduler_type(args.scheduler)
    be = BlendingEngine(dh, similarity_metric=args.similarity_metric)
    be.placement_policy = args.placement_policy

    prompts = [
        "photo of a house, high detail",
        "photo of an elephant in african savannah",
        "photo of a strange animal, surreal",
        "photo of a city skyline at night",
    ]
    seeds = [911, 951, 213, 441]
    project = MovieProject(
        keyframes=[Keyframe(pr, sd) for pr, sd in zip(prompts, seeds)],
        width=size[0], height=size[1], num_inference_steps=steps,
    )
    run_multi_transition(be, project, args.out, duration_single_trans=args.duration_single_trans, loop=args.loop)
    return be


if __name__ == "__main__":
    main()
