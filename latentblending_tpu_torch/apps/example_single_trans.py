"""Single-transition example (the JAX package's apps/example_single_trans.py).

With real SDXL-Turbo weights, on the card:
    python -m latentblending_tpu_torch.apps.example_single_trans --snapshot /path/to/sdxl-turbo
Weightless run (tiny random model):
    python -m latentblending_tpu_torch.apps.example_single_trans --tiny
--device cpu runs on the CPU. --image1/--image2 read JPEGs with the port's decoder,
other picture formats with PIL.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from latentblending_tpu_torch.engine.blending import BlendingEngine
from latentblending_tpu_torch.precision import disable_tf32
from latentblending_tpu_torch.runtime.holder import SDXLHolder


def _read_image(path: str) -> np.ndarray:
    """A keyframe picture as uint8 RGB: .jpg/.jpeg with the port's own
    decoder (video/jpeg_decode.py, no PIL needed); other formats need PIL."""
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        from latentblending_tpu_torch.video.jpeg_decode import decode_rgb

        with open(path, "rb") as f:
            return decode_rgb(f.read())
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"reading {path!r} needs PIL (only .jpg/.jpeg are read without it)") from e
    return np.array(Image.open(path).convert("RGB"))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--snapshot", type=str, default=None, help="HF snapshot dir (sdxl-turbo)")
    p.add_argument("--tiny", action="store_true", help="tiny random model (no weights needed)")
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda, or cpu)")
    p.add_argument("--out", type=str, default="movie_example1.mp4")
    p.add_argument("--duration", type=float, default=12.0)
    p.add_argument("--scheduler", default=None, choices=["euler", "euler_ancestral", "dpmpp_2m"],
                   help="override the checkpoint's solver (dpmpp_2m: ~same quality at half the steps)")
    p.add_argument("--steps", type=int, default=None, help="num_inference_steps override")
    p.add_argument("--similarity_metric", default=None, choices=["lpips", "nlpd"],
                   help="branch-placement metric (default: nlpd unless LPIPS weights are supplied)")
    p.add_argument("--placement_policy", default="measured", choices=["measured", "predictive"],
                   help="measured: the reference's argmax placement; predictive: predicted gap halving, "
                        "no device read between levels")
    p.add_argument("--image1", type=str, default=None, help="JPG (or, with PIL, PNG) to pin as the FIRST keyframe")
    p.add_argument("--image2", type=str, default=None, help="JPG (or, with PIL, PNG) to pin as the SECOND keyframe")
    p.add_argument("--deepen", type=int, default=0, metavar="K",
                   help="after the movie, extend_transition with K extra keyframes at a deeper injection "
                        "index and write <out>.deepened.mp4")
    args = p.parse_args(argv)

    disable_tf32()
    if args.tiny or args.snapshot is None:
        dh = SDXLHolder.from_random("tiny-turbo", dtype=torch.float32, device=args.device)
    else:
        dh = SDXLHolder.from_pretrained(args.snapshot, device=args.device)

    if args.scheduler:
        dh.set_scheduler_type(args.scheduler)
    be = BlendingEngine(dh, similarity_metric=args.similarity_metric)
    be.placement_policy = args.placement_policy
    if args.steps:
        be.set_num_inference_steps(args.steps)
    be.set_prompt1("underwater landscape, fish, und the sea, incredible detail, high resolution")
    be.set_prompt2("rendering of an alien planet, strange plants, strange creatures, surreal")
    be.set_negative_prompt("blurry, ugly, pale")

    recycle1 = recycle2 = False
    if args.image1:
        be.set_keyframe1_image(_read_image(args.image1))
        recycle1 = True
        print(f"keyframe 1 pinned to {args.image1}")
    if args.image2:
        be.set_keyframe2_image(_read_image(args.image2))
        recycle2 = True
        print(f"keyframe 2 pinned to {args.image2}")

    t0 = time.time()
    be.run_transition(recycle_img1=recycle1, recycle_img2=recycle2, fixed_seeds=[420, 421])
    print(f"transition computed in {time.time() - t0:.2f}s ({len(be.tree_final_imgs)} keyframes)")
    be.write_movie_transition(args.out, duration_transition=args.duration)
    print(f"movie written to {args.out}")

    if args.deepen > 0:
        # deepen near the end of the schedule: cheap stems, placed by the
        # live gap similarities; nothing already computed is run again
        idx_deep = max(1, int(round(be.num_inference_steps * 0.75)))
        t0 = time.time()
        be.extend_transition([idx_deep], [args.deepen])
        fp2 = os.path.splitext(args.out)[0] + ".deepened.mp4"
        print(f"tree deepened by {args.deepen} stems at idx {idx_deep} in {time.time() - t0:.2f}s "
              f"({len(be.tree_final_imgs)} keyframes)")
        be.write_movie_transition(fp2, duration_transition=args.duration)
        print(f"deepened movie written to {fp2}")
    return be


if __name__ == "__main__":
    main()
