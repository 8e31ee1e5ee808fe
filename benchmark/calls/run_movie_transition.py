"""BlendingEngine.run_movie_transition: one transition written as an MJPEG
MP4 of the mix's `movie_seconds` at its `fps`, under TMPDIR, complete when
the call returns with the file closed. The files stay until the check has
read them.

Its check numbers, from the JPEG samples of three gaps (the first, the
middle and the last), decoded by the reference's baseline decoder into
their planes:
- movie_key_coef: the share of the quantized coefficients of the keyframe
  samples at the gaps' ends that differ by more than 1 from the reference's
  coding of the program's keyframe (the reference's decode of the
  program's final latents, as I420 planes, its float DCT and the file's
  quantizers: J1, J3; 1 allows libjpeg's integer DCT);
- movie_mid_coef: the share of the quantized coefficients of each gap's
  middle in-between sample that differ by more than 1 from the lerp of its
  gap's two keyframe samples' coefficients at the frame's fraction,
  rounded half away from zero (J2, J3; 1 allows float32's rounding);
and a structure fault where the movie has another number of frames than
its length asks.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from benchmark.reference import jpeg
from benchmark.reference.vae import pm1_to_i420

KEYFRAME_FORMAT = "i420"
NUMBERS = ("movie_key_coef", "movie_mid_coef")


class Call:
    def __init__(self, mix: dict):
        self.mix = mix
        self.dir = tempfile.TemporaryDirectory(prefix="bench-movies-")

    def call(self, engine, req, n: int):
        movie = os.path.join(self.dir.name, f"transition_{n}.mp4")
        imgs = engine.run_movie_transition(movie, self.mix["movie_seconds"], self.mix["fps"],
                                           fixed_seeds=[req.seed1, req.seed2])
        return imgs, movie

    def cleanup(self) -> None:
        self.dir.cleanup()


def _lerp_round(a, b, t: float):
    v = (1.0 - t) * a + t * b
    return np.trunc(v + np.where(v >= 0, 0.5, -0.5))


def _share_off(got: list, want: list) -> float:
    """Share of coefficients more than 1 apart, over all components."""
    return sum(int((np.abs(g - w) > 1).sum()) for g, w in zip(got, want)) / sum(g.size for g in got)


def judge_movie(dec_pm1, k: int, movie: str, frames: int) -> dict:
    """The movie numbers of one transition of k keyframes (module docstring)."""
    with open(movie, "rb") as f:
        samples = jpeg.mjpeg_frames(f.read())
    if len(samples) != frames:
        return {"movie_key_coef": 1.0, "movie_mid_coef": 1.0, "structure": 1}
    counts = jpeg.frame_schedule(k, frames)
    at = [i + sum(counts[:i]) for i in range(k)]
    planes = [p.cpu().numpy() for p in pm1_to_i420(dec_pm1)]
    key, mid = 0.0, 0.0
    for g in sorted({0, (k - 1) // 2, k - 2}):
        coef = {}
        for kf in (g, g + 1):
            coef[kf], qts, _, _ = jpeg.decode_coefficients(samples[at[kf]])
            want = [jpeg.quantize_plane(p[kf], q) for p, q in zip(planes, qts)]
            key = max(key, _share_off(coef[kf], want))
        if counts[g]:
            j = (counts[g] + 1) // 2
            m = jpeg.decode_coefficients(samples[at[g] + j])[0]
            t = j / (counts[g] + 1)
            mid = max(mid, _share_off(m, [_lerp_round(a, b, t) for a, b in zip(coef[g], coef[g + 1])]))
    return {"movie_key_coef": key, "movie_mid_coef": mid, "structure": 0}


def judge(dec_pm1, tree, movie, mix: dict) -> dict:
    if dec_pm1 is None:
        return {"movie_key_coef": 1.0, "movie_mid_coef": 1.0}
    return judge_movie(dec_pm1, len(tree.fracts), movie, round(mix["fps"] * mix["movie_seconds"]))
