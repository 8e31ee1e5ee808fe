"""The port's example scripts (latentblending_tpu_torch/apps/), each through
its main(argv) with --tiny --device cpu and a short duration:

- example_single_trans: 1 s at 30 fps → an MJPEG MP4 of 30 samples of
  128x128; with --image1 (a PNG read with PIL) the first keyframe is the
  picture's trajectory; --deepen 2 writes a second movie of 30 samples
  from a tree of 14 keyframes;
- example_multi_trans --loop: 4 prompts and the loop back, 4 parts of 0.5 s
  → 60 samples;
- example_multi_trans_json: replays a project written by the JAX package's
  MovieProject.save (3 keyframes, 2 parts of 0.5 s → 30 samples);
- the scripts run on the card unless --device says otherwise: on a host
  without one, the default raises.
"""
import numpy as np
import pytest
import torch

from latentblending_tpu_torch.apps import example_multi_trans, example_multi_trans_json, example_single_trans
from latentblending_tpu_torch.video.mjpeg_mp4 import read_samples
from tests import torch_port_util  # noqa: F401  (one torch thread per test worker)


def _samples(fp) -> int:
    samples, hw, fps = read_samples(str(fp))
    assert tuple(hw) == (128, 128) and fps == 30
    assert all(s[:2] == b"\xff\xd8" and s[-2:] == b"\xff\xd9" for s in samples)
    return len(samples)


def test_single_trans(tmp_path):
    from PIL import Image

    png = tmp_path / "kf1.png"
    yy, xx = np.mgrid[0:96, 0:80]
    Image.fromarray(np.stack([xx * 3, yy * 2, (xx + yy)], -1).astype(np.uint8)).save(png)
    out = tmp_path / "single.mp4"
    be = example_single_trans.main(["--tiny", "--device", "cpu", "--out", str(out), "--duration", "1",
                                    "--image1", str(png), "--deepen", "2", "--similarity_metric", "lpips"])
    assert _samples(out) == 30 and _samples(tmp_path / "single.deepened.mp4") == 30
    assert len(be.tree_final_imgs) == 14 and be.similarity_metric == "lpips"
    assert be.image1_lowres is not None and be.tree_fracts[0] == 0.0


def test_multi_trans_loop(tmp_path):
    out = tmp_path / "multi.mp4"
    be = example_multi_trans.main(["--tiny", "--device", "cpu", "--out", str(out), "--duration_single_trans", "0.5",
                                   "--loop", "--placement_policy", "predictive"])
    assert _samples(out) == 4 * 15 and be.placement_policy == "predictive"


def test_multi_trans_json_replays_a_jax_project(tmp_path):
    from latentblending_tpu.engine.session import Keyframe, MovieProject

    fp = tmp_path / "project.json"
    MovieProject([Keyframe("photo of a house", 911), Keyframe("photo of a lake", 951, "blurry"),
                  Keyframe("photo of a city", 213)], width=512, height=512, num_inference_steps=4).save(str(fp))
    be = example_multi_trans_json.main([str(fp), "--tiny", "--device", "cpu", "--duration_single_trans", "0.5"])
    assert _samples(tmp_path / "project.mp4") == 2 * 15 and be.prompt2 == "photo of a city"


def test_scripts_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example_single_trans.main(["--tiny", "--out", str(tmp_path / "x.mp4")])
