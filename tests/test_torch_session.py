"""Movie-project sessions in the port (latentblending_tpu_torch/engine/
session.py) against the JAX package's, on the CPU.

- MovieProject writes the same JSON bytes as the JAX package's and loads
  the JAX package's files (the reference UI's schema).
- A 3-keyframe tiny-turbo project through both packages'
  run_multi_transition (the JAX package's seeded noise in the port, both
  writers on MJPEG with the coefficient lerp): equal sample counts and moov
  fields, the merged report (every part's gaps, nothing pending), each
  part's keyframe planes within KEYFRAME_LSB of the JAX package's (the
  tolerance of tests/test_torch_outputs.py) and the port's movie byte-equal
  to the JAX writer's movie of the port's own keyframes; decoded frames
  are held on their mean (tests/test_torch_movie.py says why not their max).
- The same project with loop=True and overlap_write off, in the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.engine import session as jsession
from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu.video import writer as jwriter
from latentblending_tpu_torch.engine import session as tsession
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.video import mjpeg_mp4 as tmp4
from tests.test_torch_movie import DECODED_MEAN_LSB, KEYFRAME_LSB, _decoded, _max_lsb, _mean_lsb
from tests.torch_port_util import inject_jax_noise, mjpeg_writers, port_holder_from_jax


def _project(mod):
    kfs = [mod.Keyframe("a forest at dawn", 1), mod.Keyframe("a city at night", 2, "blurry"),
           mod.Keyframe("a desert", 3)]
    return mod.MovieProject(keyframes=kfs, width=128, height=128, num_inference_steps=4)


def test_project_json_matches_jax(tmp_path):
    _project(tsession).save(str(tmp_path / "t.json"))
    _project(jsession).save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    loaded = tsession.MovieProject.load(str(tmp_path / "j.json"))
    assert loaded == _project(tsession)
    assert loaded.keyframes[1] == tsession.Keyframe("a city at night", 2, "blurry", None)


def test_run_multi_transition_matches_jax(tmp_path, monkeypatch):
    mjpeg_writers(monkeypatch, "1")
    monkeypatch.delenv("LB_FUSED", raising=False)
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    tdh = port_holder_from_jax(jdh, "tiny-turbo")
    inject_jax_noise(tdh, jdh)
    planes = {"j": [], "t": []}
    for name, be, mod in (("j", JEngine(jdh, run_benchmark=False), jsession), ("t", TEngine(tdh), tsession)):
        be.set_branching(nmb_max_branches=4)
        # the planes each part ships: keep what the streaming call returns
        stream = be.run_transition_streaming

        def keep(*args, _stream=stream, _name=name, _be=be, **kw):
            handles = _stream(*args, **kw)
            dev = _be._imgs_dev
            planes[_name].append(np.asarray(_be.dh.to_i420_device(
                torch.stack(dev) if _name == "t" else jnp.stack(dev))))
            return handles

        monkeypatch.setattr(be, "run_transition_streaming", keep)
        mod.run_multi_transition(be, _project(mod), str(tmp_path / f"{name}.mp4"), duration_single_trans=1.0, fps=8)
        assert be.last_writer_backend == "mjpeg+coef-lerp"
        rep = be.last_report
        assert len(be.tree_similarities) == len(be.tree_final_imgs) - 1 == 5
        assert rep.sims_pending is None and len(rep.lpips_gaps) == 2 * 5
        assert rep.phases["lpips_sync"]["count"] == 2
    t_samples, hw, fps = tmp4.read_samples(str(tmp_path / "t.mp4"))
    assert (len(t_samples), hw, fps) == (16, (128, 128), 8.0)
    assert (len(t_samples), hw, fps) == (len(tmp4.read_samples(str(tmp_path / "j.mp4"))[0]), hw, fps)
    for tp, jp in zip(planes["t"], planes["j"]):
        assert _max_lsb(list(tp), list(jp)) <= KEYFRAME_LSB
    # the JAX writer on the port's keyframe planes gives the port's movie
    ms = jwriter.MovieSaver(str(tmp_path / "x.mp4"), fps=8, shape_hw=(128, 128))
    for part in planes["t"]:
        jwriter.write_frames_interp(ms, list(part), 8)
    ms.finalize()
    assert (tmp_path / "t.mp4").read_bytes() == (tmp_path / "x.mp4").read_bytes()
    assert _mean_lsb(_decoded(tmp_path / "t.mp4"), _decoded(tmp_path / "j.mp4")) <= DECODED_MEAN_LSB


def test_loop_without_overlap(tmp_path, monkeypatch):
    monkeypatch.setenv("LB_OVERLAP_PARTS", "0")
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    be = TEngine(SDXLHolder.from_random("tiny-turbo", seed=1, dtype=torch.float32, device="cpu"))
    be.set_branching(nmb_max_branches=3)
    fp = tsession.run_multi_transition(be, _project(tsession), str(tmp_path / "loop.mp4"),
                                       duration_single_trans=1.0, fps=8, loop=True)
    samples, hw, _ = tmp4.read_samples(fp)
    assert len(samples) == 24 and hw == (128, 128)  # 3 transitions x 8 frames
    assert be.prompt2 == "a forest at dawn" and len(be.last_report.lpips_gaps) == 3 * 4
    with pytest.raises(AssertionError, match="two keyframes"):
        tsession.run_multi_transition(be, tsession.MovieProject([tsession.Keyframe("x")]), str(tmp_path / "x.mp4"))
