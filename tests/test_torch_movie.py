"""The movie path of the port against the JAX package, on the CPU.

- write_frames_interp from the same uint8 keyframes (RGB, and packed
  I420) with LB_WRITER=mjpeg and LB_COEF_LERP=1 in both packages: the two
  MP4 files are byte-equal (keyframe samples libjpeg's, in-between samples
  the coefficient lerp's, the same muxer).
- The device-batch route (keyframe handles holding their fetch chunk's
  uint8 batch, as the engine's streaming handles do; CPU tensors here):
  one J1 call a chunk after the first keyframe's probe, no host read, and
  an MP4 byte-equal to the host route's and to the JAX writer's, I420 and
  RGB; run_movie_transition codes each fetch chunk with one J1 call.
- The pixel path (LB_COEF_LERP=0 in both): equal sample counts and
  byte-equal files against the JAX package's `_lerp_u8` rule (its native
  fixed-point SIMD lerp, host code the port does not carry, rounds where
  `_lerp_u8` truncates: it is switched off there), so frames decoded by cv2
  are equal, within 1 LSB a fortiori; one J1 and one J3 call a gap (its
  in-between frames and the next keyframe) after the first frame's probe,
  a long gap (MAX_CALL_COEF_BYTES lowered) in batches of that many frames,
  in order.
- calibrate_quality settles on the JAX writer's quality, with the same
  bytes, on a 256² noise frame whose q100 sample exceeds the byte budget.
- Tiny-turbo run_movie_transition and then write_movie_transition on both
  packages, with the JAX package's seeded noise in the port: the same
  sample count and moov fields and the backend "mjpeg+coef-lerp"; the I420
  keyframe planes both movies come from within KEYFRAME_LSB, the keyframe
  tolerance of the parity tests (tests/test_torch_outputs.py), and each
  port movie byte-equal to the JAX writer's movie of the port's own
  keyframes (planes, then their RGB conversion), so the movie layer adds
  no difference. Decoded frames are not held to KEYFRAME_LSB: one keyframe
  value 1 LSB off can move a quantized coefficient by one step, which moves
  its block's decoded pixels by up to that coefficient's quantizer step
  (measured: max 7, mean ≤ 0.022 LSB); their mean is held to DECODED_MEAN_LSB.
- The fill-up (fillup_plan, add_frames_linear_interp and the device
  fill-up), concatenate_movies and read_samples across the two packages,
  and the writer's refusals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu.video import frames as jframes
from latentblending_tpu.video import mjpeg_mp4 as jmp4
from latentblending_tpu.video import writer as jwriter
from latentblending_tpu.video.i420 import rgb_to_i420
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.engine.blending import _fetch_keyframes, resolve_image
from latentblending_tpu_torch.ops.schedules import frame_insert_counts
from latentblending_tpu_torch.runtime.holder import SDXLHolder as THolder
from latentblending_tpu_torch.video import frames as tframes
from latentblending_tpu_torch.video import jpeg as tjpeg
from latentblending_tpu_torch.video import mjpeg_mp4 as tmp4
from latentblending_tpu_torch.video import writer as twriter
from tests.torch_port_util import inject_jax_noise, mjpeg_writers, port_holder_from_jax

KEYFRAME_LSB = 1  # uint8 I420 keyframe planes, port vs JAX
# mean |decoded port frame - decoded JAX frame|: a tenth of the keyframe
# tolerance (measured 0.022 at most on these movies)
DECODED_MEAN_LSB = 0.1


def _keyframes(n: int = 4, h: int = 128, w: int = 128) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.clip(np.stack([xx * 2 + 30 * k, yy * 2 - 20 * k, (xx + yy) // 2 + 10 * k], -1)
                    + rng.integers(0, 20, (h, w, 3)), 0, 255).astype(np.uint8) for k in range(n)]


def _write_both(tmp_path, keys, target, name="m"):
    jms = jwriter.MovieSaver(str(tmp_path / f"j_{name}.mp4"), fps=30, shape_hw=(128, 128))
    jwriter.write_frames_interp(jms, keys, target)
    jms.finalize()
    tms = twriter.MovieSaver(str(tmp_path / f"t_{name}.mp4"), fps=30, shape_hw=(128, 128), device="cpu")
    twriter.write_frames_interp(tms, keys, target)
    tms.finalize()
    return jms, tms


def _decoded(fp) -> list[np.ndarray]:
    import cv2

    samples, _, _ = tmp4.read_samples(str(fp))
    return [cv2.imdecode(np.frombuffer(s, np.uint8), cv2.IMREAD_COLOR) for s in samples]


def _max_lsb(a: list, b: list) -> int:
    assert len(a) == len(b)
    return max(int(np.abs(x.astype(int) - y.astype(int)).max()) for x, y in zip(a, b))


@pytest.mark.parametrize("fmt", ["rgb", "i420"])
def test_write_frames_interp_bytes_equal_jax(fmt, tmp_path, monkeypatch):
    mjpeg_writers(monkeypatch, "1")
    keys = _keyframes()
    if fmt == "i420":
        keys = [rgb_to_i420(k) for k in keys]
    jms, tms = _write_both(tmp_path, keys, 30)
    assert jms.used_coef_lerp and tms.used_coef_lerp and jms.backend == tms.backend == "mjpeg"
    assert tms.nmb_frames == jms.nmb_frames == 30 and tms.jpeg_quality == jms.jpeg_quality == 90
    assert (tmp_path / "t_m.mp4").read_bytes() == (tmp_path / "j_m.mp4").read_bytes()


def test_pixel_path_matches_jax(tmp_path, monkeypatch):
    mjpeg_writers(monkeypatch, "0")
    monkeypatch.setattr(jframes, "_native_lerp_into", None)  # the JAX package's `_lerp_u8` rule
    keys = [rgb_to_i420(k) for k in _keyframes(3)]
    jms, tms = _write_both(tmp_path, keys, 20)
    assert not jms.used_coef_lerp and not tms.used_coef_lerp
    assert tms.nmb_frames == jms.nmb_frames == 20
    assert (tmp_path / "t_m.mp4").read_bytes() == (tmp_path / "j_m.mp4").read_bytes()
    assert _max_lsb(_decoded(tmp_path / "t_m.mp4"), _decoded(tmp_path / "j_m.mp4")) <= 1


def _record_calls(monkeypatch) -> tuple[list, list]:
    """The frames of every J1 (fdct_quant) and J3 (huffman_scan_batch) call, in order."""
    j1, j3 = [], []
    fdct, huff = tjpeg.fdct_quant, tjpeg.huffman_scan_batch

    def fdct_quant(frames, quality, fmt="i420"):
        j1.append(frames.shape[0])
        return fdct(frames, quality, fmt)

    def huffman_scan_batch(coef):
        j3.append(coef.shape[0])
        return huff(coef)

    monkeypatch.setattr(tjpeg, "fdct_quant", fdct_quant)
    monkeypatch.setattr(tjpeg, "huffman_scan_batch", huffman_scan_batch)
    return j1, j3


@pytest.mark.parametrize("fmt", ["i420", "rgb"])
def test_device_batch_route_bytes_equal_host_route_and_jax(fmt, tmp_path, monkeypatch):
    mjpeg_writers(monkeypatch, "1")
    keys = _keyframes(10)
    if fmt == "i420":
        keys = [rgb_to_i420(k) for k in keys]
    # the engine's streaming handles: chunks of 4 keyframes, each handle its chunk's batch and row
    handles = [h for j in range(0, 10, 4) for h in _fetch_keyframes(torch.from_numpy(np.stack(keys[j:j + 4])))]
    j1, _ = _record_calls(monkeypatch)
    reads = []

    def resolve(h):
        reads.append(h)
        return resolve_image(h, {})

    ms = twriter.MovieSaver(str(tmp_path / "dev.mp4"), fps=30, shape_hw=(128, 128), device="cpu")
    twriter.write_frames_interp(ms, handles, 30, resolve=resolve)
    ms.finalize()
    assert reads == [] and ms.used_coef_lerp and ms.jpeg_quality == 90
    assert j1 == [1, 4, 4, 2]  # keyframe 0's one probe, then one call a chunk
    del j1[:]
    _write_both(tmp_path, keys, 30)  # the host route: keyframe 0's probe, then one call a keyframe
    assert j1 == [1] * 10
    assert (tmp_path / "dev.mp4").read_bytes() == (tmp_path / "t_m.mp4").read_bytes() == \
        (tmp_path / "j_m.mp4").read_bytes()


def test_run_movie_transition_codes_each_fetch_chunk_once(tmp_path, monkeypatch):
    mjpeg_writers(monkeypatch, "1")
    monkeypatch.delenv("LB_FUSED", raising=False)
    monkeypatch.delenv("LB_KEYFRAME_I420", raising=False)
    monkeypatch.delenv("LB_FETCH_CHUNK", raising=False)
    be = TEngine(THolder.from_random("tiny-turbo", seed=0, dtype=torch.float32, device="cpu"))
    be.set_prompt1("photo of a forest at dawn")
    be.set_prompt2("photo of a city at night")
    j1, j3 = _record_calls(monkeypatch)
    be.run_movie_transition(str(tmp_path / "m.mp4"), duration_transition=1.0, fps=24, fixed_seeds=[420, 421])
    assert len(be.tree_final_imgs) == 12 and be.last_writer_backend == "mjpeg+coef-lerp"
    assert j1 == [1, 4, 4, 4]  # the probe, then the three fetch chunks of LB_FETCH_CHUNK=4
    assert j3 == [1] + [c + 1 for c in frame_insert_counts(12, 24)]
    assert "keyframe_fetch" in be.last_report.phases


def test_pixel_path_codes_a_gap_a_call(tmp_path, monkeypatch):
    mjpeg_writers(monkeypatch, "0")
    monkeypatch.setattr(jframes, "_native_lerp_into", None)
    keys = [rgb_to_i420(k) for k in _keyframes(4)]
    j1, j3 = _record_calls(monkeypatch)
    jms, tms = _write_both(tmp_path, keys, 23)
    # the first frame's probe, then each gap's in-between frames and next keyframe
    assert j1 == j3 == [1] + [c + 1 for c in frame_insert_counts(4, 23)]
    assert tms.nmb_frames == jms.nmb_frames == sum(j1) == 23
    assert (tmp_path / "t_m.mp4").read_bytes() == (tmp_path / "j_m.mp4").read_bytes()


@pytest.mark.parametrize("per_call", [1, 3])
def test_pixel_path_splits_long_gaps_in_order(per_call, tmp_path, monkeypatch):
    """Above MAX_CALL_COEF_BYTES a gap is lerped and coded in batches of at
    most that many frames, one J1 and one J3 call each, in order; the file
    stays byte-equal to the JAX writer's."""
    mjpeg_writers(monkeypatch, "0")
    monkeypatch.setattr(jframes, "_native_lerp_into", None)
    monkeypatch.setattr(tjpeg, "MAX_CALL_COEF_BYTES", tjpeg.num_blocks(128, 128) * 64 * 2 * per_call + 1)
    keys = [rgb_to_i420(k) for k in _keyframes(3)]
    j1, j3 = _record_calls(monkeypatch)
    jms, tms = _write_both(tmp_path, keys, 20)
    gaps = [[per_call] * (c // per_call) + [c % per_call + 1] for c in frame_insert_counts(3, 20)]
    assert j1 == j3 == [1] + [n for gap in gaps for n in gap]
    assert tms.nmb_frames == jms.nmb_frames == sum(j1) == 20
    assert (tmp_path / "t_m.mp4").read_bytes() == (tmp_path / "j_m.mp4").read_bytes()


def test_calibrate_quality_matches_jax(tmp_path):
    img = np.random.default_rng(5).integers(0, 256, (256, 256, 3), dtype=np.uint8)
    jw = jmp4.MjpegMp4Writer(str(tmp_path / "j.mp4"), shape_hw=(256, 256), quality=100, max_bpp=8.0, workers=0)
    tw = tmp4.MjpegMp4Writer(str(tmp_path / "t.mp4"), shape_hw=(256, 256), quality=100, max_bpp=8.0, device="cpu")
    assert tw.byte_budget() == jw.byte_budget() == 65536
    assert len(tw.encode_frame(img, 100)) > 65536  # the budget binds
    want = jw.calibrate_quality(lambda q: jw.encode_frame(img, q))
    got = tw.calibrate_quality(lambda q: tw.encode_frame(img, q))
    assert 55 < tw.quality == jw.quality < 100
    assert got == want


def _engines(monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    monkeypatch.delenv("LB_KEYFRAME_I420", raising=False)
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    tdh = port_holder_from_jax(jdh, "tiny-turbo")
    inject_jax_noise(tdh, jdh)
    engines = (JEngine(jdh, run_benchmark=False), TEngine(tdh))
    for be in engines:
        be.set_prompt1("photo of a forest at dawn")
        be.set_prompt2("photo of a city at night")
    return engines


def _moov_fields(fp):
    samples, hw, fps = tmp4.read_samples(str(fp))
    return len(samples), hw, fps


def _mean_lsb(a: list, b: list) -> float:
    assert len(a) == len(b)
    return max(float(np.abs(x.astype(int) - y.astype(int)).mean()) for x, y in zip(a, b))


def _jax_movie_of(tmp_path, name: str, keys: list, target: int, fps: int) -> bytes:
    ms = jwriter.MovieSaver(str(tmp_path / name), fps=fps, shape_hw=(128, 128))
    jwriter.write_frames_interp(ms, keys, target)
    ms.finalize()
    return (tmp_path / name).read_bytes()


def test_movie_transitions_match_jax(tmp_path, monkeypatch):
    mjpeg_writers(monkeypatch, "1")
    jbe, tbe = _engines(monkeypatch)
    for name, be in (("j", jbe), ("t", tbe)):
        be.run_movie_transition(str(tmp_path / f"{name}_run.mp4"), duration_transition=1.0, fps=24,
                                fixed_seeds=[420, 421])
        assert be.last_writer_backend == "mjpeg+coef-lerp" and be.last_jpeg_quality == 90
        assert "movie_write" in be.last_report.phases and "keyframe_fetch" in be.last_report.phases
    assert len(tbe.tree_final_imgs) == len(jbe.tree_final_imgs) == 12
    assert _moov_fields(tmp_path / "t_run.mp4") == _moov_fields(tmp_path / "j_run.mp4") == (24, (128, 128), 24.0)
    # the I420 planes the movies were encoded from (to_i420_device of the
    # device keyframes, as run_movie_transition ships them)
    t_planes = list(tbe.dh.to_i420_device(torch.stack(tbe._imgs_dev)).numpy())
    j_planes = list(np.asarray(jbe.dh.to_i420_device(jnp.stack(jbe._imgs_dev))))
    assert _max_lsb(t_planes, j_planes) <= KEYFRAME_LSB
    assert (tmp_path / "t_run.mp4").read_bytes() == _jax_movie_of(tmp_path, "x_run.mp4", t_planes, 24, 24)
    assert _mean_lsb(_decoded(tmp_path / "t_run.mp4"), _decoded(tmp_path / "j_run.mp4")) <= DECODED_MEAN_LSB

    # the finished tree's movie: RGB keyframes, another length and rate
    for name, be in (("j", jbe), ("t", tbe)):
        be.write_movie_transition(str(tmp_path / f"{name}_write.mp4"), duration_transition=1.5, fps=10)
        assert be.last_writer_backend == "mjpeg+coef-lerp"
    assert _moov_fields(tmp_path / "t_write.mp4") == _moov_fields(tmp_path / "j_write.mp4") == (15, (128, 128), 10.0)
    assert (tmp_path / "t_write.mp4").read_bytes() == _jax_movie_of(tmp_path, "x_write.mp4", tbe.tree_final_imgs,
                                                                     15, 10)
    assert _mean_lsb(_decoded(tmp_path / "t_write.mp4"), _decoded(tmp_path / "j_write.mp4")) <= DECODED_MEAN_LSB


def test_fillup_matches_jax(monkeypatch):
    keys = _keyframes(3, 16, 24)
    for K, T in ((3, 10), (3, 3), (5, 37), (2, 2)):
        left, fract = tframes.fillup_plan(K, T)
        jl, jf = jframes.fillup_plan(K, T)
        np.testing.assert_array_equal(left, jl)
        np.testing.assert_array_equal(fract, jf)
    # the JAX package's numpy rule (its native SIMD lerp off)
    monkeypatch.setattr(jframes, "_native_lerp", None)
    got = tframes.add_frames_linear_interp(keys, nmb_frames_target=11)
    want = jframes.add_frames_linear_interp(keys, nmb_frames_target=11)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for per_call in (11, 2):  # a gap in one batch, and in batches of 2
        dev = [f for batch in tframes.stream_gaps_device(keys, 11, lambda im: im, "cpu", per_call) for f in batch]
        assert len(dev) == 11
        for g, w in zip(dev, want):
            np.testing.assert_array_equal(g.numpy(), w)
    # device fill-up (round to nearest), within 1 of the JAX package's
    got = tframes.add_frames_linear_interp_device(keys, 11, device="cpu", chunk=4)
    want = jframes.add_frames_linear_interp_device(keys, 11, chunk=4)
    assert len(got) == len(want) == 11
    assert _max_lsb(got, want) <= 1
    with pytest.raises(ValueError, match="both"):
        tframes.add_frames_linear_interp(keys, fps_target=10, nmb_frames_target=5)


def test_concatenate_and_read_across_packages(tmp_path, monkeypatch):
    mjpeg_writers(monkeypatch, "1")
    keys = _keyframes(2)
    parts = []
    for i in range(2):
        jms = jwriter.MovieSaver(str(tmp_path / f"j{i}.mp4"), fps=30, shape_hw=(128, 128))
        jwriter.write_frames_interp(jms, keys, 5 + i)
        jms.finalize()
        parts.append(str(tmp_path / f"j{i}.mp4"))
    twriter.concatenate_movies(str(tmp_path / "t.mp4"), parts)
    jwriter.concatenate_movies(str(tmp_path / "j.mp4"), parts)
    assert (tmp_path / "t.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()
    assert tmp4.read_samples(str(tmp_path / "t.mp4")) == jmp4.read_samples(str(tmp_path / "j.mp4"))
    assert len(tmp4.read_samples(str(tmp_path / "t.mp4"))[0]) == 11
    (tmp_path / "junk.mp4").write_bytes(b"not a movie")
    with pytest.raises(ValueError, match="MJPEG"):
        twriter.concatenate_movies(str(tmp_path / "x.mp4"), parts + [str(tmp_path / "junk.mp4")])


def test_writer_refusals(tmp_path, monkeypatch):
    frame = np.zeros((16, 16, 3), np.uint8)
    monkeypatch.setenv("LB_WRITER", "cv2")
    with pytest.raises(ValueError, match="cv2"):
        twriter.MovieSaver(str(tmp_path / "a.mp4"), device="cpu").write_frame(frame)
    monkeypatch.setenv("LB_WRITER", "ffmpeg")
    monkeypatch.setattr(twriter.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        twriter.MovieSaver(str(tmp_path / "b.mp4"), device="cpu").write_frame(frame)
    monkeypatch.setenv("LB_WRITER", "auto")
    ms = twriter.MovieSaver(str(tmp_path / "c.mp4"), device="cpu")
    with pytest.raises(ValueError, match="even"):
        ms.write_frame(np.zeros((15, 16, 3), np.uint8))
    ms = twriter.MovieSaver(str(tmp_path / "d.mp4"), device="cpu")
    ms.write_frame(torch.from_numpy(frame))
    with pytest.raises(ValueError, match="uint8 HWC RGB"):
        ms.write_frame(np.zeros((16, 16), np.uint8))
    with pytest.raises(ValueError, match="movie shape"):
        ms.write_frame(np.zeros((8, 16, 3), np.uint8))
    ms.finalize()
    assert ms.backend == "mjpeg" and _moov_fields(tmp_path / "d.mp4") == (1, (16, 16), 30.0)
