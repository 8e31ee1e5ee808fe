"""The port's host JPEG decoder (latentblending_tpu_torch/video/jpeg_decode.py),
its MJPEG MP4 sample reader and read_movie_frames / concatenate_movies.

- The decoder is exact (0 LSB) against PIL's decode (libjpeg-turbo, islow
  IDCT, fancy upsampling) on: the port's encode_rgb and encode_i420 files
  at 64², 72×88 and an odd size, qualities 50/80/95; PIL files with
  optimize=True tables; cv2.imencode files with restart markers and with
  4:4:4 sampling; grayscale files; sizes of 1-3 pixels, where libjpeg-turbo
  replicates narrow chroma planes instead of the fancy filter. Its
  coefficients of an encode_rgb file are J1's plain version's.
- Progressive, arithmetic-coded and 12-bit files raise ValueError naming
  what was found.
- read_movie_frames of the port's and the JAX writer's MJPEG movies gives
  the JAX read_movie_frames' frame count and shape; its frames are PIL's
  decode of each sample exactly. The JAX function reads through cv2, whose
  FFmpeg decoder has its own IDCT and converts to RGB with swscale, not
  libjpeg's chroma upsampling: against it the luma (BT.601 of the RGB)
  agrees within a mean of 1 LSB a frame (measured ≤ 0.90 here), the RGB
  within the measured bounds stated in the test (chroma-rich frames differ
  most).
- MJPEG files that another muxer wrote (FFmpeg through cv2.VideoWriter: an
  'mp4v' entry with JPEG's object type in .mp4, 'jpeg' in .mov) and a
  multi-chunk co64 layout are read sample by sample (read_samples, the
  muxer's own layout, refuses the 'mp4v' and multi-chunk ones); parts that
  concat_parts refuses are decoded and re-encoded by concatenate_movies,
  giving the JAX function's frame count.
"""
import io
import os
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from latentblending_tpu.video import writer as jax_writer
from latentblending_tpu_torch.video import jpeg, jpeg_decode, mjpeg_mp4
from latentblending_tpu_torch.video import writer as port_writer
from tests.torch_port_util import mjpeg_writers


def _frame(h: int, w: int, seed: int, noise: float = 12.0) -> np.ndarray:
    """A smooth colour field plus pixel noise, uint8 RGB."""
    rng = np.random.default_rng(seed)
    coarse = (rng.random((h // 8 + 2, w // 8 + 2, 3)) * 255).astype(np.float32)
    img = cv2.resize(coarse, (max(w, 1), max(h, 1)), interpolation=cv2.INTER_CUBIC)
    return np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _pil_encode(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_exact(data: bytes):
    got, want = jpeg_decode.decode(data), _pil_decode(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 80, 95])
@pytest.mark.parametrize("hw", [(64, 64), (72, 88), (37, 53)])
def test_port_rgb_files_decode_exactly(hw, quality):
    img = _frame(*hw, seed=hw[0] + quality)
    data = jpeg.encode_rgb(torch.from_numpy(img)[None], quality)[0]
    _assert_exact(data)
    # the coefficients the decoder reads are the ones J1 quantized
    coefs, _, frame = jpeg_decode.decode_coefficients(data)
    want = jpeg.fdct_quant_reference(torch.from_numpy(img)[None], quality, "rgb")[0].numpy()
    my, mx = jpeg.mcu_grid(*hw)
    y = coefs[0].reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    got = np.concatenate([y, coefs[1].reshape(my, mx, 1, 64), coefs[2].reshape(my, mx, 1, 64)], axis=2)
    np.testing.assert_array_equal(got.reshape(-1, 64), want)
    assert frame["sampling"] == [(2, 2), (1, 1), (1, 1)]


@pytest.mark.parametrize("quality", [50, 80, 95])
@pytest.mark.parametrize("hw", [(64, 64), (72, 88), (44, 70)])
def test_port_i420_files_decode_exactly(hw, quality):
    from latentblending_tpu_torch.video.i420 import rgb_to_i420

    i420 = rgb_to_i420(_frame(*hw, seed=hw[1] + quality))
    _assert_exact(jpeg.encode_i420(torch.from_numpy(i420)[None], quality)[0])


@pytest.mark.parametrize("quality", [60, 80, 95])
@pytest.mark.parametrize("hw", [(64, 64), (72, 88), (37, 53)])
def test_pil_optimized_tables_decode_exactly(hw, quality):
    _assert_exact(_pil_encode(_frame(*hw, seed=quality), quality=quality, optimize=True))


@pytest.mark.parametrize("params", [
    [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
    [cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_RST_INTERVAL, 7],
    [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
     cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
], ids=["rst1", "rst7", "444", "444-rst3"])
@pytest.mark.parametrize("hw", [(72, 88), (37, 53)])
def test_cv2_restart_markers_and_444_decode_exactly(hw, params):
    ok, enc = cv2.imencode(".jpg", _frame(*hw, seed=5)[..., ::-1], params)
    assert ok
    data = enc.tobytes()
    if cv2.IMWRITE_JPEG_RST_INTERVAL in params:
        assert b"\xff\xdd" in data  # a DRI marker
    _assert_exact(data)


@pytest.mark.parametrize("hw", [(64, 64), (37, 53)])
def test_grayscale_decodes_exactly(hw):
    img = _frame(*hw, seed=3)[..., 1].copy()
    _assert_exact(_pil_encode(img, quality=85))
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 70])
    _assert_exact(enc.tobytes())
    assert jpeg_decode.decode(enc.tobytes()).shape == hw


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (3, 2), (4, 3), (3, 17), (17, 3), (2, 5), (9, 17)])
def test_tiny_sizes_decode_exactly(hw):
    img = _frame(16, 24, seed=hw[0] * 31 + hw[1])[:hw[0], :hw[1]].copy()
    _assert_exact(_pil_encode(img, quality=80))
    _assert_exact(_pil_encode(img, quality=90, subsampling=0))


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """`data` with the byte `offset` into the payload of its first
    `marker` segment set to `value`."""
    i = data.index(bytes([0xFF, marker])) + 4 + offset
    return data[:i] + bytes([value]) + data[i + 1:]


def test_unsupported_files_raise():
    img = _frame(32, 32, seed=1)
    with pytest.raises(ValueError, match="progressive"):
        jpeg_decode.decode(_pil_encode(img, quality=80, progressive=True))
    base = _pil_encode(img, quality=80)
    sof = base.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg_decode.decode(base[:sof + 1] + b"\xc9" + base[sof + 2:])
    with pytest.raises(ValueError, match="12-bit"):
        jpeg_decode.decode(_patched(base, 0xC0, 0, 12))
    with pytest.raises(ValueError, match="SOI"):
        jpeg_decode.decode(b"\x00" + base)
    with pytest.raises(ValueError):
        jpeg_decode.decode(base[: len(base) // 2])


# ------------------------------------------------------------------ movies

def _movie_frames(h: int, w: int) -> list[np.ndarray]:
    rng = np.random.default_rng(h * w)
    return [_frame(h, w, seed=i) for i in range(4)] + [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)]


def _luma(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float64) @ np.array([0.299, 0.587, 0.114])


# measured on these frames (max over frames): luma mean 0.90, RGB mean
# 13.3, RGB max 88 (the noise frame; the smooth frames 7.6 and 48)
LUMA_MEAN_BOUND = 1.0
RGB_MEAN_BOUND = 14.0
RGB_MAX_BOUND = 96


@pytest.mark.parametrize("hw", [(64, 64), (72, 88)])
@pytest.mark.parametrize("which", ["port", "jax"])
def test_read_movie_frames_against_jax(tmp_path, monkeypatch, which, hw):
    mjpeg_writers(monkeypatch, "1")
    fp = str(tmp_path / f"{which}.mp4")
    frames = _movie_frames(*hw)
    ms = port_writer.MovieSaver(fp, fps=30, device="cpu") if which == "port" else jax_writer.MovieSaver(fp, fps=30)
    for f in frames:
        ms.write_frame(f)
    ms.finalize()
    got = port_writer.read_movie_frames(fp)
    want = jax_writer.read_movie_frames(fp)
    assert len(got) == len(want) == len(frames)
    assert all(g.shape == w.shape == (*hw, 3) and g.dtype == np.uint8 for g, w in zip(got, want))
    samples, shape, fps = mjpeg_mp4.read_mjpeg_samples(fp)
    assert shape == hw and fps == 30 and len(samples) == len(frames)
    for g, s in zip(got, samples):
        np.testing.assert_array_equal(g, _pil_decode(s))
    for g, w in zip(got, want):
        d = np.abs(g.astype(np.int64) - w)
        assert np.abs(_luma(g) - _luma(w)).mean() <= LUMA_MEAN_BOUND
        assert d.mean() <= RGB_MEAN_BOUND and d.max() <= RGB_MAX_BOUND


def _cv2_movie(fp: str, frames: list[np.ndarray], fourcc: str = "MJPG", fps: int = 30) -> None:
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(fp, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()


def _cv2_count(fp: str) -> int:
    cap = cv2.VideoCapture(fp)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("ext, codec", [("mp4", "mp4v/0x6c"), ("mov", "jpeg")])
def test_foreign_mjpeg_files(tmp_path, ext, codec):
    fp = str(tmp_path / f"ffmpeg.{ext}")
    frames = _movie_frames(48, 64)
    _cv2_movie(fp, frames)
    track = mjpeg_mp4.video_track(fp)
    assert track["codec"] == codec and track["mjpeg"] and track["shape_hw"] == (48, 64)
    legacy = mjpeg_mp4.read_samples(fp)  # this muxer's layout only: one chunk, a 'jpeg' entry
    if ext == "mp4":
        assert legacy is None
    else:
        assert legacy[0] == mjpeg_mp4.read_mjpeg_samples(fp)[0]
    got = port_writer.read_movie_frames(fp)
    assert len(got) == len(frames) == _cv2_count(fp)
    for g, s in zip(got, mjpeg_mp4.read_mjpeg_samples(fp)[0]):
        np.testing.assert_array_equal(g, _pil_decode(s))


def _multichunk_mp4(fp: str, samples: list[bytes], hw: tuple, per_chunk: list[int], fps: int = 24) -> None:
    """An MJPEG MP4 whose samples sit in several chunks with gaps between
    them, addressed by co64 and a multi-entry stsc, with one stts run per
    sample (another muxer's layout)."""
    m = mjpeg_mp4
    h, w = hw
    body, offsets, pos = b"", [], 0
    ftyp = m._box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    base = len(ftyp) + 8
    i = 0
    for n in per_chunk:
        body += b"\x00" * 13  # a gap before each chunk
        offsets.append(base + len(body))
        for s in samples[i:i + n]:
            body += s
        i += n
    mdat = struct.pack(">I", 8 + len(body)) + b"mdat" + body
    n = len(samples)
    stsd = m._full_box(b"stsd", 0, 0, struct.pack(">I", 1) + m._jpeg_sample_entry(w, h))
    stts = m._full_box(b"stts", 0, 0, struct.pack(">I", n) + b"".join(struct.pack(">II", 1, 1000) for _ in range(n)))
    runs = [(1, per_chunk[0])] + [(k + 1, c) for k, c in enumerate(per_chunk) if k and c != per_chunk[k - 1]]
    stsc = m._full_box(b"stsc", 0, 0, struct.pack(">I", len(runs)) + b"".join(struct.pack(">III", a, c, 1) for a, c in runs))
    stsz = m._full_box(b"stsz", 0, 0, struct.pack(">II", 0, n) + struct.pack(f">{n}I", *map(len, samples)))
    co64 = m._full_box(b"co64", 0, 0, struct.pack(">I", len(offsets)) + struct.pack(f">{len(offsets)}Q", *offsets))
    stbl = m._box(b"stbl", stsd + stts + stsc + stsz + co64)
    minf = m._box(b"minf", m._full_box(b"vmhd", 0, 1, b"\x00" * 8) + stbl)
    hdlr = m._full_box(b"hdlr", 0, 0, struct.pack(">I", 0) + b"vide" + b"\x00" * 12 + b"V\x00")
    mdhd = m._full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, fps * 1000, n * 1000, 0, 0))
    moov = m._box(b"moov", m._box(b"trak", m._box(b"mdia", mdhd + hdlr + minf)))
    with open(fp, "wb") as f:
        f.write(ftyp + mdat + moov)


def test_multichunk_co64_layout(tmp_path):
    frames = _movie_frames(40, 56)
    samples = jpeg.encode_rgb(torch.from_numpy(np.stack(frames)), 85)
    fp = str(tmp_path / "chunks.mp4")
    _multichunk_mp4(fp, samples, (40, 56), [2, 2, 1])
    assert mjpeg_mp4.read_samples(fp) is None
    got, hw, fps = mjpeg_mp4.read_mjpeg_samples(fp)
    assert got == samples and hw == (40, 56) and fps == 24
    for g, s in zip(port_writer.read_movie_frames(fp), samples):
        np.testing.assert_array_equal(g, _pil_decode(s))


def test_other_codecs_name_themselves(tmp_path, monkeypatch):
    fp = str(tmp_path / "mpeg4.mp4")
    _cv2_movie(fp, _movie_frames(48, 64), fourcc="mp4v")
    monkeypatch.setattr(port_writer.shutil, "which", lambda name: None)
    with pytest.raises(ValueError, match="mp4v/0x20"):
        port_writer.read_movie_frames(fp)
    (tmp_path / "junk.mp4").write_bytes(b"not a movie")
    with pytest.raises(ValueError, match="no MP4/MOV video track"):
        port_writer.read_movie_frames(str(tmp_path / "junk.mp4"))


def test_concatenate_refused_parts_reencodes(tmp_path, monkeypatch):
    """Parts concat_parts refuses (the port's own part at 25 fps beside an
    FFmpeg-muxed MJPEG part at 30 fps) are decoded and re-encoded at the
    first part's fps: the JAX function's frame count."""
    mjpeg_writers(monkeypatch, "1")
    monkeypatch.setattr(port_writer.shutil, "which", lambda name: None)
    a, b = str(tmp_path / "a.mp4"), str(tmp_path / "b.mov")
    ms = port_writer.MovieSaver(a, fps=25, device="cpu")
    for f in _movie_frames(48, 64)[:3]:
        ms.write_frame(f)
    ms.finalize()
    _cv2_movie(b, _movie_frames(48, 64))
    assert not mjpeg_mp4.concat_parts(str(tmp_path / "never.mp4"), [a, b])
    port_out, jax_out = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    port_writer.concatenate_movies(port_out, [a, b], device="cpu")
    jax_writer.concatenate_movies(jax_out, [a, b])
    frames = port_writer.read_movie_frames(port_out)
    assert len(frames) == 8 == _cv2_count(jax_out) == _cv2_count(port_out)
    assert mjpeg_mp4.read_mjpeg_samples(port_out)[2] == 25
    with pytest.raises(ValueError):
        port_writer.concatenate_movies(str(tmp_path / "x.mp4"), [])


def test_full_size_frame_decodes_exactly():
    """A 512² frame at the movie writer's default quality (the chip run
    prints the decode's host ms a frame at full width)."""
    _assert_exact(jpeg.encode_rgb(torch.from_numpy(_frame(512, 512, seed=7))[None], 90)[0])


_FAKE_FFMPEG = """#!{python}
import json, sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
if "rawvideo" in args:
    sys.stdout.buffer.write(bytes(range(256)) * ({n} * {h} * {w} * 3 // 256))
elif "concat" in args:
    open(args[-1], "wb").write(b"joined")
"""


def test_ffmpeg_binary_reads_other_codecs_and_concatenates(tmp_path, monkeypatch):
    """With an ffmpeg binary on PATH (a stand-in script here, which logs its
    arguments), read_movie_frames pipes any other codec through it as rgb24
    frames of the track's size, and concatenate_movies hands it the parts
    first (stream copy), as the JAX writer does."""
    import json
    import sys

    fp = str(tmp_path / "mpeg4.mp4")
    frames = _movie_frames(48, 64)
    _cv2_movie(fp, frames, fourcc="mp4v")
    log = tmp_path / "ffmpeg.log"
    exe = tmp_path / "bin" / "ffmpeg"
    exe.parent.mkdir()
    exe.write_text(_FAKE_FFMPEG.format(python=sys.executable, log=str(log), n=len(frames), h=48, w=64))
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{exe.parent}{os.pathsep}{os.environ['PATH']}")
    got = port_writer.read_movie_frames(fp)
    assert len(got) == len(frames) and all(g.shape == (48, 64, 3) and g.dtype == np.uint8 for g in got)
    assert got[0][0, 0].tolist() == [0, 1, 2]
    out = str(tmp_path / "joined.mp4")
    port_writer.concatenate_movies(out, [fp, fp], device="cpu")
    assert open(out, "rb").read() == b"joined"
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert calls[0][-5:] == ["-f", "rawvideo", "-pix_fmt", "rgb24", "-"] and fp in calls[0]
    assert calls[1][calls[1].index("-f") + 1] == "concat" and calls[1][-3:] == ["-c", "copy", out]
