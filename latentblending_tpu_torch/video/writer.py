"""Movie IO: MovieSaver, write_frames, write_frames_interp, concatenate_movies.

Counterpart of latentblending_tpu/video/writer.py. Backends (LB_WRITER):

- `auto` (default) and `mjpeg`: MJPEG-in-MP4 (video/mjpeg_mp4.py), every
  sample encoded on the card by the port's JPEG kernels (video/jpeg.py);
- `ffmpeg`: the JAX package's x264 subprocess, taken only when asked for
  by name, so a host binary never hides the device path;
- `cv2` raises: OpenCV's VideoWriter is not part of the port.

`read_movie_frames` reads MJPEG MP4s (this package's, or another muxer's)
with the port's own baseline JPEG decoder on the host (video/jpeg_decode.py,
libjpeg's arithmetic), where the JAX package reads through cv2; another
codec needs the ffmpeg binary.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from latentblending_tpu_torch import profiling

from .mjpeg_mp4 import MjpegMp4Writer, as_rgb_frame

_BACKENDS = ("auto", "mjpeg", "ffmpeg")


class MovieSaver:
    """Streaming MP4 writer: write_frame(uint8 HWC RGB) … finalize().
    MJPEG samples are encoded on `device` (the card unless a CPU device is
    given); frames may be numpy arrays or tensors."""

    def __init__(self, fp_movie: str, fps: int = 30, shape_hw: tuple[int, int] | None = None, crf: int = 21,
                 device="cuda"):
        self.fp_movie = fp_movie
        self.fps = fps
        self.shape_hw = tuple(shape_hw) if shape_hw is not None else None
        self.crf = crf
        self.device = torch.device(device)
        self.nmb_frames = 0
        # which backend ran ("mjpeg"/"ffmpeg"), whether the coefficient lerp
        # made the in-between frames, and the MJPEG quality the movie settled on
        self.backend: str | None = None
        self.used_coef_lerp = False
        self.jpeg_quality: int | None = None
        self._proc = None
        self._mjpeg = None
        if os.path.isfile(fp_movie):
            os.remove(fp_movie)
        d = os.path.dirname(fp_movie)
        if d:
            os.makedirs(d, exist_ok=True)

    def _open(self, h: int, w: int):
        self.shape_hw = (h, w)
        if h % 2 or w % 2:
            # yuv420p (and most players) require even dimensions
            raise ValueError(f"movie dimensions must be even, got {w}x{h}")
        backend = os.environ.get("LB_WRITER", "auto")
        if backend not in _BACKENDS:
            raise ValueError(f"LB_WRITER={backend!r} is not available in the port (one of {_BACKENDS})")
        if backend != "ffmpeg":
            self._mjpeg = MjpegMp4Writer(self.fp_movie, fps=self.fps, shape_hw=(h, w), device=self.device)
            self.backend = "mjpeg"
            return
        exe = shutil.which("ffmpeg")
        if exe is None:
            raise RuntimeError("LB_WRITER=ffmpeg but no ffmpeg binary found")
        self.backend = "ffmpeg"
        self._proc = subprocess.Popen(
            [
                exe, "-y", "-loglevel", "error",
                "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(self.fps),
                "-i", "-", "-c:v", "libx264", "-crf", str(self.crf), "-pix_fmt", "yuv420p",
                self.fp_movie,
            ],
            stdin=subprocess.PIPE,
        )

    def open_mjpeg(self):
        """Open the backend now (shape_hw must be known) and return the MJPEG
        writer if that is the chosen backend, else None."""
        if self._proc is None and self._mjpeg is None:
            if self.shape_hw is None:
                return None
            self._open(*self.shape_hw)
        return self._mjpeg

    def write_encoded(self, jpg: bytes):
        """Append an already-encoded JPEG sample (MJPEG backend only)."""
        if self._mjpeg is None:
            raise RuntimeError("write_encoded requires the MJPEG backend (call open_mjpeg first)")
        self._mjpeg.write_encoded(jpg)
        self.nmb_frames += 1

    def write_frame(self, img):
        img = as_rgb_frame(img)
        if self._proc is None and self._mjpeg is None:
            h, w = (self.shape_hw or tuple(img.shape[:2]))
            self._open(h, w)
        if tuple(img.shape[:2]) != tuple(self.shape_hw):
            raise ValueError(f"frame shape {tuple(img.shape[:2])} != movie shape {self.shape_hw}")
        if self._mjpeg is not None:
            self._mjpeg.write_frame(img)
        else:
            arr = img.cpu().numpy() if isinstance(img, torch.Tensor) else img
            try:
                self._proc.stdin.write(np.ascontiguousarray(arr).tobytes())
            except BrokenPipeError as e:
                rc = self._proc.poll()
                raise RuntimeError(f"ffmpeg died (exit {rc}) while writing {self.fp_movie}") from e
        self.nmb_frames += 1

    def finalize(self):
        """Close the movie (the tracer's `finalize` span)."""
        with profiling.span("finalize"):
            if self._mjpeg is not None:
                self.jpeg_quality = self._mjpeg.quality
                self._mjpeg.finalize()
                self._mjpeg = None
            elif self._proc is not None:
                self._proc.stdin.close()
                rc = self._proc.wait()
                self._proc = None
                if rc != 0:
                    raise RuntimeError(f"ffmpeg exited with code {rc} for {self.fp_movie}")
        if self.nmb_frames > 0 and not (os.path.isfile(self.fp_movie) and os.path.getsize(self.fp_movie) > 0):
            raise RuntimeError(f"movie file {self.fp_movie} was not written")


def write_frames(ms: MovieSaver, frames, threaded: bool | None = None) -> None:
    """Feed an iterable of (possibly reused) host frame buffers to a MovieSaver.

    threaded=None → auto: produce frames on this thread and encode on a
    consumer thread when the host has spare cores; LB_WRITER_THREAD=1/0
    forces the choice. Frames are copied into a rotating pool of 4 buffers
    before queueing (queue 2 + consumer 1 in flight), because producers
    reuse their output buffer."""
    if threaded is None:
        env = os.environ.get("LB_WRITER_THREAD")
        threaded = env == "1" if env is not None else (os.cpu_count() or 1) > 2
    if not threaded:
        for img in frames:
            ms.write_frame(img)
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=2)
    errs: list[BaseException] = []

    def _consume():
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                ms.write_frame(item)
        except BaseException as e:  # propagate to the producer
            errs.append(e)
            while q.get() is not None:  # drain so the producer never blocks
                pass

    th = threading.Thread(target=_consume, daemon=True)
    th.start()
    pool: list[np.ndarray] = []
    i = 0
    for frame in frames:
        if errs:
            break
        frame = np.asarray(frame)
        if len(pool) < 4:
            pool.append(np.empty_like(frame))
        buf = pool[i % 4]
        i += 1
        np.copyto(buf, frame)
        q.put(buf)
    q.put(None)
    th.join()
    if errs:
        raise errs[0]


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (b.index if b.index is not None else current)


def _device_rows(handle, device: torch.device):
    """(batch, row, ready) for a keyframe handle that holds its fetch chunk's
    uint8 batch on `device` (engine/blending.py _PendingImage: the batch,
    the keyframe's row in it and the CUDA event recorded once the batch was
    made, None on the CPU); None for a keyframe on the host."""
    batch = getattr(handle, "device_batch", None)
    if batch is None or not _same_device(batch.device, device):
        return None
    return batch, handle.row, handle.ready


def write_frames_interp(ms: MovieSaver, handles: list, nmb_frames_target: int,
                        resolve=None, threaded: bool | None = None) -> None:
    """Fill K keyframes up to nmb_frames_target frames and write the movie.

    With the MJPEG backend everything is encoded on the writer's device:
    - LB_COEF_LERP unset or "1" (the default): each keyframe's quantized
      coefficients (J1); each gap's in-between frames are the lerps of its
      two coefficient sets, and at t = 1 the next keyframe's own (one J2
      call), all coded in one J3 call (the first keyframe's sample, and the
      quality probes that settle the movie's quality, one J3 call each); only the
      finished bytes cross to the host. The JAX package's gate picks this
      path by host cores, which do not encode here. A keyframe handle that
      holds its fetch chunk's uint8 batch on the writer's device (the
      engine's streaming handles) is coded from that batch: one J1 call for
      all the batch's keyframes, after the writer's stream waits for the
      batch, with no host read and no upload. Other keyframes are read on
      the host and uploaded, one J1 call each.
    - "0": the pixel path: keyframes as RGB (I420 converted first, as the
      JAX fallback does), the lerp on the device by `_lerp_u8`'s rule, and
      each gap's in-between frames and next keyframe encoded by one J1 and
      one J3 call (the first keyframe alone, after its quality probes).
    The ffmpeg backend lerps on the host and pipes RGB frames.

    Keyframes are resolved lazily, left to right, so encoding overlaps the
    device→host copies of later keyframes. They may be packed I420 planes
    [H*3/2, W] (the engine's fetch format, video/i420.py) or RGB: I420
    keyframes are encoded straight from their planes at any even size
    (libjpeg's edge expansion), where the JAX writer needs W % 16 == 0.
    """
    from latentblending_tpu_torch.ops.schedules import frame_insert_counts

    from . import jpeg
    from .frames import stream_frames_lazy, stream_gaps_device
    from .i420 import i420_hw, is_i420, to_rgb

    if resolve is None:
        resolve = lambda im: im  # noqa: E731
    mj = ms.open_mjpeg()
    if mj is None:
        write_frames(ms, stream_frames_lazy(handles, nmb_frames_target, lambda im: to_rgb(resolve(im))),
                     threaded=threaded)
        return
    h, w = ms.shape_hw
    use_coef = nmb_frames_target > len(handles) and os.environ.get("LB_COEF_LERP", "1") != "0"
    if not use_coef:
        # a gap's frames a call, split where a call would pass MAX_CALL_COEF_BYTES
        per_call = max(1, jpeg.MAX_CALL_COEF_BYTES // (jpeg.num_blocks(h, w) * 64 * 2))
        with mj.encoding():
            for batch in stream_gaps_device(handles, nmb_frames_target, lambda im: to_rgb(resolve(im)), mj.device,
                                            per_call):
                if tuple(batch.shape[1:3]) != (h, w):
                    raise ValueError(f"frame shape {tuple(batch.shape[1:3])} != movie shape {(h, w)}")
                with profiling.span("encode", frames=batch.shape[0]):
                    for jpg in mj.encode_frames(batch):
                        ms.write_encoded(jpg)
        return

    ms.used_coef_lerp = True
    rows = [_device_rows(handle, mj.device) for handle in handles]  # holds the batches until the movie is written
    batch_coefs: dict = {}

    def check_hw(hw) -> None:
        if tuple(hw) != (h, w):
            raise ValueError(f"keyframe shape {tuple(hw)} != movie shape {(h, w)}")

    def device_batch(i: int) -> tuple[torch.Tensor, int, str]:
        """Keyframe i's chunk batch, its row and format, once the writer's
        stream waits for the batch (and the allocator keeps it for that
        stream)."""
        with profiling.span("fetch", keyframe=i):
            batch, row, ready = rows[i]
            fmt = "i420" if batch.ndim == 3 else "rgb"
            check_hw(i420_hw(batch[0]) if fmt == "i420" else batch.shape[1:3])
            if ready is not None:
                stream = torch.cuda.current_stream(batch.device)
                stream.wait_event(ready)
                batch.record_stream(stream)
            return batch, row, fmt

    def keyframe(i: int) -> tuple[torch.Tensor, str]:
        """Keyframe i alone on the writer's device, and its format."""
        if rows[i] is not None:
            batch, row, fmt = device_batch(i)
            return batch[row], fmt
        with profiling.span("fetch", keyframe=i):
            a = np.ascontiguousarray(np.asarray(resolve(handles[i])), dtype=np.uint8)
            check_hw(i420_hw(a) if is_i420(a) else a.shape[:2])
            return torch.from_numpy(a).to(mj.device), ("i420" if is_i420(a) else "rgb")

    def coefs(i: int) -> torch.Tensor:
        """Keyframe i's coefficients at the movie's quality: its row of one
        J1 call on its whole chunk batch, or one J1 call of its own."""
        if rows[i] is None:
            frame, fmt = keyframe(i)
            return jpeg.fdct_quant(frame[None], mj.quality, fmt)[0]
        batch, row, fmt = device_batch(i)
        if id(batch) not in batch_coefs:
            batch_coefs[id(batch)] = jpeg.fdct_quant(batch.contiguous(), mj.quality, fmt)
        return batch_coefs[id(batch)][row]

    counts = frame_insert_counts(len(handles), nmb_frames_target)
    with mj.encoding():
        with profiling.span("encode", frames=1):
            if mj._q_settled:
                ccur = coefs(0)
                jcur = jpeg.encode_coefs(ccur, h, w, mj.quality)
            else:
                # the first keyframe settles the movie's quality
                # (calibrate_quality, a J1 and a J3 call a probe, on it
                # alone), so every sample shares its quant tables
                frame, fmt = keyframe(0)
                probes: dict = {}

                def at(q: int) -> bytes:
                    probes[q] = jpeg.fdct_quant(frame[None].contiguous(), q, fmt)[0]
                    return jpeg.encode_coefs(probes[q], h, w, q)

                jcur = mj.calibrate_quality(at)
                ccur = probes[mj.quality]
            ms.write_encoded(jcur)
        for i in range(len(handles) - 1):
            with profiling.span("encode", gap=i, frames=counts[i] + 1):
                cnxt = coefs(i + 1)
                # the gap's in-between frames, then at t = 1 the next
                # keyframe's sample: one J2 and one J3 call
                gap = jpeg.CoefFrames(ccur, cnxt, h, w, mj.quality)
                for jpg in gap.lerp_many(np.linspace(0, 1, counts[i] + 2)[1:]):
                    ms.write_encoded(jpg)
            ccur = cnxt


def _ffmpeg_frames(exe: str, fp_movie: str, h: int, w: int) -> list[np.ndarray]:
    """Every frame of a movie as uint8 RGB, decoded by the ffmpeg binary."""
    res = subprocess.run([exe, "-loglevel", "error", "-i", fp_movie, "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
                         capture_output=True, check=False)
    if res.returncode != 0 or len(res.stdout) % (h * w * 3):
        raise ValueError(f"read_movie_frames: ffmpeg could not decode {fp_movie} "
                         f"({res.returncode}): {res.stderr.decode(errors='replace')[-500:]}")
    raw = np.frombuffer(res.stdout, np.uint8).reshape(-1, h, w, 3)
    return [f.copy() for f in raw]


def read_movie_frames(fp_movie: str) -> list[np.ndarray]:
    """Decode a movie back to a list of uint8 RGB frames [H, W, 3].

    MJPEG MP4/MOV files (mjpeg_mp4.read_mjpeg_samples) decode on the host
    with video/jpeg_decode.py; any other codec goes through the ffmpeg
    binary when one is on PATH, else raises ValueError naming the codec.
    A file with frames never gives an empty list."""
    from . import jpeg_decode
    from .mjpeg_mp4 import read_mjpeg_samples, video_track

    got = read_mjpeg_samples(fp_movie)
    if got is not None:
        return [jpeg_decode.decode_rgb(sample) for sample in got[0]]
    track = video_track(fp_movie)
    exe = _check_readable(fp_movie, track)
    frames = _ffmpeg_frames(exe, fp_movie, *track["shape_hw"])
    if len(frames) == 0 and track["samples"]:
        raise ValueError(f"read_movie_frames: ffmpeg gave no frame of {fp_movie} ({len(track['samples'])} samples)")
    return frames


def _check_readable(fp_movie: str, track: dict | None) -> str | None:
    """Raise ValueError unless read_movie_frames can read the movie whose
    video_track is `track`: MJPEG, or any codec with an ffmpeg binary on
    PATH (returned)."""
    exe = shutil.which("ffmpeg")
    if track is not None and (track["mjpeg"] or exe is not None):
        return exe
    what = f"{track['codec']!r} video" if track is not None else "no MP4/MOV video track this reader can parse"
    raise ValueError(f"read_movie_frames: {fp_movie} holds {what}; without an ffmpeg binary only MJPEG is read")


def concatenate_movies(fp_final: str, list_fp_movies: list[str], fps: int | None = None, device="cuda"):
    """Concatenate movie parts into one (reference example_multi_trans.py:62),
    in the JAX package's order: the ffmpeg binary's concat (stream copy) if
    there is one; else mjpeg_mp4.concat_parts, lossless, for MJPEG parts
    this package wrote at one shape and fps; else every part decoded
    (read_movie_frames) and re-encoded through MovieSaver on `device`, at
    `fps` or the first part's."""
    from .mjpeg_mp4 import concat_parts, video_track

    if not list_fp_movies:
        raise ValueError("nothing to concatenate")
    exe = shutil.which("ffmpeg")
    if exe is not None:
        with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
            for fp in list_fp_movies:
                f.write(f"file '{os.path.abspath(fp)}'\n")
            list_path = f.name
        try:
            subprocess.run([exe, "-y", "-loglevel", "error", "-f", "concat", "-safe", "0", "-i", list_path,
                            "-c", "copy", fp_final], check=True)
        finally:
            os.unlink(list_path)
        return
    if concat_parts(fp_final, list_fp_movies, fps=fps):
        return
    tracks = [video_track(fp) for fp in list_fp_movies]
    for fp, track in zip(list_fp_movies, tracks):
        _check_readable(fp, track)  # before the output is opened
    fps_out = fps or tracks[0]["fps"] or 30
    ms = None
    for fp in list_fp_movies:
        for frame in read_movie_frames(fp):
            if ms is None:
                ms = MovieSaver(fp_final, fps=int(round(fps_out)), shape_hw=frame.shape[:2], device=device)
            ms.write_frame(frame)
    if ms is not None:
        ms.finalize()
