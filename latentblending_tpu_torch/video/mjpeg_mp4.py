"""MJPEG-in-MP4 streaming writer (pure-Python ISO-BMFF muxer), with its
samples encoded on the device.

Counterpart of latentblending_tpu/video/mjpeg_mp4.py: the same muxer
(`_box` ... `_moov`, `read_samples`, `concat_parts`) and the same rate
control (`byte_budget`, `calibrate_quality`; LB_JPEG_QUALITY,
LB_MJPEG_MAX_BPP, LB_MJPEG_MIN_Q), with the mdat writes on an IO thread
(LB_MJPEG_IO_THREAD=0 writes inline). Where the JAX writer encodes each
frame with cv2.imencode on a pool of host threads, this one encodes with
video/jpeg.py on the writer's device (J1 and J3), in stream order: the
samples are libjpeg's bytes for the same frames and quality.

Layout written: ftyp | mdat (raw JPEG samples) | moov. The mdat size is
back-patched at finalize, so the target must be a seekable local file.
All samples are sync samples (no stss box => every sample is a keyframe
per the spec), one chunk holds all samples (single stco offset).
`read_mjpeg_samples` reads the samples of other muxers' MJPEG files too.
"""
from __future__ import annotations

import contextlib
import os
import struct

import numpy as np
import torch

from latentblending_tpu_torch.video import jpeg


def _box(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + tag + payload


def _full_box(tag: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(tag, struct.pack(">I", (version << 24) | flags) + payload)


_MATRIX_IDENTITY = struct.pack(">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000)


def _jpeg_sample_entry(width: int, height: int) -> bytes:
    """VisualSampleEntry with format 'jpeg' (ISO 14496-12 §12.1.3)."""
    body = (
        b"\x00" * 6                      # reserved
        + struct.pack(">H", 1)           # data_reference_index
        + b"\x00" * 16                   # pre_defined/reserved
        + struct.pack(">HH", width, height)
        + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
        + b"\x00" * 4                    # reserved
        + struct.pack(">H", 1)           # frame_count
        + b"\x00" * 32                   # compressorname (empty pascal string)
        + struct.pack(">Hh", 0x0018, -1)  # depth, pre_defined
    )
    return _box(b"jpeg", body)


def _moov(n: int, sizes: list[int], mdat_data_off: int, width: int, height: int, fps: float) -> bytes:
    timescale = 90000
    delta = max(1, round(timescale / fps))
    media_dur = n * delta
    mv_timescale = 1000
    mv_dur = round(media_dur * mv_timescale / timescale)

    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + _jpeg_sample_entry(width, height))
    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n) + struct.pack(f">{n}I", *sizes))
    stco = _full_box(b"stco", 0, 0, struct.pack(">II", 1, mdat_data_off))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)

    url = _full_box(b"url ", 0, 1, b"")  # flag 1: data in this file
    dref = _full_box(b"dref", 0, 0, struct.pack(">I", 1) + url)
    dinf = _box(b"dinf", dref)
    vmhd = _full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    minf = _box(b"minf", vmhd + dinf + stbl)

    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I", 0) + b"vide" + b"\x00" * 12 + b"VideoHandler\x00")
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, media_dur, 0x55C4, 0))
    mdia = _box(b"mdia", mdhd + hdlr + minf)

    tkhd = _full_box(
        b"tkhd", 0, 3,  # flags: enabled | in-movie
        struct.pack(">IIIII", 0, 0, 1, 0, mv_dur)
        + b"\x00" * 8
        + struct.pack(">hhhh", 0, 0, 0, 0)
        + _MATRIX_IDENTITY
        + struct.pack(">II", width << 16, height << 16),
    )
    trak = _box(b"trak", tkhd + mdia)

    mvhd = _full_box(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, mv_timescale, mv_dur)
        + struct.pack(">IH", 0x00010000, 0x0100)  # rate, volume
        + b"\x00" * 10
        + _MATRIX_IDENTITY
        + b"\x00" * 24
        + struct.pack(">I", 2),  # next_track_ID
    )
    return _box(b"moov", mvhd + trak)


def read_samples(fp: str) -> tuple[list[bytes], tuple[int, int], float] | None:
    """Extract the JPEG samples of an MJPEG mp4 written by MjpegMp4Writer.

    Returns (samples, (h, w), fps), or None if the file is not in this
    muxer's exact layout (single 'jpeg' track, one chunk, one stts run) —
    callers fall back to decode + re-encode for foreign files.
    """
    try:
        with open(fp, "rb") as f:
            blob = f.read()

        def boxes(buf: bytes, off: int = 0, end: int | None = None):
            end = len(buf) if end is None else end
            while off + 8 <= end:
                size = struct.unpack(">I", buf[off:off + 4])[0]
                if size < 8 or off + size > end:
                    return
                yield buf[off + 4:off + 8], off + 8, off + size
                off += size

        top = {tag: (s, e) for tag, s, e in boxes(blob)}
        if b"moov" not in top:
            return None

        def find(path: list[bytes], s: int, e: int) -> tuple[int, int] | None:
            for tag in path:
                hit = next(((cs, ce) for t, cs, ce in boxes(blob, s, e) if t == tag), None)
                if hit is None:
                    return None
                s, e = hit
            return s, e

        ms, me = top[b"moov"]
        stbl = find([b"trak", b"mdia", b"minf", b"stbl"], ms, me)
        mdhd = find([b"trak", b"mdia", b"mdhd"], ms, me)
        if stbl is None or mdhd is None:
            return None
        tbl = {tag: (s, e) for tag, s, e in boxes(blob, *stbl)}
        ss, se = tbl[b"stsd"]
        if blob[ss + 12:ss + 16] != b"jpeg":
            return None
        w, h = struct.unpack(">HH", blob[ss + 40:ss + 44])
        ts = struct.unpack(">I", blob[mdhd[0] + 12:mdhd[0] + 16])[0]
        nstts = struct.unpack(">I", blob[tbl[b"stts"][0] + 4:tbl[b"stts"][0] + 8])[0]
        if nstts != 1:
            return None
        delta = struct.unpack(">I", blob[tbl[b"stts"][0] + 12:tbl[b"stts"][0] + 16])[0]
        fps = ts / delta
        cs, _ = tbl[b"stco"]
        if struct.unpack(">I", blob[cs + 4:cs + 8])[0] != 1:
            return None
        off = struct.unpack(">I", blob[cs + 8:cs + 12])[0]
        zs, _ = tbl[b"stsz"]
        if struct.unpack(">I", blob[zs + 4:zs + 8])[0] != 0:
            return None  # one size for all samples: another muxer's table
        n = struct.unpack(">I", blob[zs + 8:zs + 12])[0]
        sizes = struct.unpack(f">{n}I", blob[zs + 12:zs + 12 + 4 * n])
        samples = []
        for sz in sizes:
            samples.append(blob[off:off + sz])
            off += sz
        return samples, (h, w), fps
    except Exception:
        return None


# sample entries that carry baseline JPEG samples ('mp4v' does too when its
# esds names object type 0x6C, ISO/IEC 10918-1, as ffmpeg's mp4 muxer writes)
_MJPEG_ENTRIES = (b"jpeg", b"mjpa", b"MJPG")
_OTI_JPEG = 0x6C


def _boxes(blob: bytes, off: int, end: int):
    """(tag, payload start, box end) of each box in blob[off:end] (64-bit
    sizes and size 0, "to the end", included); stops at a malformed box."""
    while off + 8 <= end:
        size, tag = struct.unpack(">I4s", blob[off:off + 8])
        head = 8
        if size == 1:
            if off + 16 > end:
                return
            size, head = struct.unpack(">Q", blob[off + 8:off + 16])[0], 16
        elif size == 0:
            size = end - off
        if size < head or off + size > end:
            return
        yield tag, off + head, off + size
        off += size


def _child(blob: bytes, span: tuple[int, int] | None, *path: bytes) -> tuple[int, int] | None:
    for tag in path:
        if span is None:
            return None
        span = next(((s, e) for t, s, e in _boxes(blob, *span) if t == tag), None)
    return span


def _es_object_type(blob: bytes, s: int, e: int) -> int | None:
    """objectTypeIndication of an esds box's DecoderConfigDescriptor."""
    i = s + 4  # version, flags

    def header(i: int) -> tuple[int, int, int]:
        tag, size, n = blob[i], 0, i + 1
        for _ in range(4):
            b = blob[n]
            n += 1
            size = (size << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        return tag, size, n

    try:
        tag, _, i = header(i)
        if tag != 0x03:
            return None
        flags = blob[i + 2]
        i += 3 + (2 if flags & 0x80 else 0)
        if flags & 0x40:
            i += 1 + blob[i]
        i += 2 if flags & 0x20 else 0
        tag, _, i = header(i)
        return blob[i] if tag == 0x04 and i < e else None
    except IndexError:
        return None


def video_track(fp: str) -> dict | None:
    """The first video track of an ISO-BMFF (MP4/MOV) file: its sample
    entry's format ("codec", e.g. "jpeg", or "mp4v/0x6c" with the esds
    object type), whether it carries JPEG samples ("mjpeg"), (h, w), fps
    (samples over the track's duration) and each sample's (offset, size),
    from stsz, stsc and stco/co64. None if the file is no such movie."""
    try:
        with open(fp, "rb") as f:
            blob = f.read()
        moov = _child(blob, (0, len(blob)), b"moov")
        if moov is None:
            return None
        for tag, ts, te in _boxes(blob, *moov):
            if tag != b"trak":
                continue
            mdia = _child(blob, (ts, te), b"mdia")
            hdlr, mdhd = _child(blob, mdia, b"hdlr"), _child(blob, mdia, b"mdhd")
            if hdlr is None or mdhd is None or blob[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
                continue
            stbl = _child(blob, mdia, b"minf", b"stbl")
            tbl = {t: (a, b) for t, a, b in _boxes(blob, *stbl)} if stbl else {}
            if not {b"stsd", b"stts", b"stsc", b"stsz"} <= tbl.keys() or not ({b"stco", b"co64"} & tbl.keys()):
                return None
            ss, se = tbl[b"stsd"]
            entry = next(_boxes(blob, ss + 8, se), None)
            if entry is None:
                return None
            fourcc, es, ee = entry
            w, h = struct.unpack(">HH", blob[es + 24:es + 28])
            codec, mjpeg = fourcc.decode("latin-1"), fourcc in _MJPEG_ENTRIES
            if fourcc == b"mp4v":
                esds = next(((a, b) for t, a, b in _boxes(blob, es + 78, ee) if t == b"esds"), None)
                oti = _es_object_type(blob, *esds) if esds else None
                codec += f"/0x{oti:02x}" if oti is not None else ""
                mjpeg = oti == _OTI_JPEG
            version = blob[mdhd[0]]
            ts_off = mdhd[0] + (20 if version == 1 else 12)
            timescale = struct.unpack(">I", blob[ts_off:ts_off + 4])[0]
            a = tbl[b"stts"][0]
            runs = struct.unpack(f">{2 * struct.unpack('>I', blob[a + 4:a + 8])[0]}I",
                                 blob[a + 8:a + 8 + 8 * struct.unpack(">I", blob[a + 4:a + 8])[0]])
            duration = sum(runs[0::2][i] * runs[1::2][i] for i in range(len(runs) // 2))
            a = tbl[b"stsz"][0]
            uniform, n = struct.unpack(">II", blob[a + 4:a + 12])
            sizes = [uniform] * n if uniform else list(struct.unpack(f">{n}I", blob[a + 12:a + 12 + 4 * n]))
            a = tbl[b"stsc"][0]
            m = struct.unpack(">I", blob[a + 4:a + 8])[0]
            stsc = [struct.unpack(">III", blob[a + 8 + 12 * i:a + 20 + 12 * i]) for i in range(m)]
            if b"co64" in tbl:
                a = tbl[b"co64"][0]
                k = struct.unpack(">I", blob[a + 4:a + 8])[0]
                chunks = struct.unpack(f">{k}Q", blob[a + 8:a + 8 + 8 * k])
            else:
                a = tbl[b"stco"][0]
                k = struct.unpack(">I", blob[a + 4:a + 8])[0]
                chunks = struct.unpack(f">{k}I", blob[a + 8:a + 8 + 4 * k])
            samples, j = [], 0
            for ci, off in enumerate(chunks, start=1):
                per = next((spc for first, spc, _ in reversed(stsc) if first <= ci), 0)
                for _ in range(per):
                    if j == n:
                        break
                    samples.append((off, sizes[j]))
                    off += sizes[j]
                    j += 1
            if j != n or any(o + z > len(blob) for o, z in samples):
                return None
            fps = timescale * n / duration if duration else 0.0
            return {"codec": codec, "mjpeg": mjpeg, "shape_hw": (h, w), "fps": fps, "samples": samples, "blob": blob}
        return None
    except (struct.error, IndexError, ValueError):
        return None


def read_mjpeg_samples(fp: str) -> tuple[list[bytes], tuple[int, int], float] | None:
    """The JPEG samples of any MJPEG MP4/MOV (this muxer's layout or
    another's: several chunks, co64, 'jpeg'/'mjpa'/'MJPG' or 'mp4v' with
    JPEG's object type): (samples, (h, w), fps), or None for another codec
    or a file that is no such movie."""
    track = video_track(fp)
    if track is None or not track["mjpeg"]:
        return None
    blob = track["blob"]
    return [blob[o:o + z] for o, z in track["samples"]], track["shape_hw"], track["fps"]


def concat_parts(fp_out: str, parts: list[str], fps: float | None = None) -> bool:
    """Losslessly concatenate MJPEG mp4 parts written by this muxer (no
    decode/re-encode — the answer to the reference's
    `ffmpeg -c copy` concat, example_multi_trans.py:62). Returns False if
    any part isn't in this muxer's layout or shapes/fps disagree."""
    extracted = [read_samples(fp) for fp in parts]
    if any(e is None for e in extracted):
        return False
    shapes = {e[1] for e in extracted}
    fpss = {round(e[2], 3) for e in extracted}
    if len(shapes) != 1 or (fps is None and len(fpss) != 1):
        return False
    (h, w) = shapes.pop()
    out_fps = fps if fps is not None else extracted[0][2]
    d = os.path.dirname(fp_out)
    if d:
        os.makedirs(d, exist_ok=True)
    sizes: list[int] = []
    with open(fp_out, "wb") as f:
        f.write(_box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41"))
        mdat_hdr = f.tell()
        f.write(struct.pack(">I", 8) + b"mdat")
        for samples, _, _ in extracted:
            for s in samples:
                f.write(s)
                sizes.append(len(s))
        mdat_size = f.tell() - mdat_hdr
        f.write(_moov(len(sizes), sizes, mdat_hdr + 8, w, h, out_fps))
        f.seek(mdat_hdr)
        f.write(struct.pack(">I", mdat_size))
    return True


def as_rgb_frame(img):
    """A uint8 HWC RGB frame as given (numpy array or tensor); raises on anything else."""
    t = img if isinstance(img, torch.Tensor) else np.asarray(img)
    if t.dtype not in (np.uint8, torch.uint8) or t.ndim != 3 or t.shape[2] != 3:
        raise ValueError(f"expects uint8 HWC RGB, got {t.dtype} {tuple(t.shape)}")
    return t


class MjpegMp4Writer:
    """Streaming MJPEG .mp4 writer: write_frame(uint8 HWC RGB) … finalize().
    Frames are encoded on `device` (the card unless a CPU device is given)."""

    def __init__(self, fp_movie: str, fps: float = 30, shape_hw: tuple[int, int] | None = None,
                 quality: int | None = None, max_bpp: float | None = None, device="cuda"):
        if quality is None:
            quality = int(os.environ.get("LB_JPEG_QUALITY", "90"))
        if max_bpp is None:
            max_bpp = float(os.environ.get("LB_MJPEG_MAX_BPP", "2.5"))
        self.fp_movie = fp_movie
        self.fps = fps
        self.shape_hw = tuple(shape_hw) if shape_hw is not None else None
        self.quality = int(quality)
        self.device = torch.device(device)
        # Rate control: per-frame byte budget = max_bpp × H×W / 8 (0 = off),
        # binding only on noise-like frames; quality settles ONCE, on the
        # first frame (calibrate_quality), so every sample of a movie shares
        # quant tables, as the coefficient lerp needs.
        self.max_bpp = float(max_bpp)
        self._q_min = min(self.quality, int(os.environ.get("LB_MJPEG_MIN_Q", "55")))
        self._q_settled = False
        self.nmb_frames = 0
        self._sizes: list[int] = []
        self._f = None
        self._mdat_hdr_off = 0
        # mdat writes ride an IO thread (bounded queue) so encoding overlaps
        # disk writeback; LB_MJPEG_IO_THREAD=0 writes inline on the caller
        self._ioq = None
        self._io_thread = None
        self._io_exc: BaseException | None = None
        self._io_threaded = os.environ.get("LB_MJPEG_IO_THREAD", "1") != "0"
        # on a card the encoder runs on its own stream: the host's read of
        # each sample's length then waits for the encoder's work only, not
        # for the engine's (a next transition, a deferred similarity pass)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def encoding(self):
        """Context for this writer's device work (its own stream on a card)."""
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    # -- encode ------------------------------------------------------------
    def _encode(self, rgb, quality: int | None = None) -> bytes:
        """One uint8 HWC RGB frame (numpy array or tensor) → JPEG bytes, on the device."""
        q = self.quality if quality is None else int(quality)
        frame = rgb if isinstance(rgb, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(rgb))
        with self.encoding():
            return jpeg.encode_rgb(frame.to(self.device)[None], q)[0]

    def encode_frames(self, frames: torch.Tensor) -> list[bytes]:
        """uint8 RGB frames [F, H, W, 3] on this writer's device → their JPEG
        samples at the movie's quality, one J1 and one J3 call. The movie's
        first frame settles the quality first (calibrate_quality: a J1 and a
        J3 call a probe, on that frame alone)."""
        out = []
        if not self._q_settled:
            out.append(self.calibrate_quality(lambda q: self._encode(frames[0], q)))
            frames = frames[1:]
        if len(frames):
            with self.encoding():
                out += jpeg.encode_rgb(frames, self.quality)
        return out

    # -- rate control --------------------------------------------------------
    def byte_budget(self) -> int | None:
        """Per-frame byte cap from max_bpp, or None when uncapped. A 64 KiB
        floor keeps the cap inactive for small frames (previews, tests)
        where fixed JPEG header/entropy overhead dominates the bpp math."""
        if self.max_bpp <= 0 or self.shape_hw is None:
            return None
        return max(65536, int(self.max_bpp * self.shape_hw[0] * self.shape_hw[1] / 8))

    def calibrate_quality(self, encode_at) -> bytes:
        """One-shot rate control: settle self.quality so the first sample
        fits the per-frame byte budget, then return that sample's bytes at
        the settled quality. encode_at(q: int) -> bytes. Binary search over
        [q_min, quality], ≤6 probe encodes, once per movie."""
        jpg = encode_at(self.quality)
        self._q_settled = True
        budget = self.byte_budget()
        if budget is None or len(jpg) <= budget or self.quality <= self._q_min:
            return jpg
        lo, hi = self._q_min, self.quality - 1
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            j = encode_at(mid)
            if len(j) <= budget:
                best = (mid, j)
                lo = mid + 1
            else:
                hi = mid - 1
        if best is None:  # even q_min exceeds the budget — take q_min
            self.quality = self._q_min
            return encode_at(self._q_min)
        self.quality, jpg = best
        return jpg

    # -- container ---------------------------------------------------------
    def _open(self, h: int, w: int):
        self.shape_hw = (h, w)
        d = os.path.dirname(self.fp_movie)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.fp_movie, "wb")
        self._f.write(_box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41"))
        self._mdat_hdr_off = self._f.tell()
        self._f.write(struct.pack(">I", 8) + b"mdat")  # size patched at finalize
        if self._io_threaded:
            import queue
            import threading

            self._ioq = queue.Queue(maxsize=32)
            self._io_thread = threading.Thread(target=self._io_loop, name="lb-mdat-io", daemon=True)
            self._io_thread.start()

    def _emit(self, jpg: bytes):
        if self._ioq is not None:
            if self._io_exc is not None:
                raise self._io_exc
            self._ioq.put(jpg)          # blocks when the disk falls behind
        else:
            self._f.write(jpg)
        self._sizes.append(len(jpg))

    def _io_loop(self):
        # keeps consuming until the sentinel even after a write error
        # (discarding data) so a producer blocked in put() never deadlocks;
        # the error surfaces on the next _emit or at finalize
        while True:
            item = self._ioq.get()
            if item is None:
                return
            if self._io_exc is None:
                try:
                    self._f.write(item)
                except BaseException as e:
                    self._io_exc = e

    # -- public API ----------------------------------------------------------
    def write_frame(self, img):
        img = as_rgb_frame(img)
        if self._f is None:
            h, w = (self.shape_hw or tuple(img.shape[:2]))
            self._open(h, w)
        if tuple(img.shape[:2]) != tuple(self.shape_hw):
            raise ValueError(f"frame shape {tuple(img.shape[:2])} != movie shape {self.shape_hw}")
        if not self._q_settled:
            # the first frame settles the rate-controlled quality for the movie
            self._emit(self.calibrate_quality(lambda q: self._encode(img, q)))
        else:
            self._emit(self._encode(img))
        self.nmb_frames += 1

    def encode_frame(self, img, quality: int | None = None) -> bytes:
        """Encode one uint8 HWC RGB frame to JPEG with this writer's exact
        parameters WITHOUT writing it."""
        return self._encode(as_rgb_frame(img), quality)

    def write_encoded(self, jpg: bytes):
        """Append an already-encoded JPEG sample."""
        if self._f is None:
            if self.shape_hw is None:
                raise ValueError("write_encoded before shape is known — set shape_hw")
            self._open(*self.shape_hw)
        self._emit(jpg)
        self.nmb_frames += 1

    def finalize(self):
        if self._f is None:
            return
        if self._io_thread is not None:
            self._ioq.put(None)
            self._io_thread.join()
            self._io_thread = None
            self._ioq = None
            if self._io_exc is not None:
                raise self._io_exc
        mdat_end = self._f.tell()
        mdat_size = mdat_end - self._mdat_hdr_off
        if mdat_size > 0xFFFFFFFF:
            raise RuntimeError("mdat exceeds 4 GiB; co64/large-size muxing not implemented")
        self._f.write(_moov(self.nmb_frames, self._sizes, self._mdat_hdr_off + 8,
                            self.shape_hw[1], self.shape_hw[0], self.fps))
        self._f.seek(self._mdat_hdr_off)
        self._f.write(struct.pack(">I", mdat_size))
        self._f.close()
        self._f = None
