"""The port's JPEG encoder (latentblending_tpu_torch/video/jpeg.py) against
libjpeg, on the CPU (the plain versions of kernels J1-J3).

- J1's plain version: its quantized coefficients equal libjpeg's, decoded
  from the JAX package's libjpeg-backed `encode_i420` (noise, gradient,
  flat frames; 128² and 64×192; q 90, 55, 30). Exact.
- `encode_i420` byte-equal to the JAX package's `encode_i420`; `encode_rgb`
  byte-equal to cv2.imencode (OpenCV's libjpeg-turbo), odd sizes included
  (libjpeg's edge expansion and dummy blocks), decoded frames equal.
- `CoefFrames.lerp(t)` byte-equal to the JAX package's `JpegPair.lerp(t)`
  for fractions of a 30-frame gap, 1/2 (which puts coefficients on a .5
  tie) and extreme t. The native library is built by its Makefile with
  -march=native, where g++ contracts its lerp into one FMA on hosts that
  have FMA (every x86-64 host since 2013); J2 computes that FMA.
- `quant_tables(q)` equal to the DQT tables libjpeg writes, q in 1..100,
  and `jfif_header` equal to libjpeg's header bytes.
- J3's plain coder on synthetic coefficients (long zero runs, ZRL,
  extreme values, no EOB) gives a scan that cv2.imdecode reads and whose
  coefficients decode back exactly.
- J3's kernel scheme (per-block bit counts, their scan, per-block bit
  writers into big-endian words, the last byte padded by the last block,
  chunked 0xFF stuffing) emulated with numpy gives the plain coder's bytes.
- On a card (marked `gpu`, skipped here): J1-J3 against their plain
  versions, exactly; chip_smoke.py's movie phase runs the same checks.
"""
import cv2
import numpy as np
import pytest
import torch

from latentblending_tpu.video._jpeg_lerp import JpegPair
from latentblending_tpu.video._jpeg_lerp import encode_i420 as jax_encode_i420
from latentblending_tpu.video.i420 import rgb_to_i420
from latentblending_tpu_torch.video import jpeg

SIZES = [(128, 128), (64, 192)]


def _frame(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), (200, 30, 90), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1), (xx + yy) * 255 // (h + w)], -1).astype(np.uint8)


# ---------------------------------------------------------------- a decoder

def _segments(jpg: bytes):
    """(marker, payload) of every segment before the scan, and the scan's offset."""
    i, segs = 2, []
    while True:
        marker, length = jpg[i + 1], int.from_bytes(jpg[i + 2:i + 4], "big")
        segs.append((marker, jpg[i + 4:i + 2 + length]))
        i += 2 + length
        if marker == 0xDA:
            return segs, i


def decode_coefficients(jpg: bytes) -> np.ndarray:
    """A baseline 4:2:0 JPEG's quantized coefficients [nblocks, 64], zigzag
    order, MCU order (Y00 Y01 Y10 Y11 Cb Cr), DC undifferenced."""
    segs, start = _segments(jpg)
    codes = {}
    for marker, p in segs:
        if marker == 0xC0:
            h, w = int.from_bytes(p[1:3], "big"), int.from_bytes(p[3:5], "big")
        if marker == 0xC4:
            bits, vals = list(p[1:17]), list(p[17:])
            table, code, k = {}, 0, 0
            for length, count in enumerate(bits, 1):
                for _ in range(count):
                    table[(length, code)] = vals[k]
                    code, k = code + 1, k + 1
                code <<= 1
            codes[p[0]] = table
    assert jpg[-2:] == b"\xff\xd9"
    data = jpg[start:-2].replace(b"\xff\x00", b"\xff")
    bits = bin(int.from_bytes(b"\x01" + data, "big"))[3:]
    pos = 0

    def read(n):
        nonlocal pos
        v = int(bits[pos:pos + n], 2) if n else 0
        pos += n
        return v

    def symbol(table):
        code, length = 0, 0
        while True:
            code, length = (code << 1) | read(1), length + 1
            if (length, code) in table:
                return table[(length, code)]

    def extend(v, n):
        return v - (1 << n) + 1 if n and v < (1 << (n - 1)) else v

    n_mcu = -(-h // 16) * -(-w // 16)
    out = np.zeros((n_mcu * 6, 64), np.int64)
    last = [0, 0, 0]
    for b in range(n_mcu * 6):
        comp = 0 if b % 6 < 4 else b % 6 - 3
        dc_t, ac_t = codes[0x00 if comp == 0 else 0x01], codes[0x10 if comp == 0 else 0x11]
        n = symbol(dc_t)
        last[comp] += extend(read(n), n)
        out[b, 0] = last[comp]
        k = 1
        while k < 64:
            rs = symbol(ac_t)
            if rs == 0x00:
                break
            k += rs >> 4
            n = rs & 15
            if n:
                out[b, k] = extend(read(n), n)
            k += 1
    return out


# ---------------------------------------------------------------- J1

@pytest.mark.parametrize("q", [90, 55, 30])
@pytest.mark.parametrize("kind", ["noise", "gradient", "flat"])
@pytest.mark.parametrize("hw", SIZES)
def test_fdct_quant_matches_libjpeg_coefficients(hw, kind, q):
    h, w = hw
    i420 = rgb_to_i420(_frame(kind, h, w))
    want = decode_coefficients(jax_encode_i420(i420, w, h, q))
    got = jpeg.fdct_quant(torch.from_numpy(i420)[None], q)
    assert got.dtype == torch.int16 and got.shape == (1, jpeg.num_blocks(h, w), 64)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("q", [90, 30, 100, 1])
@pytest.mark.parametrize("hw", SIZES)
def test_encode_i420_bytes_equal_libjpeg(hw, q):
    h, w = hw
    frames = [rgb_to_i420(_frame(kind, h, w, seed)) for seed, kind in enumerate(("noise", "gradient", "flat"))]
    got = jpeg.encode_i420(torch.from_numpy(np.stack(frames)), q)
    assert got == [jax_encode_i420(f, w, h, q) for f in frames]


@pytest.mark.parametrize("hw", SIZES + [(50, 70), (37, 61), (120, 116), (17, 9), (1, 1)])
def test_encode_rgb_bytes_equal_cv2(hw):
    h, w = hw
    for seed, kind in enumerate(("noise", "gradient")):
        rgb = _frame(kind, h, w, seed) if min(h, w) > 1 else _frame("noise", h, w, seed)
        for q in (90, 55):
            ok, want = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]), [int(cv2.IMWRITE_JPEG_QUALITY), q])
            assert ok
            want = want.tobytes()
            got = jpeg.encode_rgb(torch.from_numpy(rgb)[None], q)[0]
            header = jpeg.jfif_header(h, w, q)
            assert got[:len(header)] == want[:len(header)] == header
            a = cv2.imdecode(np.frombuffer(got, np.uint8), cv2.IMREAD_COLOR)
            b = cv2.imdecode(np.frombuffer(want, np.uint8), cv2.IMREAD_COLOR)
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            assert got == want, (hw, kind, q)


def test_frames_are_checked():
    with pytest.raises(ValueError, match="H % 4"):
        jpeg.fdct_quant(torch.zeros(1, 9, 4, dtype=torch.uint8), 90)
    with pytest.raises(TypeError, match="uint8"):
        jpeg.encode_rgb(torch.zeros(1, 8, 8, 3), 90)
    with pytest.raises(ValueError, match="RGB"):
        jpeg.encode_rgb(torch.zeros(1, 8, 8, dtype=torch.uint8), 90)


# ---------------------------------------------------------------- J2

@pytest.mark.parametrize("hw", SIZES)
def test_coef_frames_lerp_bytes_equal_jpeg_pair(hw):
    h, w = hw
    a, b = (rgb_to_i420(_frame("noise", h, w, seed)) for seed in (3, 4))
    pair = JpegPair(jax_encode_i420(a, w, h, 90), jax_encode_i420(b, w, h, 90))
    ca, cb = (jpeg.fdct_quant(torch.from_numpy(f)[None], 90)[0] for f in (a, b))
    gap = jpeg.CoefFrames(ca, cb, h, w, 90)
    # t = 1/2 puts every coefficient of odd a + b on a .5 tie (rounded away from 0)
    assert int(((ca.int() + cb.int()) % 2).sum()) > 1000
    fracts = list(np.linspace(0, 1, 32)[1:-1]) + [0.0, 0.5, 1.0, 1 / 3, 1e-7, 1 - 1e-7]
    for t in fracts:
        assert gap.lerp(float(t)) == pair.lerp(float(t)), t
    with pytest.raises(ValueError, match="CoefFrames"):
        jpeg.CoefFrames(ca, cb[:-6], h, w, 90)


def test_coef_lerp_reference_is_one_fma():
    """The plain J2 rounds (1-t)·a + t·b once after t·b (fmaf), not after each product."""
    a = torch.arange(-2048, 2048, dtype=torch.int16)
    b = torch.flip(a, [0])
    for t in (0.1, 0.3, 1 / 3, 0.7, 2.0 ** -20, 1 - 2.0 ** -20):
        tf = np.float32(t)
        wi = np.float32(1) - tf
        tb = (tf * b.numpy().astype(np.float32)).astype(np.float64)
        v = (np.float64(wi) * a.numpy() + tb).astype(np.float32)  # exact here: few significant bits
        want = np.trunc(np.where(v >= 0, v + np.float32(0.5), v - np.float32(0.5))).astype(np.int16)
        np.testing.assert_array_equal(jpeg.coef_lerp(a, b, t).numpy(), want)


# ---------------------------------------------------------------- headers

def test_quant_tables_and_header_equal_libjpeg():
    i420 = rgb_to_i420(_frame("noise", 16, 16))
    for q in range(1, 101):
        jpg = jax_encode_i420(i420, 16, 16, q)
        header = jpeg.jfif_header(16, 16, q)
        assert jpg[:len(header)] == header, q
        dqt = [p for m, p in _segments(jpg)[0] if m == 0xDB]
        tables = jpeg.quant_tables(q)
        for tid in range(2):
            assert dqt[tid][0] == tid
            assert list(dqt[tid][1:]) == tables[tid][jpeg.NATURAL_ORDER].tolist(), q


# ---------------------------------------------------------------- J3

def _synthetic_coefficients(n_mcu: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    c = np.zeros((n_mcu * 6, 64), np.int64)
    c[:, 0] = rng.integers(-1023, 1024, n_mcu * 6)
    c[::7, 0] = 1023 * (-1) ** np.arange(len(c[::7]))  # DC differences up to 11 bits
    for b in range(len(c)):
        kind = b % 5
        if kind == 0:  # dense, ends on a nonzero (no EOB)
            c[b, 1:] = rng.integers(-3, 4, 63)
            c[b, 63] = 5
        elif kind == 1:  # long zero runs: ZRL
            c[b, [17, 40, 63]] = [1023, -1023, -1]
        elif kind == 2:  # a run of exactly 16 zeros, then EOB
            c[b, [1, 18]] = [-512, 7]
        elif kind == 3:
            c[b, 1:] = rng.integers(-1023, 1024, 63) * (rng.random(63) < 0.2)
        # kind 4: DC only
    return torch.from_numpy(c).to(torch.int16)


@pytest.mark.parametrize("hw", [(48, 64), (16, 16)])
def test_huffman_reference_scan_decodes(hw):
    h, w = hw
    coef = _synthetic_coefficients(jpeg.num_blocks(h, w) // 6, seed=h)
    jpg = jpeg.encode_coefs(coef, h, w, 50)
    np.testing.assert_array_equal(decode_coefficients(jpg), coef.numpy())
    img = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)
    assert img is not None and img.shape == (h, w, 3)
    # a libjpeg frame's coefficients, coded by the plain J3, give libjpeg's scan
    i420 = rgb_to_i420(_frame("noise", 128, 128, 9))
    want = jax_encode_i420(i420, 128, 128, 75)
    coef = torch.from_numpy(decode_coefficients(want)).to(torch.int16)
    assert jpeg.encode_coefs(coef, 128, 128, 75) == want


def _emulate_j3(coef: torch.Tensor) -> bytes:
    """csrc/jpeg.cu's J3 scheme in numpy/Python: block n's bits from the
    DC of block prev_block(n) alone; offsets by a scan of the counts; each
    block ORs its bits into big-endian 32-bit words; the last block pads;
    stuffing by 64-byte chunks with a scan of their 0xFF counts."""
    c = coef.numpy().astype(np.int64)
    n = len(c)
    t = jpeg.HUFF_TABLES

    def prev_block(i):
        p = i % 6
        if 0 < p < 4:
            return i - 1
        if p == 0:
            return i - 3 if i >= 6 else -1
        return i - 6 if i >= 6 else -1

    def code_block(i):
        dc, ac = (t[0], t[1]) if i % 6 < 4 else (t[2], t[3])
        pn = prev_block(i)
        diff = int(c[i, 0]) - (int(c[pn, 0]) if pn >= 0 else 0)
        nb = abs(diff).bit_length()
        out = [tuple(dc[nb])] + ([((diff - 1 if diff < 0 else diff) & ((1 << nb) - 1), nb)] if nb else [])
        run = 0
        for k in range(1, 64):
            v = int(c[i, k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                out.append(tuple(ac[0xF0]))
                run -= 16
            nb = abs(v).bit_length()
            out += [tuple(ac[(run << 4) + nb]), ((v - 1 if v < 0 else v) & ((1 << nb) - 1), nb)]
            run = 0
        if run:
            out.append(tuple(ac[0]))
        return out

    symbols = [code_block(i) for i in range(n)]
    ends = np.cumsum([sum(s for _, s in syms) for syms in symbols])
    words = np.zeros(int(ends[-1]) // 32 + 2, np.uint64)

    def put(pos, code, size):
        if size == 0:
            return
        w, room = pos >> 5, 32 - (pos & 31)
        if size <= room:
            words[w] |= np.uint64(code << (room - size))
        else:
            words[w] |= np.uint64(code >> (size - room))
            words[w + 1] |= np.uint64((code << (32 - (size - room))) & 0xFFFFFFFF)

    for i, syms in enumerate(symbols):
        pos = int(ends[i - 1]) if i else 0
        for code, size in syms:
            put(pos, int(code), int(size))
            pos += int(size)
        if i == n - 1:
            pad = (8 - (pos & 7)) & 7
            put(pos, (1 << pad) - 1, pad)
    nbytes = (int(ends[-1]) + 7) >> 3
    stream = [int(words[k >> 2] >> np.uint64(24 - 8 * (k & 3))) & 0xFF for k in range(nbytes)]
    chunks = -(-nbytes // 64)
    ff_ends = np.cumsum([sum(b == 0xFF for b in stream[ci * 64:(ci + 1) * 64]) for ci in range(chunks)])
    out = bytearray(nbytes + int(ff_ends[-1]))
    for ci in range(chunks):
        dst = ci * 64 + (int(ff_ends[ci - 1]) if ci else 0)
        for b in stream[ci * 64:(ci + 1) * 64]:
            out[dst] = b
            dst += 1
            if b == 0xFF:
                out[dst] = 0
                dst += 1
    return bytes(out)


def test_huffman_kernel_scheme_matches_reference():
    frames = [_synthetic_coefficients(12, seed=5)]
    for kind in ("noise", "gradient"):
        i420 = rgb_to_i420(_frame(kind, 64, 96, 2))
        frames.append(jpeg.fdct_quant(torch.from_numpy(i420)[None], 90)[0])
    refs = [jpeg.huffman_scan_reference(coef) for coef in frames]
    assert sum(r.count(b"\xff\x00") for r in refs) > 10  # the stuffing pass has work
    for coef, ref in zip(frames, refs):
        assert _emulate_j3(coef) == ref


# ---------------------------------------------------------------- on a card

@pytest.mark.gpu
def test_jpeg_kernels_match_plain_versions_on_gpu():
    """J1 (I420 and RGB, 512² and odd sizes), J2 (fractions of a gap) and
    J3 on the card, each equal to its plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    for (h, w), fmt in [((512, 512), "i420"), ((512, 512), "rgb"), ((120, 116), "i420"), ((50, 70), "rgb")]:
        shape = (2, h * 3 // 2, w) if fmt == "i420" else (2, h, w, 3)
        frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        n = jpeg.launches_fdct
        got = jpeg.fdct_quant(frames, 90, fmt)
        assert jpeg.launches_fdct == n + 1
        assert torch.equal(got, jpeg.fdct_quant_reference(frames, 90, fmt)), (h, w, fmt)
        assert jpeg.huffman_scan(got[1]) == jpeg.huffman_scan_reference(got[1]), (h, w, fmt)
    a, b = got[0], got[1]
    for t in (0.25, 0.5, 1 / 3):
        assert torch.equal(jpeg.coef_lerp(a, b, t), jpeg.coef_lerp_reference(a, b, t)), t
