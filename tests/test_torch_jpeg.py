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
- J3's batched kernel scheme (one warp per block: lanes' symbols from two
  ballots, a shuffle scan of their bits; a frame-local scan of the blocks;
  each frame's bytes, 16-byte word regions and stuffing tiles; words staged
  and stored, edges ORed; 0xFF counts by tiles, their scan, the scatter)
  emulated with numpy on 1, 2 and 5 mixed frames gives each frame's plain
  scan, packed; a flattened DC index would not.
- `huffman_scan_batch`, `coef_lerp_batch` and `CoefFrames.lerp_many` (one
  J2 and one J3 call for a gap; at t = 1 b's own sample) equal the plain
  coder, the plain lerp and the JAX package's `JpegPair.lerp` frame by
  frame; a gap split over several calls (MAX_CALL_COEF_BYTES lowered)
  keeps its samples' order.
- J1's integer scheme: every intermediate of both passes below 2^29 for
  any samples (an analytic bound), so the kernel's 32-bit arithmetic is
  exact; its reciprocal quantizer exact for every numerator below 2^16 and
  every 8q. The kernel's own source runs on the CPU against the plain
  version in tests/test_torch_jpeg_kernel_source.py.
- On a card (marked `gpu`, skipped here): J1-J3, single and batched,
  against their plain versions, exactly, J1 also at the movie path's
  batches; chip_smoke.py's movie phase runs the same checks.
"""
import cv2
import numpy as np
import pytest
import torch

from latentblending_tpu.video._jpeg_lerp import JpegPair
from latentblending_tpu.video._jpeg_lerp import encode_i420 as jax_encode_i420
from latentblending_tpu.video.i420 import rgb_to_i420
from latentblending_tpu_torch import profiling
from latentblending_tpu_torch.video import jpeg
from tests.test_torch_jpeg_kernel_source import J1_SIZES, j1_frames

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


# ---------------------------------------------------------------- J1's integer bounds

def _fdct_linear(first: bool) -> tuple[np.ndarray, dict]:
    """One pass of jpeg_fdct_islow as linear maps of its 8 inputs (descale
    as exact division): the outputs [8, 8] and each intermediate [8]."""
    s = list(np.eye(8))
    tmp0, tmp7, tmp1, tmp6 = s[0] + s[7], s[0] - s[7], s[1] + s[6], s[1] - s[6]
    tmp2, tmp5, tmp3, tmp4 = s[2] + s[5], s[2] - s[5], s[3] + s[4], s[3] - s[4]
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    odd = 2.0 ** (11 if first else 15)
    z1 = (tmp12 + tmp13) * 4433
    z5 = (tmp4 + tmp5 + tmp6 + tmp7) * 9633
    o1, o2 = (tmp4 + tmp7) * -7373, (tmp5 + tmp6) * -20995
    o3, o4 = (tmp4 + tmp6) * -16069 + z5, (tmp5 + tmp7) * -3196 + z5
    terms = {"e2": z1 + tmp13 * 6270, "e6": z1 + tmp12 * -15137, "z5": z5, "o1": o1, "o2": o2, "o3": o3, "o4": o4,
             "x7": tmp4 * 2446 + o1 + o3, "x5": tmp5 * 16819 + o2 + o4, "x3": tmp6 * 25172 + o2 + o3,
             "x1": tmp7 * 12299 + o1 + o4, "x7a": tmp4 * 2446 + o1, "x5a": tmp5 * 16819 + o2,
             "x3a": tmp6 * 25172 + o2, "x1a": tmp7 * 12299 + o1}
    dc = 4.0 if first else 0.25
    out = np.stack([(tmp10 + tmp11) * dc, terms["x1"] / odd, terms["e2"] / odd, terms["x3"] / odd,
                    (tmp10 - tmp11) * dc, terms["x5"] / odd, terms["e6"] / odd, terms["x7"] / odd])
    return out, terms


def _worst(coef: np.ndarray, slack: float = 0.0) -> float:
    """max |coef · x| over samples x in [-128, 127], plus `slack` per unit of |coef|."""
    return max(float((np.where(coef > 0, 127, -128) * coef).sum()), float((np.where(coef > 0, 128, -127) * coef).sum())) \
        + slack * float(np.abs(coef).sum())


# every int32 intermediate of J1 stays below this for any samples (test below)
J1_INTERMEDIATE_BOUND = 1 << 29


def test_fdct_intermediates_fit_int32_for_any_samples():
    """Every intermediate of both passes, as a linear map of the block's 64
    level-shifted samples in [-128, 127], with the row pass's rounding (at
    most 1 per output) as slack: the largest (the column pass's z2 term,
    3.4e8) is below 2^29, so 32-bit integers hold the whole transform."""
    rows, row_terms = _fdct_linear(True)
    _, col_terms = _fdct_linear(False)
    worst = max(_worst(t) for t in row_terms.values())
    for t in col_terms.values():
        for c in range(8):  # column c's input j is row j's output c: a map of the 64 samples
            worst = max(worst, _worst(np.outer(t, rows[c]), slack=1.0 / 128))
    assert 3.0e8 < worst < J1_INTERMEDIATE_BOUND


def test_quant_reciprocal_is_exact():
    """(|x| + 4q) / 8q as the high word of (|x| + 4q) · ceil(2^32 / 8q):
    exact for every numerator below 2^16 and every 8q in [8, 2040]; J1's
    numerators stay below 8192 + 1020."""
    n = np.arange(1 << 16, dtype=np.uint64)
    for d in range(8, 2041, 8):
        m = np.uint64(jpeg.quant_reciprocal(d))
        np.testing.assert_array_equal((n * m) >> np.uint64(32), n // np.uint64(d), err_msg=f"8q = {d}")
    table = jpeg._fdct_table(75)
    q = jpeg.quant_tables(75)
    np.testing.assert_array_equal(table[..., 1] & 0xFFFF, 4 * q)
    np.testing.assert_array_equal(table[..., 1] >> 16, np.broadcast_to(jpeg.ZIGZAG_POS, (2, 64)))
    assert (jpeg.NATURAL_ORDER[jpeg.ZIGZAG_POS] == np.arange(64)).all()


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


@pytest.mark.parametrize("hw", SIZES)
def test_coef_frames_lerp_many_bytes_equal_jpeg_pair(hw):
    """lerp_many codes a gap in one J2 and one J3 call: each sample is
    JpegPair.lerp's, and at t = 1 (the writer's last fraction of a gap)
    b's own, libjpeg's encode of b."""
    h, w = hw
    a, b = (rgb_to_i420(_frame("noise", h, w, seed)) for seed in (5, 6))
    pair = JpegPair(jax_encode_i420(a, w, h, 80), jax_encode_i420(b, w, h, 80))
    ca, cb = (jpeg.fdct_quant(torch.from_numpy(f)[None], 80)[0] for f in (a, b))
    gap = jpeg.CoefFrames(ca, cb, h, w, 80)
    fracts = [float(t) for t in np.linspace(0, 1, 23)[1:-1]] + [0.5, 1e-7]
    assert gap.lerp_many(fracts) == [pair.lerp(t) for t in fracts]
    got = gap.lerp_many(fracts[:3] + [1.0])
    assert got == [pair.lerp(t) for t in fracts[:3]] + [jax_encode_i420(b, w, h, 80)]
    assert gap.lerp_many([]) == []


@pytest.mark.parametrize("per_call", [1, 3])
def test_coef_frames_lerp_many_splits_long_gaps_in_order(monkeypatch, per_call):
    """Above MAX_CALL_COEF_BYTES a gap is coded in several J2 + J3 calls of
    at most that many coefficients each; the samples keep the fractions'
    order and are JpegPair.lerp's, b's own at t = 1."""
    h, w = SIZES[0]
    a, b = (rgb_to_i420(_frame("noise", h, w, seed)) for seed in (7, 8))
    pair = JpegPair(jax_encode_i420(a, w, h, 80), jax_encode_i420(b, w, h, 80))
    ca, cb = (jpeg.fdct_quant(torch.from_numpy(f)[None], 80)[0] for f in (a, b))
    monkeypatch.setattr(jpeg, "MAX_CALL_COEF_BYTES", ca.numel() * 2 * per_call + 1)
    calls = []
    lerp_batch = jpeg.coef_lerp_batch
    monkeypatch.setattr(jpeg, "coef_lerp_batch", lambda x, y, ts: calls.append(list(ts)) or lerp_batch(x, y, ts))
    fracts = [float(t) for t in np.linspace(0, 1, 9)[1:]]
    got = jpeg.CoefFrames(ca, cb, h, w, 80).lerp_many(fracts)
    assert calls == [fracts[i:i + per_call] for i in range(0, len(fracts), per_call)]
    assert got == [pair.lerp(t) for t in fracts[:-1]] + [jax_encode_i420(b, w, h, 80)]


def test_coef_lerp_batch_equals_reference_per_fraction():
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.integers(-1024, 1024, (36, 64))).to(torch.int16) for _ in range(2))
    ts = [0.0, 1 / 3, 0.5, 0.7, 1.0, 2.0 ** -20] + [float(t) for t in np.linspace(0, 1, 40)[1:-1]]
    got = jpeg.coef_lerp_batch(a, b, ts)
    assert got.shape == (len(ts), 36, 64) and got.dtype == torch.int16
    for t, g in zip(ts, got):
        assert torch.equal(g, jpeg.coef_lerp_reference(a, b, t)), t
    assert torch.equal(jpeg.coef_lerp(a, b, ts[1]), got[1])
    assert jpeg.coef_lerp_batch(a, b, []).shape == (0, 36, 64)
    with pytest.raises(ValueError, match="coef_lerp"):
        jpeg.coef_lerp_batch(a, b[:-1], ts)


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


def _spread_bits(x: int) -> int:
    """csrc/jpeg.cu spread_bits: bit i of a 32-bit x to bit 2i."""
    v = x
    for shift, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF), (4, 0x0F0F0F0F0F0F0F0F),
                        (2, 0x3333333333333333), (1, 0x5555555555555555)):
        v = (v | (v << shift)) & mask
    return v


def _symbol(table, index_base: int, v: int) -> tuple[int, int]:
    """csrc/jpeg.cu symbol(): the code of table[index_base + size] and v's value bits, packed."""
    nb = abs(v).bit_length()
    code, size = (int(x) for x in table[index_base + nb])
    return (code << nb) | ((v - 1 if v < 0 else v) & ((1 << nb) - 1)), size + nb


def _lane_codes(c: np.ndarray, j: int, pred: int) -> list[list[tuple[int, int]]]:
    """csrc/jpeg.cu lane_code for every lane of the warp coding one block
    (zigzag coefficients c [64], frame-local index j, DC predictor pred):
    each lane's (packed code, bits) in stream order. Lane l holds
    coefficients 2l and 2l+1; the nonzero mask comes from two ballots
    spread into one 64-bit word, runs from the highest set bit below."""
    t = jpeg.HUFF_TABLES
    dc, ac = (t[0], t[1]) if j % 6 < 4 else (t[2], t[3])
    even = sum(1 << l for l in range(32) if c[2 * l])
    odd = sum(1 << l for l in range(32) if c[2 * l + 1])
    nz = (_spread_bits(even) | (_spread_bits(odd) << 1)) & ~1
    zrl = tuple(int(x) for x in ac[0xF0])
    lanes = []
    for lane in range(32):
        syms = [_symbol(dc, 0, int(c[0]) - pred)] if lane == 0 else []
        for k in (2 * lane, 2 * lane + 1):
            if k == 0 or not c[k]:
                continue
            below = nz & ((1 << k) - 1)
            run = k - (below.bit_length() - 1 if below else 0) - 1
            syms += [zrl] * (run >> 4) + [_symbol(ac, (run & 15) << 4, int(c[k]))]
        if lane == 31 and not nz >> 63:
            syms.append(tuple(int(x) for x in ac[0]))
        lanes.append(syms)
    return lanes


def _prev_block(j: int) -> int:
    p = j % 6
    if 0 < p < 4:
        return j - 1
    if p == 0:
        return j - 3 if j >= 6 else -1
    return j - 6 if j >= 6 else -1


def _emulate_j3(coef: torch.Tensor, frame_local: bool = True) -> tuple[bytes, list[int]]:
    """csrc/jpeg.cu's batched J3 in numpy/Python on coef [F, n, 64]: the
    packed stuffed scans and their offsets [F+1].

    huff_count: each block's bits from its lanes' symbols. huff_scan: each
    block's first bit counted from its frame's (frame_local=False predicts
    the DC across frames instead, the bug a flattened index would make).
    huff_plan: the frames' byte, word (16-byte regions) and tile offsets.
    huff_write: each warp stages its block's bits from its lanes' offsets
    (a shuffle scan), the frame's last block pads, and the staged words go
    out, interior words stored plainly, the first and last ORed (the test
    checks that no other block touches an interior word). stuff_count,
    stuff_scan, stuff_scatter: 16 bytes a thread, tiles of _TILE_BYTES
    within a frame, each frame's first stuffed byte from its first tile's
    prefix."""
    c = coef.numpy().astype(np.int64)
    F, n = c.shape[:2]
    flat = c.reshape(F * n, 64)
    tile = jpeg._TILE_BYTES

    def codes(b):
        f, j = divmod(b, n)
        pj = _prev_block(j if frame_local else b)
        pb = (f * n + pj) if frame_local else pj
        return _lane_codes(flat[b], j, int(flat[pb, 0]) if pj >= 0 else 0)

    lanes = [codes(b) for b in range(F * n)]
    bits = np.array([sum(s for syms in ls for _, s in syms) for ls in lanes], np.int64).reshape(F, n)
    off = np.cumsum(bits, axis=1) - bits
    frame_bytes = (bits.sum(axis=1) + 7) >> 3
    plan = [np.concatenate([[0], np.cumsum(v)]) for v in
            (frame_bytes, ((frame_bytes + 15) >> 4) << 2, -(-frame_bytes // tile))]
    words = np.zeros(int(plan[1][F]), np.uint64)
    interior, edge = set(), set()
    for b in range(F * n):
        f, j = divmod(b, n)
        g = 32 * int(plan[1][f]) + int(off[f, j])
        sh, total = g & 31, int(bits[f, j])
        pad = (8 - ((int(off[f, j]) + total) & 7)) & 7 if j == n - 1 else 0
        stage = [0] * 72

        def put(pos, code, size):
            if size == 0:
                return
            w, room = pos >> 5, 32 - (pos & 31)
            if size <= room:
                stage[w] |= code << (room - size)
            else:
                stage[w] |= code >> (size - room)
                stage[w + 1] |= (code << (32 - (size - room))) & 0xFFFFFFFF

        pos = sh
        for lane, syms in enumerate(lanes[b]):  # pos runs through the lanes' exclusive prefixes
            for code, size in syms:
                put(pos, code, size)
                pos += size
        put(pos, (1 << pad) - 1, pad)
        nw = (sh + total + pad + 31) >> 5
        for i in range(nw):
            w = (g >> 5) + i
            (edge if i in (0, nw - 1) else interior).add(w)
            words[w] |= np.uint64(stage[i])
    assert not interior & edge, "an interior word shared with another block"
    stream = [(int(words[k >> 2]) >> (24 - 8 * (k & 3))) & 0xFF for k in range(4 * len(words))]

    def tile_bytes(t):
        f = int(np.searchsorted(plan[2], t, side="right")) - 1
        k0 = (t - int(plan[2][f])) * tile
        base, u = 4 * int(plan[1][f]), int(plan[0][f + 1] - plan[0][f])
        return f, k0, [stream[base + k0 + 16 * th: base + k0 + 16 * th + 16] if k0 + 16 * th < u else []
                       for th in range(tile // 16)]

    tiles = int(plan[2][F])
    tile_ff = [sum(x.count(0xFF) for x in tile_bytes(t)[2]) for t in range(tiles)]
    tile_pre = np.concatenate([[0], np.cumsum(tile_ff)])
    stuffed = [int(plan[0][f]) + int(tile_pre[int(plan[2][f])]) for f in range(F + 1)]
    out = bytearray(2 * int(plan[0][F]) + 16)
    for t in range(tiles):
        f, k0, threads = tile_bytes(t)
        u = int(plan[0][f + 1] - plan[0][f])
        ex = 0
        for th, x in enumerate(threads):
            k = k0 + 16 * th
            if k < u:
                dst = int(plan[0][f]) + int(tile_pre[t]) + k + ex
                for byte in x[:min(16, u - k)]:
                    out[dst] = byte
                    dst += 1
                    if byte == 0xFF:
                        out[dst] = 0
                        dst += 1
            ex += x.count(0xFF)
    return bytes(out[:stuffed[F]]), stuffed


def _mixed_frames(F: int) -> torch.Tensor:
    """F frames' coefficients at 64×96, each scan of another length: I420
    noise at q 100 (a 0xFF byte to stuff in every ~100), flat and gradient
    at q 90 (short scans), synthetic (ZRL, no EOB)."""
    def frame(i):
        kind = ("noise", "flat", "gradient", "synthetic", "noise")[i % 5]
        if kind == "synthetic":
            return _synthetic_coefficients(24, seed=i)
        if kind == "noise":
            i420 = np.random.default_rng(i).integers(0, 256, (96, 96), dtype=np.uint8)
            return jpeg.fdct_quant(torch.from_numpy(i420)[None], 100)[0]
        i420 = rgb_to_i420(_frame(kind, 64, 96, i))
        return jpeg.fdct_quant(torch.from_numpy(i420)[None], 90)[0]
    return torch.stack([frame(i) for i in range(F)])


def test_huffman_kernel_scheme_matches_reference():
    frames = [_synthetic_coefficients(12, seed=5)]
    for kind in ("noise", "gradient"):
        i420 = rgb_to_i420(_frame(kind, 64, 96, 2))
        frames.append(jpeg.fdct_quant(torch.from_numpy(i420)[None], 90)[0])
    refs = [jpeg.huffman_scan_reference(coef) for coef in frames]
    assert sum(r.count(b"\xff\x00") for r in refs) > 10  # the stuffing pass has work
    for coef, ref in zip(frames, refs):
        assert _emulate_j3(coef[None]) == (ref, [0, len(ref)])


@pytest.mark.parametrize("F", [1, 2, 5])
def test_huffman_batch_scheme_matches_reference(F):
    """The batched scheme on F mixed frames packs each frame's own scan
    (frame-local DC, padding and stuffing) back to back."""
    coef = _mixed_frames(F)
    refs = [jpeg.huffman_scan_reference(c) for c in coef]
    packed, offs = _emulate_j3(coef)
    assert offs == list(np.cumsum([0] + [len(r) for r in refs]))
    assert packed == b"".join(refs)
    if F == 5:
        assert len({len(r) for r in refs}) == F and refs[0].count(b"\xff\x00") > 100


def test_huffman_batch_scheme_predicts_dc_within_each_frame():
    """Frame 1's first blocks predict their DC from 0, not from frame 0's
    last blocks: a scheme that indexed the flattened batch would differ."""
    coef = torch.zeros((2, 12, 64), dtype=torch.int16)
    coef[0, :, 0] = 300
    coef[1, :, 0] = torch.arange(12, dtype=torch.int16) * 7 - 40
    refs = [jpeg.huffman_scan_reference(c) for c in coef]
    assert _emulate_j3(coef) == (b"".join(refs), [0, len(refs[0]), len(refs[0]) + len(refs[1])])
    assert _emulate_j3(coef, frame_local=False)[0] != b"".join(refs)


@pytest.mark.parametrize("F", [1, 2, 5])
def test_huffman_scan_batch_equals_reference(F):
    coef = _mixed_frames(F)
    assert jpeg.huffman_scan_batch(coef) == [jpeg.huffman_scan_reference(c) for c in coef]
    assert jpeg.encode_coefs_batch(coef, 64, 96, 90) == [jpeg.encode_coefs(c, 64, 96, 90) for c in coef]
    with pytest.raises(ValueError, match="huffman_scan_batch"):
        jpeg.huffman_scan_batch(coef[:, :-1])


# ---------------------------------------------------------------- on a card

@pytest.mark.gpu
def test_jpeg_kernels_match_plain_versions_on_gpu():
    """J1 (I420 and RGB, 512² and odd sizes), J2 (fractions of a gap, one
    and batched) and J3 (one frame and batches of mixed frames) on the
    card, each equal to its plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    for (h, w), fmt in [((512, 512), "i420"), ((512, 512), "rgb"), ((120, 116), "i420"), ((50, 70), "rgb")]:
        shape = (2, h * 3 // 2, w) if fmt == "i420" else (2, h, w, 3)
        frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        n = profiling.counter("J1")
        got = jpeg.fdct_quant(frames, 90, fmt)
        assert profiling.counter("J1") == n + 1
        assert torch.equal(got, jpeg.fdct_quant_reference(frames, 90, fmt)), (h, w, fmt)
        assert jpeg.huffman_scan(got[1]) == jpeg.huffman_scan_reference(got[1]), (h, w, fmt)
        n, nf = profiling.counter("J3"), profiling.counter("J3_frames")
        assert jpeg.huffman_scan_batch(got) == [jpeg.huffman_scan_reference(c) for c in got], (h, w, fmt)
        assert (profiling.counter("J3"), profiling.counter("J3_frames")) == (n + 1, nf + 2)
    a, b = got[0], got[1]
    for t in (0.25, 0.5, 1 / 3):
        assert torch.equal(jpeg.coef_lerp(a, b, t), jpeg.coef_lerp_reference(a, b, t)), t
    ts = [float(t) for t in np.linspace(0, 1, 42)[1:-1]]  # more fractions than one launch takes
    n = profiling.counter("J2")
    assert torch.equal(jpeg.coef_lerp_batch(a, b, ts), jpeg.coef_lerp_batch_reference(a, b, ts))
    assert profiling.counter("J2") == n + 1
    for x in (a.flatten()[1:9], a.flatten()[:12]):  # misaligned; not a multiple of 8
        with pytest.raises(ValueError, match="16-byte"):
            jpeg.coef_lerp_batch(x, x, [0.5])
    mixed = _mixed_frames(5).cuda()
    assert jpeg.huffman_scan_batch(mixed) == [jpeg.huffman_scan_reference(c) for c in mixed.cpu()]
    out, offs, plan = jpeg.huffman_scan_device(mixed)
    out2, offs2 = jpeg._huffman_scan_replay(mixed, plan)
    assert torch.equal(offs, offs2) and torch.equal(out[:int(offs[-1])], out2[:int(offs2[-1])])
    with pytest.raises(ValueError, match="plan"):
        jpeg._huffman_scan_replay(mixed, plan[:, :-1])


@pytest.mark.gpu
def test_fdct_quant_batches_match_plain_version_on_gpu():
    """J1 at the movie path's batches on the card: a fetch chunk of four
    512² I420 keyframes, twelve 512² RGB keyframes, a pixel gap's 34 RGB
    frames, an odd I420 size (516×772) and the checkerboards, at several
    qualities, each one launch coding every frame, equal to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.default_rng(1)
    cases = [((4, 768, 512), "i420"), ((12, 512, 512, 3), "rgb"), ((34, 512, 512, 3), "rgb"),
             ((2, 774, 772), "i420")]
    for shape, fmt in cases:
        frames = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        for q in (90, 55, 100):
            n, nf = profiling.counter("J1"), profiling.counter("J1_frames")
            got = jpeg.fdct_quant(frames, q, fmt)
            assert (profiling.counter("J1"), profiling.counter("J1_frames")) == (n + 1, nf + shape[0])
            assert torch.equal(got, jpeg.fdct_quant_reference(frames, q, fmt)), (shape, fmt, q)
    for kind in ("zeros", "ones", "checker1", "checker8"):
        for fmt, (h, w) in J1_SIZES + [("i420", (512, 512)), ("rgb", (512, 512))]:
            frames = torch.from_numpy(j1_frames(kind, fmt, h, w)).cuda()
            for q in (1, 50, 90, 100):
                assert torch.equal(jpeg.fdct_quant(frames, q, fmt), jpeg.fdct_quant_reference(frames, q, fmt)), \
                    (kind, fmt, h, w, q)
