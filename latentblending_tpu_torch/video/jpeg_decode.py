"""Baseline JPEG decoding on the host: what libjpeg does for read_movie_frames.

The JAX package reads movies back through cv2 (libjpeg and FFmpeg); the
card's machine has neither, so the port decodes its MJPEG samples here,
in numpy, the way libjpeg(-turbo) and so PIL decode them:

- markers SOI, APPn, COM, DQT, SOF0/SOF1 (8-bit), DHT, SOS, DRI, RSTn, EOI;
  SOF2 (progressive), arithmetic coding (SOF9-11, DAC), lossless and
  hierarchical frames and 12-bit data raise ValueError naming what was
  found;
- sequential Huffman scans, interleaved or not, with the tables the file
  carries (so PIL's `optimize=True` tables work as the standard ones do),
  and restart intervals;
- 1 component (returned as [H, W]) or 3 (YCbCr, returned as RGB
  [H, W, 3]) at 4:2:0 or 4:4:4.

The pixel half is libjpeg's integer arithmetic, vectorized over blocks:
dequantize and the "islow" IDCT of jidctint.c (with its range-limit
table), the 2×2 chroma upsampling libjpeg-turbo picks (h2v2_fancy_upsample
of jdsample.c, edge rows and columns as its context buffers give them;
plain replication for planes at most 2 samples wide), and ycc_rgb_convert
of jdcolor.c. The entropy
decode is the one sequential part: a 16-bit lookahead table per Huffman
table gives a symbol's code length, run and value in one lookup, as
jdhuff.c's lookahead does for the code alone (codes whose code and value
bits exceed 16 take a slower path).
"""
from __future__ import annotations

import array
import struct

import numpy as np

# natural (row-major) index of the k-th zigzag coefficient (jpeg_natural_order)
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

_SOF_KINDS = {
    0xC2: "progressive DCT (SOF2)", 0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical progressive (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic progressive (SOF10)", 0xCB: "arithmetic lossless (SOF11)",
    0xCC: "arithmetic coding conditioning (DAC)", 0xCD: "arithmetic hierarchical (SOF13)",
    0xCE: "arithmetic hierarchical progressive (SOF14)", 0xCF: "arithmetic hierarchical lossless (SOF15)",
    0xDC: "a DNL marker",
}


# ------------------------------------------------------------------ Huffman tables

_LUT_CACHE: dict = {}
_LUT_CACHE_SIZE = 32  # tables kept: a movie's samples share theirs


def _lookahead(kind: str, bits: bytes, vals: bytes) -> list:
    """The 16-bit lookahead table of one Huffman table: for every 16-bit
    window a tuple (bits consumed, run, value).

    DC ("dc"): (code + value bits, 0, difference). AC ("ac"): (code + value
    bits, zero run, coefficient); EOB is (code bits, 64, 0), which ends the
    block, and ZRL (code bits, 15, 0), 16 zeros. Windows whose code and
    value bits exceed 16 hold (0, code bits, symbol); windows that start no
    code hold (0, 0, 0)."""
    key = (kind, bits, vals)
    lut = _LUT_CACHE.get(key)
    if lut is not None:
        return lut
    if len(_LUT_CACHE) >= _LUT_CACHE_SIZE:
        _LUT_CACHE.clear()  # files with tables of their own (optimize=True) would grow it without end
    length = np.zeros(1 << 16, np.int64)
    symbol = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            if code + 1 > (1 << n):
                raise ValueError("jpeg: a Huffman table with more codes than its lengths allow")
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            length[lo:hi], symbol[lo:hi] = n, vals[k]
            code, k = code + 1, k + 1
        code <<= 1
    window = np.arange(1 << 16, dtype=np.int64)
    size = symbol & 15 if kind == "ac" else symbol
    run = symbol >> 4 if kind == "ac" else np.zeros_like(symbol)
    total = length + size
    raw = (window >> np.clip(16 - total, 0, 16)) & ((1 << size) - 1)
    value = np.where(raw < (1 << np.maximum(size - 1, 0)), raw - (1 << size) + 1, raw)
    value = np.where(size == 0, 0, value)
    fits = (length > 0) & (total <= 16)
    adv = np.where(fits, total, 0)
    if kind == "ac":
        eob = fits & (size == 0) & (run != 15)  # libjpeg ends the block on any run with size 0 but ZRL
        run = np.where(eob, 64, run)
    first = np.where(fits, run, length)
    second = np.where(fits, value, symbol)
    lut = list(zip(adv.tolist(), first.tolist(), second.tolist()))
    _LUT_CACHE[key] = lut
    return lut


def _slow_symbol(window: int, code_bits: int, symbol: int, ac: bool) -> tuple[int, int, int]:
    """A code whose code and value bits exceed the lookahead: read the value
    from the 32-bit window. Returns (bits consumed, run, value)."""
    if code_bits == 0:
        raise ValueError("jpeg: corrupt data (a bit pattern that is no Huffman code)")
    size = symbol & 15 if ac else symbol
    run = symbol >> 4 if ac else 0
    if size == 0:
        return code_bits, (64 if ac and run != 15 else run), 0
    raw = (window >> (32 - code_bits - size)) & ((1 << size) - 1)
    if raw < (1 << (size - 1)):
        raw -= (1 << size) - 1
    return code_bits + size, run, raw


# ------------------------------------------------------------------ entropy-coded data

def _unstuff(data: bytes, start: int) -> tuple[np.ndarray, list[int], int]:
    """The entropy-coded bytes from `start` up to the next marker that is not
    RSTn, with stuffed zeros, fill bytes and RST markers taken out. Returns
    (bytes, start of each restart interval in them, offset of that marker)."""
    buf = np.frombuffer(data, np.uint8, offset=start)
    ff = np.flatnonzero(buf[:-1] == 0xFF)
    nxt = buf[ff + 1]
    marker = (nxt != 0x00) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))
    stop = int(ff[marker][0]) if marker.any() else len(buf)
    ff, nxt = ff[ff < stop], nxt[ff < stop]
    keep = np.ones(stop, bool)
    keep[ff[nxt == 0x00] + 1] = False  # the stuffed zero after a data 0xFF
    keep[ff[nxt == 0xFF]] = False  # a fill byte
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    keep[rst] = keep[rst + 1] = False
    # each interval starts after an RST marker: its index in the kept bytes
    kept_before = np.cumsum(keep) - keep
    starts = [0] + kept_before[rst + 1].tolist()
    return buf[:stop][keep], starts, start + stop


def _windows(scan: np.ndarray) -> array.array:
    """The 32 bits that start at every bit position of `scan` (zeros past its
    end, as libjpeg inserts zeros when the data runs out)."""
    b = np.concatenate([scan, np.zeros(8, np.uint8)]).astype(np.uint64)
    n = len(scan) + 1
    v = (b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16) | (b[3:n + 3] << 8) | b[4:n + 4]
    w = (v[:, None] >> (8 - np.arange(8, dtype=np.uint64))[None, :]) & np.uint64(0xFFFFFFFF)
    return array.array("I", w.astype(np.uint32).tobytes())


def _decode_interval(win, pos: int, blocks, dc_luts, ac_luts, ncomp: int, coefs) -> None:
    """Decode one restart interval's blocks into `coefs` (zigzag order).
    blocks: (offset into coefs, component slot) for each block, in scan
    order; a block owns _STRIDE entries, its 64 coefficients and a scratch
    half that takes an EOB's store. The DC predictions start at 0."""
    pred = [0] * ncomp
    for base, c in blocks:
        dc, ac = dc_luts[c], ac_luts[c]
        w = win[pos]
        adv, code_bits, diff = dc[w >> 16]
        if not adv:
            adv, _, diff = _slow_symbol(w, code_bits, diff, False)
        pos += adv
        pred[c] += diff
        coefs[base] = pred[c]
        k = 1
        while k < 64:
            w = win[pos]
            adv, run, val = ac[w >> 16]
            if not adv:
                adv, run, val = _slow_symbol(w, run, val, True)
            pos += adv
            k += run
            # an EOB (run 64) stores its 0 in the block's scratch half
            coefs[base + k] = val
            k += 1


# ------------------------------------------------------------------ markers

_STRIDE = 128  # entries a block owns in the flat buffer: 64 coefficients, then scratch


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan, as libjpeg does
        self.offset = 0  # into the flat coefficient buffer
        self.rows = self.cols = 0  # block grid, padded to whole MCUs


def _segment(data: bytes, pos: int) -> tuple[bytes, int]:
    if pos + 2 > len(data):
        raise ValueError("jpeg: truncated marker segment")
    n = struct.unpack(">H", data[pos:pos + 2])[0]
    if n < 2 or pos + n > len(data):
        raise ValueError("jpeg: truncated marker segment")
    return data[pos + 2:pos + n], pos + n


def decode_coefficients(data: bytes) -> tuple[list[np.ndarray], list[np.ndarray], dict]:
    """Parse a baseline JPEG and decode its entropy-coded data.

    Returns (coefficients, quantization tables, frame): for each component
    the quantized coefficients int32 [block rows, block cols, 64] in zigzag
    order (padded to whole MCUs), its quantization table int64 [64] in
    natural order, and the frame's height, width and each component's
    (h, v) sampling factors."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("jpeg: no SOI marker")
    qtables: dict = {}
    htables: dict = {}
    comps: list[_Component] = []
    height = width = 0
    restart = 0
    coefs = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes before a marker
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"jpeg: expected a marker at byte {pos}")
        m = data[pos + 1]
        pos += 2
        if m == 0xD9:  # EOI
            break
        if m in _SOF_KINDS:
            raise ValueError(f"jpeg: {_SOF_KINDS[m]} is not supported (baseline sequential Huffman only)")
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        seg, pos = _segment(data, pos)
        if m == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                if i + 1 + n > len(seg):
                    raise ValueError("jpeg: truncated DQT")
                vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8).astype(np.int64)
                table = np.empty(64, np.int64)
                table[NATURAL_ORDER] = vals
                qtables[tq] = table
                i += 1 + n
        elif m == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = seg[i + 1:i + 17]
                n = sum(bits)
                vals = seg[i + 17:i + 17 + n]
                if len(bits) != 16 or len(vals) != n or tc > 1:
                    raise ValueError("jpeg: malformed DHT")
                htables[(tc, th)] = (bytes(bits), bytes(vals))
                i += 17 + n
        elif m in (0xC0, 0xC1):  # SOF0, SOF1: sequential Huffman
            precision, height, width, nc = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"jpeg: {precision}-bit samples are not supported (8-bit only)")
            if height == 0 or width == 0:
                raise ValueError("jpeg: a zero-sized frame (DNL height) is not supported")
            if nc not in (1, 3):
                raise ValueError(f"jpeg: {nc} components are not supported (1 or 3)")
            comps = [_Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nc)]
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = _ceil_div(width, 8 * hmax), _ceil_div(height, 8 * vmax)
            total = 0
            for c in comps:
                c.rows, c.cols, c.offset = mcuy * c.v, mcux * c.h, total
                total += c.rows * c.cols * _STRIDE
            coefs = array.array("i", bytes(4 * total))
        elif m == 0xDD:  # DRI
            restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xDA:  # SOS
            if coefs is None:
                raise ValueError("jpeg: SOS before SOF")
            pos = _decode_scan(data, seg, pos, comps, qtables, htables, restart, width, height, coefs)
        elif 0xE0 <= m <= 0xEF or m == 0xFE:  # APPn, COM
            pass
        else:
            raise ValueError(f"jpeg: marker 0xFF{m:02X} is not supported")
    if coefs is None:
        raise ValueError("jpeg: no frame")
    flat = np.frombuffer(coefs, np.int32)
    out = [flat[c.offset:c.offset + c.rows * c.cols * _STRIDE].reshape(c.rows, c.cols, _STRIDE)[..., :64]
           for c in comps]
    if any(c.quant is None for c in comps):
        raise ValueError("jpeg: a component without a scan")
    frame = {"height": height, "width": width, "sampling": [(c.h, c.v) for c in comps]}
    return out, [c.quant for c in comps], frame


def _decode_scan(data, seg, pos, comps, qtables, htables, restart, width, height, coefs) -> int:
    """Decode the scan that an SOS segment `seg` opens; returns the offset of
    the marker after its entropy-coded data."""
    ns = seg[0]
    by_id = {c.id: c for c in comps}
    members = []
    for i in range(ns):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"jpeg: scan names unknown component {cid}")
        members.append((by_id[cid], tables >> 4, tables & 15))
    ss, se, ahl = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    if (ss, se, ahl) != (0, 63, 0):
        raise ValueError(f"jpeg: spectral selection {ss}-{se}, approximation {ahl} (progressive) is not supported")
    dc_luts, ac_luts = [], []
    for c, td, ta in members:
        if c.quant is None:
            if c.tq not in qtables:
                raise ValueError(f"jpeg: quantization table {c.tq} is not defined")
            c.quant = qtables[c.tq]
        if (0, td) not in htables or (1, ta) not in htables:
            raise ValueError(f"jpeg: Huffman table DC {td} / AC {ta} is not defined")
        dc_luts.append(_lookahead("dc", *htables[(0, td)]))
        ac_luts.append(_lookahead("ac", *htables[(1, ta)]))
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    if ns == 1:  # non-interleaved: the component's own blocks in raster order
        c = members[0][0]
        bw = _ceil_div(_ceil_div(width * c.h, hmax), 8)
        bh = _ceil_div(_ceil_div(height * c.v, vmax), 8)
        r, q = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
        bases = (c.offset + (r * c.cols + q) * _STRIDE).reshape(-1, 1)
        slots = np.zeros_like(bases)
    else:  # interleaved: MCUs in raster order, each component's h×v blocks
        mcux, mcuy = _ceil_div(width, 8 * hmax), _ceil_div(height, 8 * vmax)
        my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
        my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
        b_list, s_list = [], []
        for slot, (c, _, _) in enumerate(members):
            dv, dh = np.divmod(np.arange(c.v * c.h), c.h)
            b_list.append(c.offset + ((my * c.v + dv) * c.cols + mx * c.h + dh) * _STRIDE)
            s_list.append(np.full_like(b_list[-1], slot))
        bases, slots = np.concatenate(b_list, axis=1), np.concatenate(s_list, axis=1)
    scan, starts, end = _unstuff(data, pos)
    n_mcu = bases.shape[0]
    per = restart or n_mcu
    n_int = -(-n_mcu // per)
    if len(starts) < n_int:
        raise ValueError(f"jpeg: {len(starts)} restart intervals in the scan, {n_int} expected")
    win = _windows(scan)
    try:
        for i in range(n_int):
            blocks = list(zip(bases[i * per:(i + 1) * per].reshape(-1).tolist(),
                              slots[i * per:(i + 1) * per].reshape(-1).tolist()))
            _decode_interval(win, 8 * starts[i], blocks, dc_luts, ac_luts, len(members), coefs)
    except IndexError:
        raise ValueError("jpeg: the scan's data ends before its last block") from None
    return end


# ------------------------------------------------------------------ pixels

# jidctint.c's constants, FIX(x) = round(x · 2^13)
_C = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
      "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
      "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}
_CONST_BITS, _PASS1_BITS = 13, 2


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_pass(s: list, shift: int) -> list:
    """One 1-D pass of jpeg_idct_islow on the 8 inputs s[0..7] (int64
    arrays), descaled by `shift`."""
    z1 = (s[2] + s[6]) * _C["0_541196100"]
    tmp2 = z1 - s[6] * _C["1_847759065"]
    tmp3 = z1 + s[2] * _C["0_765366865"]
    tmp0 = (s[0] + s[4]) << _CONST_BITS
    tmp1 = (s[0] - s[4]) << _CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _C["1_175875602"]
    t0, t1, t2, t3 = t0 * _C["0_298631336"], t1 * _C["2_053119869"], t2 * _C["3_072711026"], t3 * _C["1_501321110"]
    z1, z2 = z1 * -_C["0_899976223"], z2 * -_C["2_562915447"]
    z3, z4 = z3 * -_C["1_961570560"] + z5, z4 * -_C["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [_descale(v, shift) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                         tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


# jdmaster.c's post-IDCT range-limit table, indexed by x & 1023: x + 128
# clamped to 0..255 for x in -512..511 (values past that wrap, as in libjpeg)
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(0, 128)]).astype(np.uint8)


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Dequantize and inverse-DCT quantized coefficients [..., 64] (zigzag
    order) with jidctint.c's jpeg_idct_islow: uint8 samples [..., 8, 8]."""
    nat = np.empty(coef.shape, np.int64)
    nat[..., NATURAL_ORDER] = coef
    d = (nat * quant).reshape(*coef.shape[:-1], 8, 8)
    cols = _idct_pass([d[..., k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS)  # pass 1: down each column
    ws = np.stack(cols, axis=-2)
    rows = _idct_pass([ws[..., k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3)  # pass 2: along each row
    return _IDCT_LIMIT[np.stack(rows, axis=-1) & 1023]


def _plane(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """A component's samples from its block grid [rows, cols, 64]: uint8 [8·rows, 8·cols]."""
    r, c = coef.shape[:2]
    return idct_islow(coef, quant).transpose(0, 2, 1, 3).reshape(8 * r, 8 * c)


def upsample_h2v2(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """2×2 upsampling of a chroma plane whose real samples are
    plane[:h, :w], as libjpeg-turbo's jinit_upsampler picks it: uint8
    [2h, 2w]. Planes more than 2 samples wide take h2v2_fancy_upsample of
    jdsample.c (the row above the first and below the last is that row
    again, jdmainct.c's context rows; the first and last output columns
    take its special cases); narrower ones its h2v2_upsample, each sample
    repeated."""
    if w <= 2:
        return np.repeat(np.repeat(plane[:h, :w], 2, axis=0), 2, axis=1)
    p = plane.astype(np.int64)
    rows = p[:h]
    above = np.concatenate([rows[:1], rows[:-1]])
    below = np.concatenate([rows[1:], rows[-1:]])
    s = np.empty((2 * h, p.shape[1]), np.int64)
    s[0::2], s[1::2] = 3 * rows + above, 3 * rows + below
    this, prev = s[:, :w], np.concatenate([s[:, :1], s[:, :w - 1]], axis=1)
    nxt = np.concatenate([s[:, 1:w], s[:, w - 1:w]], axis=1)
    out = np.empty((2 * h, 2 * w), np.int64)
    out[:, 0::2] = (3 * this + prev + 8) >> 4
    out[:, 1::2] = (3 * this + nxt + 7) >> 4
    out[:, 0] = (4 * this[:, 0] + 8) >> 4
    out[:, -1] = (4 * this[:, -1] + 7) >> 4
    return out.astype(np.uint8)


# jdcolor.c's build_ycc_rgb_table: SCALEBITS 16
def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix16(1.40200) * _X + 32768) >> 16
_CB_B = (_fix16(1.77200) * _X + 32768) >> 16
_CR_G = -_fix16(0.71414) * _X
_CB_G = -_fix16(0.34414) * _X + 32768


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8 planes: uint8 [H, W, 3]."""
    yy = y.astype(np.int64)
    r = yy + _CR_R[cr]
    g = yy + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = yy + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A baseline JPEG file → uint8 [H, W, 3] RGB (3 components) or [H, W]
    (one), pixel for pixel what libjpeg's default decode (islow IDCT, fancy
    upsampling) gives."""
    coefs, quants, frame = decode_coefficients(bytes(data))
    h, w = frame["height"], frame["width"]
    planes = [_plane(c, q) for c, q in zip(coefs, quants)]
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0][:h, :w])
    hmax = max(s[0] for s in frame["sampling"])
    vmax = max(s[1] for s in frame["sampling"])
    full = []
    for plane, (sh, sv) in zip(planes, frame["sampling"]):
        fx, fy = hmax // sh if hmax % sh == 0 else 0, vmax // sv if vmax % sv == 0 else 0
        if (fx, fy) == (1, 1):
            full.append(plane[:h, :w])
        elif (fx, fy) == (2, 2):
            full.append(upsample_h2v2(plane, _ceil_div(h, 2), _ceil_div(w, 2))[:h, :w])
        else:
            raise ValueError(f"jpeg: sampling factors {frame['sampling']} are not supported (4:2:0 or 4:4:4 only)")
    return ycc_to_rgb(*full)


def decode_rgb(data: bytes) -> np.ndarray:
    """decode() as uint8 RGB [H, W, 3] whatever the components: a grayscale
    file's samples repeated, as PIL's convert("RGB") gives them."""
    img = decode(data)
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
