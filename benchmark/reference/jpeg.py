"""Plain baseline JPEG decoding (ITU-T T.81, sequential Huffman, 8-bit)
into YCbCr planes, the MJPEG frames of an MP4, and the frame schedule of a
keyframe movie; numpy only.

The decoder reads the quantization and Huffman tables from each file,
takes any sampling factors, and gives each component's plane at its own
resolution (no upsampling, no colour conversion), so planes compare
directly with I420 planes. The inverse DCT is the orthonormal float
transform, within one level of libjpeg's integer one. Restart intervals
and progressive or arithmetic coding are refused.
"""
from __future__ import annotations

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63])

_C = np.array([[(0.5 ** 0.5 if k == 0 else 1.0) * 0.5 * np.cos((2 * n + 1) * k * np.pi / 16) for n in range(8)]
               for k in range(8)])


def _huff_table(counts, symbols) -> list:
    """A 65536-entry lookup on the next 16 bits: (code length, symbol)."""
    table = [(0, 0)] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            table[lo:hi] = [(length, symbols[k])] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return table


def _windows(data: bytes) -> list:
    """The 16-bit window starting at every bit of the entropy-coded data
    (byte stuffing removed), padded with ones."""
    bits = np.unpackbits(np.frombuffer(data + b"\xff\xff\xff", np.uint8)).astype(np.uint32)
    n = len(bits) - 16
    w = np.zeros(n, np.uint32)
    for i in range(16):
        w = (w << 1) | bits[i:i + n]
    return w.tolist()


def decode_planes(jpg: bytes) -> list[np.ndarray]:
    """Each component's samples [rows, cols] as float64 (0..255), in frame
    component order."""
    coefs, qts, factors, (height, width) = decode_coefficients(jpg)
    hmax, vmax = max(h for h, _ in factors), max(v for _, v in factors)
    planes = []
    for coef, q, (h, v) in zip(coefs, qts, factors):
        nat = np.zeros(coef.shape)
        nat[..., ZIGZAG] = coef * q
        blocks = nat.reshape(coef.shape[:2] + (8, 8))
        pix = np.einsum("ku,yxkl,lv->yxuv", _C, blocks, _C) + 128.0
        plane = pix.transpose(0, 2, 1, 3).reshape(blocks.shape[0] * 8, blocks.shape[1] * 8)
        ph, pw = -(-height * v // vmax), -(-width * h // hmax)
        planes.append(np.clip(np.round(plane[:ph, :pw]), 0, 255))
    return planes


def decode_coefficients(jpg: bytes):
    """Per component, in frame order: the quantized coefficients [block
    rows, block cols, 64] in zigzag order, the quantization tables (zigzag
    order) and the sampling factors (h, v); and (height, width)."""
    if jpg[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI)")
    qt, ht, comps, pos = {}, {}, None, 2
    while True:
        while jpg[pos] == 0xFF and jpg[pos + 1] == 0xFF:
            pos += 1
        marker, length = jpg[pos + 1], int.from_bytes(jpg[pos + 2:pos + 4], "big")
        seg = jpg[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                q = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8).astype(np.float64)
                qt[tq] = q
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                syms = list(seg[i + 17:i + 17 + sum(counts)])
                ht[(tc, th)] = _huff_table(counts, syms)
                i += 17 + sum(counts)
        elif marker == 0xC0 or marker == 0xC1:
            if seg[0] != 8:
                raise ValueError("only 8-bit samples")
            height, width = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big")
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                     for c in range(seg[5])]
        elif marker in (0xC2, 0xC3, 0xC9, 0xCA, 0xCB, 0xDD):
            raise ValueError(f"unsupported JPEG marker 0x{marker:02x} (baseline only, no restarts)")
        elif marker == 0xDA:
            sel = {seg[1 + 2 * c]: (seg[2 + 2 * c] >> 4, seg[2 + 2 * c] & 15) for c in range(seg[0])}
            end = jpg.index(b"\xff\xd9", pos)
            data = jpg[pos:end].replace(b"\xff\x00", b"\xff")
            return (_scan(data, width, height, comps, sel, ht), [qt[c[3]] for c in comps],
                    [(c[1], c[2]) for c in comps], (height, width))


def _scan(data, width, height, comps, sel, ht):
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    coef = [np.zeros((mcuy * c[2], mcux * c[1], 64)) for c in comps]
    win = _windows(data)
    pos = 0
    pred = [0] * len(comps)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (cid, h, v, tq) in enumerate(comps):
                dc_t, ac_t = ht[(0, sel[cid][0])], ht[(1, sel[cid][1])]
                for by in range(v):
                    for bx in range(h):
                        blk = coef[ci][my * v + by, mx * h + bx]
                        length, s = dc_t[win[pos]]
                        pos += length
                        diff = 0
                        if s:
                            diff = win[pos] >> (16 - s)
                            if diff < (1 << (s - 1)):
                                diff -= (1 << s) - 1
                            pos += s
                        pred[ci] += diff
                        blk[0] = pred[ci]
                        k = 1
                        while k < 64:
                            length, rs = ac_t[win[pos]]
                            pos += length
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break
                                k += 16
                                continue
                            k += r
                            val = win[pos] >> (16 - s)
                            if val < (1 << (s - 1)):
                                val -= (1 << s) - 1
                            pos += s
                            blk[k] = val
                            k += 1
    return coef


def quantize_plane(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """A plane's quantized coefficients [block rows, block cols, 64] in
    zigzag order: level shift, the orthonormal 8x8 DCT, division by the
    quantizer (zigzag order), rounded half away from zero (libjpeg's
    quantization, its DCT in float)."""
    h, w = plane.shape
    blocks = (plane.astype(np.float64) - 128.0).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    f = np.einsum("uk,yxkl,vl->yxuv", _C, blocks, _C).reshape(h // 8, w // 8, 64)[..., ZIGZAG] / qtable
    return np.trunc(f + np.where(f >= 0, 0.5, -0.5))


def mjpeg_frames(mp4: bytes) -> list[bytes]:
    """The JPEG samples of an MJPEG MP4, in file order (each SOI to its EOI)."""
    out, pos = [], 0
    while True:
        i = mp4.find(b"\xff\xd8\xff", pos)
        if i < 0:
            return out
        j = mp4.index(b"\xff\xd9", i)
        out.append(mp4[i:j + 2])
        pos = j + 2


def frame_schedule(keyframes: int, frames: int) -> list[int]:
    """Frames inserted into each gap between keyframes so that the movie has
    `frames` frames: the missing frames shared evenly, the remainder one
    each to gaps at an even stride from the first to the last."""
    gaps, missing = keyframes - 1, frames - keyframes
    if gaps <= 0 or missing < 1:
        return [0] * max(gaps, 0)
    base, rem = divmod(missing, gaps)
    counts = [base] * gaps
    if rem:
        pos = sorted(set(np.linspace(0, gaps - 1, rem).round().astype(int).tolist()))
        pos += [g for g in range(gaps) if g not in pos][:rem - len(pos)]
        for g in pos:
            counts[g] += 1
    return counts
