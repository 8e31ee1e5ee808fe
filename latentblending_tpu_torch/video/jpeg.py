"""Baseline JPEG encoding on the device: the movie writer's encoder.

The JAX package encodes its movie samples on the host, through libjpeg
(cv2.imencode, and native/jpeg_coef_lerp.cpp for I420 keyframes and the
coefficient lerp). The card's machine has neither, so the port encodes on
the card with three hand-written kernels (csrc/jpeg.cu):

- J1 `fdct_quant`: libjpeg's forward_DCT (the integer "islow" transform of
  jfdctint.c) and quantize, per 8×8 block, from packed I420 planes
  [B, H·3/2, W] or from RGB [B, H, W, 3] (then libjpeg's fixed-point
  rgb_ycc_convert and h2v2_downsample first), B frames a call. Output:
  int16 coefficients [B, nblocks, 64] in zigzag order and in the scan's MCU
  order (Y00 Y01 Y10 Y11 Cb Cr per 16×16 MCU), dummy blocks included. The
  kernel works in 32-bit integers and divides by a multiply-high with a
  per-position reciprocal (`_fdct_table`).
- J2 `coef_lerp_batch`: round((1-t)·a + t·b) of two keyframes'
  coefficients for F fractions in one call (the DCT is linear, so this is
  each in-between frame's JPEG): the rule of native/jpeg_coef_lerp.cpp:
  142-157 as its Makefile builds it, one f32 FMA, fmaf(1-t, a, t·b),
  rounded half away from zero.
- J3 `huffman_scan_batch`: the baseline entropy coder with the standard
  tables (Annex K.3, libjpeg's std_huff_tables) over F frames in one call,
  byte stuffing included: one warp per 8×8 block counts its bits, a scan in
  the kernels places every block in its frame (each frame restarts its DC
  prediction, pads its last byte and is stuffed alone), the host reads the
  frames' sizes once, the warps write their bits, the 0xFF bytes are
  counted and scanned by tiles, the bytes scattered, and the card copies
  the packed scans into pinned host memory.

`coef_lerp` and `huffman_scan` are their F = 1 case; `encode_i420`,
`encode_rgb` and `CoefFrames.lerp_many` code all their frames in one J3
call.

The headers (`jfif_header`) are libjpeg's for the same parameters: APP0
JFIF 1.01, two DQT, SOF0 4:2:0, four DHT, SOS. So a frame encoded here is
byte-equal to libjpeg's from the same samples (tests/test_torch_jpeg.py).

Each kernel's plain version sits beside its wrapper: torch (int64 for J1,
f32 for J2) and a Python bit writer for J3. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from latentblending_tpu_torch import profiling
from latentblending_tpu_torch.ops import _build

# The wrappers count in the profiling registry one launch per call that
# launches its kernels (a J1 call codes B frames; a J2 call lerps F
# fractions; a J3 call codes F frames in eight launches and one copy): J1,
# J2, J3; J1_rgb counts J1's calls on RGB frames apart (they are in J1
# too), J1_frames and J3_frames the frames J1's and J3's calls coded.

# jpeg_natural_order: natural (row-major) index of the k-th zigzag coefficient
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# zigzag position of each natural index
ZIGZAG_POS = np.argsort(NATURAL_ORDER)

# Annex K.1 quantization tables, natural order (libjpeg std_luminance_quant_tbl
# and std_chrominance_quant_tbl)
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, np.int64)

# Annex K.3 Huffman tables: (bits[1..16], values), libjpeg's std_huff_tables
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])
# the scan's tables in the order the DHT markers carry them: DC 0, AC 0, DC 1, AC 1
_HUFF_SPECS = ((0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA), (0x11, _AC_CHROMA))


def _derived_table(bits: list[int], vals: list[int]) -> np.ndarray:
    """(code, size) of every symbol, as libjpeg's jpeg_make_c_derived_tbl
    assigns canonical codes: int64 [256, 2], size 0 for an absent symbol."""
    out = np.zeros((256, 2), np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


# [4, 256, 2] int64: (code, size) of DC luma, AC luma, DC chroma, AC chroma
HUFF_TABLES = np.stack([_derived_table(*spec) for _, spec in _HUFF_SPECS])


def quality_scaling(quality: int) -> int:
    """libjpeg's jpeg_quality_scaling: quality 1..100 → percentage scale."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - quality * 2


def quant_tables(quality: int) -> np.ndarray:
    """The luma and chroma tables jpeg_set_quality(quality, force_baseline=
    TRUE) installs: int64 [2, 64], natural order, values in 1..255."""
    scale = quality_scaling(quality)
    return np.stack([np.clip((base * scale + 50) // 100, 1, 255) for base in (_LUMA_Q, _CHROMA_Q)])


def quant_reciprocal(divisor: np.ndarray) -> np.ndarray:
    """ceil(2^32 / d) as uint32, for divisors 2 <= d < 2^16: the high 32
    bits of n · ceil(2^32 / d) are n // d for every n < 2^16 (the error
    n · (ceil(2^32/d) - 2^32/d) / 2^32 stays below 2^-16 < 1/d), which J1's
    numerators |x| + 4q (|x| <= 8192, 4q <= 1020) are."""
    return (-(-(1 << 32) // np.asarray(divisor, np.int64))).astype(np.uint32)


def _fdct_table(quality: int) -> np.ndarray:
    """J1's quantizer for `quality`: uint32 [2, 64, 2] (luma, chroma; natural
    order): ceil(2^32 / 8q), and 4q with the position's zigzag index in the
    high 16 bits. The kernel computes (|x| + 4q) / 8q as the high word of
    (|x| + 4q) · ceil(2^32 / 8q)."""
    q8 = quant_tables(quality) * 8
    out = np.empty((2, 64, 2), np.uint32)
    out[..., 0] = quant_reciprocal(q8)
    out[..., 1] = (q8 // 2) | (ZIGZAG_POS << 16)
    return out


def mcu_grid(height: int, width: int) -> tuple[int, int]:
    """MCU rows and columns of a 4:2:0 frame (16×16 pixels an MCU)."""
    return -(-height // 16), -(-width // 16)


def num_blocks(height: int, width: int) -> int:
    my, mx = mcu_grid(height, width)
    return my * mx * 6


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def jfif_header(height: int, width: int, quality: int) -> bytes:
    """Every marker libjpeg writes before the scan data for a baseline
    4:2:0 YCbCr frame at `quality` with the standard Huffman tables."""
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"jfif_header: unsupported size {height}x{width}")
    q = quant_tables(quality)
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tid in range(2):
        out.append(_segment(0xDB, bytes([tid]) + bytes(q[tid][NATURAL_ORDER].tolist())))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, (bits, vals) in _HUFF_SPECS:
        out.append(_segment(0xC4, bytes([cls_id]) + bytes(bits) + bytes(vals)))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out)


EOI = b"\xff\xd9"


# ------------------------------------------------------------------ plain versions

# libjpeg's jccolor.c constants: FIX(x) = round(x · 2^16)
def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


_CBCR_OFFSET = 128 << 16


def _rgb_to_ycc(rgb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """libjpeg's rgb_ycc_convert on int64 [..., 3] → Y, Cb, Cr int64 [...]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + 32768) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + _CBCR_OFFSET + 32767) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + _CBCR_OFFSET + 32767) >> 16
    return y, cb, cr


def _clamped(n: int, limit: int, device) -> torch.Tensor:
    return torch.arange(n, device=device).clamp_(max=limit - 1)


def _planes(frames: torch.Tensor, fmt: str, height: int, width: int) -> list[torch.Tensor]:
    """The three component planes as libjpeg's DCT sees them, int64: Y
    [B, 16·my, 16·mx] and Cb, Cr [B, 8·my, 8·mx], edges expanded as its
    prep and downsample controllers expand them (the last row or column
    again; a chroma row past the downsampled height is the last one again)."""
    my, mx = mcu_grid(height, width)
    dev = frames.device
    ys, xs = _clamped(16 * my, height, dev), _clamped(16 * mx, width, dev)
    if fmt == "i420":
        f = frames.reshape(frames.shape[0], -1).long()
        hw, ch, cw = height * width, height // 2, width // 2
        y = f[:, :hw].reshape(-1, height, width)
        cys, cxs = _clamped(8 * my, ch, dev), _clamped(8 * mx, cw, dev)
        chroma = [f[:, hw + i * ch * cw: hw + (i + 1) * ch * cw].reshape(-1, ch, cw)[:, cys][:, :, cxs]
                  for i in range(2)]
        return [y[:, ys][:, :, xs]] + chroma
    y, cb, cr = _rgb_to_ycc(frames.long())
    cy = torch.arange(8 * my, device=dev).clamp_(max=(height + 1) // 2 - 1)
    r0, r1 = 2 * cy, (2 * cy + 1).clamp_(max=height - 1)
    cx = torch.arange(8 * mx, device=dev)
    c0, c1 = (2 * cx).clamp_(max=width - 1), (2 * cx + 1).clamp_(max=width - 1)
    bias = 1 + (cx & 1)  # h2v2_downsample's 1, 2, 1, 2, ... rounding bias

    def down(p):
        return (p[:, r0][:, :, c0] + p[:, r0][:, :, c1] + p[:, r1][:, :, c0] + p[:, r1][:, :, c1] + bias) >> 2

    return [y[:, ys][:, :, xs], down(cb), down(cr)]


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d: torch.Tensor, first: bool) -> torch.Tensor:
    """One pass of jfdctint.c's jpeg_fdct_islow over the last axis (int64)."""
    c_bits, p_bits = 13, 2
    s = [d[..., i] for i in range(8)]
    tmp0, tmp7 = s[0] + s[7], s[0] - s[7]
    tmp1, tmp6 = s[1] + s[6], s[1] - s[6]
    tmp2, tmp5 = s[2] + s[5], s[2] - s[5]
    tmp3, tmp4 = s[3] + s[4], s[3] - s[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    odd_shift = c_bits - p_bits if first else c_bits + p_bits
    out = [None] * 8
    if first:
        out[0], out[4] = (tmp10 + tmp11) << p_bits, (tmp10 - tmp11) << p_bits
    else:
        out[0], out[4] = _descale(tmp10 + tmp11, p_bits), _descale(tmp10 - tmp11, p_bits)
    z1 = (tmp12 + tmp13) * 4433
    out[2] = _descale(z1 + tmp13 * 6270, odd_shift)
    out[6] = _descale(z1 + tmp12 * -15137, odd_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    out[7] = _descale(tmp4 + z1 + z3, odd_shift)
    out[5] = _descale(tmp5 + z2 + z4, odd_shift)
    out[3] = _descale(tmp6 + z2 + z3, odd_shift)
    out[1] = _descale(tmp7 + z1 + z4, odd_shift)
    return torch.stack(out, dim=-1)


def _check_frames(name: str, frames: torch.Tensor, fmt: str) -> tuple[int, int]:
    """(height, width) of a uint8 batch in `fmt`; raises on anything else."""
    if frames.dtype != torch.uint8:
        raise TypeError(f"{name}: frames must be uint8, got {frames.dtype}")
    if fmt == "i420":
        if frames.ndim != 3 or frames.shape[1] % 3:
            raise ValueError(f"{name}: I420 frames must be [B, H*3/2, W], got {tuple(frames.shape)}")
        h, w = frames.shape[1] * 2 // 3, frames.shape[2]
        if h % 4 or w % 2:
            raise ValueError(f"{name}: packed I420 needs H % 4 == 0 and even W, got {h}x{w}")
        return h, w
    if fmt == "rgb":
        if frames.ndim != 4 or frames.shape[3] != 3:
            raise ValueError(f"{name}: RGB frames must be [B, H, W, 3], got {tuple(frames.shape)}")
        return frames.shape[1], frames.shape[2]
    raise ValueError(f"{name}: fmt must be 'i420' or 'rgb', got {fmt!r}")


def fdct_quant_reference(frames: torch.Tensor, quality: int, fmt: str = "i420") -> torch.Tensor:
    """Plain J1: uint8 frames (packed I420 [B, H·3/2, W] or RGB [B, H, W, 3])
    → int16 [B, nblocks, 64] quantized coefficients, zigzag order, MCU order,
    libjpeg's arithmetic in int64."""
    h, w = _check_frames("fdct_quant", frames, fmt)
    my, mx = mcu_grid(h, w)
    B = frames.shape[0]
    y, cb, cr = _planes(frames, fmt, h, w)
    # [B, my, 2, 8, mx, 2, 8] → [B, my, mx, 2 (by), 2 (bx), 8, 8]
    yb = y.reshape(B, my, 2, 8, mx, 2, 8).permute(0, 1, 4, 2, 5, 3, 6).reshape(B, my, mx, 4, 8, 8)
    cbb, crb = (c.reshape(B, my, 8, mx, 8).permute(0, 1, 3, 2, 4).reshape(B, my, mx, 1, 8, 8) for c in (cb, cr))
    blocks = torch.cat([yb, cbb, crb], dim=3) - 128
    coef = _fdct_pass(blocks, True)
    coef = _fdct_pass(coef.transpose(-1, -2), False).transpose(-1, -2).reshape(B, my, mx, 6, 64)
    q = torch.from_numpy(quant_tables(quality)).to(frames.device)
    div = (q[[0, 0, 0, 0, 1, 1]] * 8).reshape(1, 1, 1, 6, 64)
    mag = (coef.abs() + div // 2) // div
    coef = torch.where(coef < 0, -mag, mag)
    # dummy Y blocks past the image's blocks: AC 0, DC of the block before (jccoefct.c)
    hb, wb = -(-h // 8), -(-w // 8)
    by = 2 * torch.arange(my, device=frames.device).reshape(my, 1, 1) + torch.tensor([0, 0, 1, 1], device=frames.device)
    bx = 2 * torch.arange(mx, device=frames.device).reshape(1, mx, 1) + torch.tensor([0, 1, 0, 1], device=frames.device)
    dummy = (by >= hb) | (bx >= wb)  # [my, mx, 4]
    for p in range(1, 4):
        d = dummy[..., p].reshape(1, my, mx, 1)
        fill = torch.zeros_like(coef[..., p, :])
        fill[..., 0] = coef[..., p - 1, 0]
        coef[..., p, :] = torch.where(d, fill, coef[..., p, :])
    zz = torch.from_numpy(NATURAL_ORDER).to(frames.device)
    return coef[..., zz].reshape(B, my * mx * 6, 64).to(torch.int16)


def _fma_f32(x: torch.Tensor, a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """fmaf(x, a, y) for an f32 scalar x, int a and f32 y: x·a + y rounded
    once to f32. x·a is exact in f64; the f64 sum s and its error e (TwoSum)
    hold x·a + y exactly, and a rounding tie of s is broken toward e."""
    p = x.double() * a.double()
    yd = y.double()
    s = p + yd
    bb = s - p
    e = (p - (s - bb)) + (yd - bb)
    r = s.float()
    rd = r.double()
    n = torch.nextafter(r, torch.where(s > rd, torch.inf, -torch.inf).float())
    tie = (s != rd) & ((s - rd).abs() * 2 == (n.double() - rd).abs())
    return torch.where(tie & (e != 0) & ((e > 0) == (s > rd)), n, r)


def coef_lerp_reference(a: torch.Tensor, b: torch.Tensor, t: float) -> torch.Tensor:
    """Plain J2: round half away from zero of fmaf(1-t, a, t·b) in f32 (1-t
    and t·b rounded to f32): native/jpeg_coef_lerp.cpp:142-157 as its
    Makefile builds it (g++ -O3 -march=native contracts `wi*a + w*b` into
    one FMA on hosts that have FMA)."""
    tf = torch.tensor(t, dtype=torch.float32, device=a.device)
    v = _fma_f32(1.0 - tf, a, tf * b.float())
    return torch.where(v >= 0, v + 0.5, v - 0.5).trunc().to(torch.int16)


def _bit_length(v: int) -> int:
    return int(v).bit_length()


def huffman_scan_reference(coef: torch.Tensor) -> bytes:
    """Plain J3: one frame's coefficients [nblocks, 64] (zigzag, MCU order)
    → the entropy-coded scan with 0xFF bytes stuffed, as libjpeg's
    encode_one_block and flush_bits write it (last byte padded with 1s)."""
    c = coef.detach().cpu().numpy().astype(np.int64).reshape(-1, 6, 64)
    tables = HUFF_TABLES.tolist()
    out = bytearray()
    acc, nacc = 0, 0

    def put(code: int, size: int):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    last_dc = [0, 0, 0]
    for mcu in c:
        for blk in range(6):
            comp = 0 if blk < 4 else blk - 3
            dc_t, ac_t = tables[0], tables[1]
            if comp:
                dc_t, ac_t = tables[2], tables[3]
            block = mcu[blk]
            diff = int(block[0]) - last_dc[comp]
            last_dc[comp] = int(block[0])
            nb = _bit_length(abs(diff))
            put(*dc_t[nb])
            if nb:
                put((diff if diff >= 0 else diff - 1) & ((1 << nb) - 1), nb)
            run, prev = 0, 0
            for k in np.flatnonzero(block[1:]) + 1:
                run = int(k) - prev - 1
                while run > 15:
                    put(*ac_t[0xF0])
                    run -= 16
                v = int(block[k])
                nb = _bit_length(abs(v))
                put(*ac_t[(run << 4) + nb])
                put((v if v >= 0 else v - 1) & ((1 << nb) - 1), nb)
                prev = int(k)
            if prev < 63:
                put(*ac_t[0x00])
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)
    return bytes(out).replace(b"\xff", b"\xff\x00")


# ------------------------------------------------------------------ kernels

_FMT = {"i420": 0, "rgb": 1}
_DEVICE_TABLES: dict = {}  # (kind, quality or None, device) → device tensor


def _device_table(kind: str, device, quality: int | None = None) -> torch.Tensor:
    key = (kind, quality, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        if kind == "fdct":
            t = torch.from_numpy(_fdct_table(quality).view(np.int32)).to(device)
        else:  # (size << 16) | code of the four tables, int32 [4, 256]
            t = torch.from_numpy((HUFF_TABLES[..., 1] << 16 | HUFF_TABLES[..., 0]).astype(np.int32)).to(device)
        _DEVICE_TABLES[key] = t
    return t


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def fdct_quant(frames: torch.Tensor, quality: int, fmt: str = "i420") -> torch.Tensor:
    """J1: uint8 frames, packed I420 [B, H·3/2, W] or RGB [B, H, W, 3] →
    int16 [B, nblocks, 64] quantized coefficients (zigzag, MCU order), the
    B frames in one launch."""
    if not frames.is_cuda:
        return fdct_quant_reference(frames, quality, fmt)
    h, w = _check_frames("fdct_quant", frames, fmt)
    _check_cuda("fdct_quant", frames)
    B = frames.shape[0]
    out = torch.empty((B, num_blocks(h, w), 64), dtype=torch.int16, device=frames.device)
    if B == 0:
        return out
    _build.launch("lb_jpeg_fdct_quant", frames, _device_table("fdct", frames.device, quality), out,
                  B, h, w, _FMT[fmt])
    profiling.count("J1")
    profiling.count("J1_rgb", fmt == "rgb")
    profiling.count("J1_frames", B)
    return out


def coef_lerp_batch(a: torch.Tensor, b: torch.Tensor, ts) -> torch.Tensor:
    """J2: round((1-t)·a + t·b) of two int16 coefficient tensors of one shape
    for each fraction t of `ts`, stacked: [F, *a.shape], one call."""
    if a.dtype != torch.int16 or b.dtype != torch.int16 or a.shape != b.shape:
        raise ValueError(f"coef_lerp: a {a.dtype} {tuple(a.shape)} vs b {b.dtype} {tuple(b.shape)}")
    ts = np.asarray([float(t) for t in ts], np.float32)
    if not a.is_cuda:
        return coef_lerp_batch_reference(a, b, ts)
    _check_cuda("coef_lerp", a, b)
    if a.numel() % 8 or (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("coef_lerp: the kernel reads 16-byte vectors: a and b need a multiple of 8 "
                         "coefficients and 16-byte aligned storage (any [n, 64] coefficient tensor has both)")
    out = torch.empty((len(ts), *a.shape), dtype=torch.int16, device=a.device)
    if out.numel():
        _build.launch("lb_jpeg_coef_lerp", a, b, out, a.numel(), ts.ctypes.data, len(ts))
        profiling.count("J2")
    return out


def coef_lerp_batch_reference(a: torch.Tensor, b: torch.Tensor, ts) -> torch.Tensor:
    """Plain batched J2: coef_lerp_reference for each fraction, stacked."""
    return torch.stack([coef_lerp_reference(a, b, float(t)) for t in ts]) if len(ts) else \
        torch.empty((0, *a.shape), dtype=torch.int16, device=a.device)


def coef_lerp(a: torch.Tensor, b: torch.Tensor, t: float) -> torch.Tensor:
    """J2 at one fraction: coef_lerp_batch's F = 1 case."""
    return coef_lerp_batch(a, b, [t])[0]


_TILE_BYTES = 4096  # a frame's scan bytes one CTA of J3's stuffing passes takes (csrc/jpeg.cu kTileBytes)


def _check_coef_batch(name: str, coef: torch.Tensor) -> None:
    if coef.dtype != torch.int16 or coef.ndim != 3 or coef.shape[2] != 64 or coef.shape[1] % 6:
        raise ValueError(f"{name}: coef must be int16 [F, 6·n, 64], got {coef.dtype} {tuple(coef.shape)}")


def _huffman_count(coef: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """J3's first half: every block's bits, their frame-local scan and the
    plan (the frames' byte, word and tile offsets, int64 [3, F+1], on the
    card). Returns the tables, the blocks' bit offsets and the plan."""
    dev, (F, n, _) = coef.device, coef.shape
    tables = _device_table("huff", dev)
    bits = torch.empty(F * n, dtype=torch.int32, device=dev)
    off = torch.empty(F * n, dtype=torch.int64, device=dev)
    frame_bits = torch.empty(F, dtype=torch.int64, device=dev)
    plan_dev = torch.empty((3, F + 1), dtype=torch.int64, device=dev)
    _build.launch("lb_jpeg_huff_count", coef, tables, bits, off, frame_bits, plan_dev, n, F)
    return tables, off, plan_dev


def _huffman_code(coef: torch.Tensor, tables: torch.Tensor, off: torch.Tensor, plan_dev: torch.Tensor,
                  plan: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """J3's second half: the bits written, the 0xFF bytes counted and the
    bytes scattered with their stuffing, in buffers sized by `plan`, the
    host's copy of `plan_dev`. The kernels place every block by `plan_dev`,
    so `plan` must be that of the same coefficients: a smaller one makes
    them write past the buffers' ends."""
    dev, (F, n, _) = coef.device, coef.shape
    nbytes, nwords, tiles = (int(x) for x in plan[:, F])
    words = torch.empty(nwords, dtype=torch.int32, device=dev)
    tile_ff = torch.empty(tiles, dtype=torch.int32, device=dev)
    tile_pre = torch.empty(tiles, dtype=torch.int64, device=dev)
    stuffed = torch.empty(F + 1, dtype=torch.int64, device=dev)
    out = torch.empty(2 * nbytes + 16, dtype=torch.uint8, device=dev)  # every byte a 0xFF at most
    _build.launch("lb_jpeg_huff_code", coef, tables, off, plan_dev, words, nwords, tile_ff, tile_pre, stuffed, out,
                  n, F, tiles)
    profiling.count("J3")
    profiling.count("J3_frames", F)
    return out, stuffed


def huffman_scan_device(coef: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """J3's work on the card for F frames' coefficients [F, nblocks, 64]
    (int16, zigzag, MCU order, F·nblocks > 0): the F stuffed scans packed
    back to back in one uint8 buffer, their int64 offsets [F+1] into it,
    and the plan on the host. The host reads the plan between the two
    halves (one sync). CUDA tensors only."""
    _check_coef_batch("huffman_scan_device", coef)
    _check_cuda("huffman_scan_device", coef)
    counted = _huffman_count(coef)
    with profiling.wait("jpeg"):
        plan = counted[2].cpu()
    return (*_huffman_code(coef, *counted, plan), plan)


def _huffman_scan_replay(coef: torch.Tensor, plan: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """huffman_scan_device with the plan that an earlier call on these same
    coefficients returned: no host sync, so a CUDA graph can capture it
    (chip_smoke.py times J3's device time so)."""
    _check_coef_batch("_huffman_scan_replay", coef)
    _check_cuda("_huffman_scan_replay", coef)
    if plan.device.type != "cpu" or plan.dtype != torch.int64 or tuple(plan.shape) != (3, coef.shape[0] + 1):
        raise ValueError(f"_huffman_scan_replay: plan must be int64 [3, {coef.shape[0] + 1}] on the host, "
                         f"got {plan.dtype} {tuple(plan.shape)} on {plan.device}")
    return _huffman_code(coef, *_huffman_count(coef), plan)


def huffman_scan_batch(coef: torch.Tensor) -> list[bytes]:
    """J3: F frames' int16 coefficients [F, nblocks, 64] (nblocks a multiple
    of 6, zigzag, MCU order) → each frame's stuffed entropy-coded scan, in
    one call: huffman_scan_device, then the card copies the packed scans,
    exactly their length, into pinned host memory (two host syncs a call:
    the plan's read and the end of the copy)."""
    _check_coef_batch("huffman_scan_batch", coef)
    if not coef.is_cuda:
        return [huffman_scan_reference(c) for c in coef]
    F, n = coef.shape[:2]
    if F * n == 0:
        return [b""] * F
    out, stuffed, _ = huffman_scan_device(coef.contiguous())
    host = torch.empty(out.numel(), dtype=torch.uint8, pin_memory=True)
    host_off = torch.empty(F + 1, dtype=torch.int64, pin_memory=True)
    _build.launch("lb_jpeg_huff_copy", out, stuffed, F, out.numel(), host.data_ptr(), host_off.data_ptr())
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(coef.device))
    with profiling.wait("jpeg"):
        done.synchronize()
    data, offs = host.numpy(), host_off.tolist()
    return [data[offs[f]:offs[f + 1]].tobytes() for f in range(F)]


def huffman_scan(coef: torch.Tensor) -> bytes:
    """J3 on one frame's coefficients [nblocks, 64]: huffman_scan_batch's F = 1 case."""
    if coef.ndim != 2:
        raise ValueError(f"huffman_scan: coef must be int16 [6·n, 64], got {coef.dtype} {tuple(coef.shape)}")
    return huffman_scan_batch(coef[None])[0]


# ------------------------------------------------------------------ frames

def encode_coefs_batch(coef: torch.Tensor, height: int, width: int, quality: int) -> list[bytes]:
    """Whole JPEG files from F frames' coefficients [F, nblocks, 64], in one J3 call."""
    header = jfif_header(height, width, quality)
    return [header + scan + EOI for scan in huffman_scan_batch(coef)]


def encode_coefs(coef: torch.Tensor, height: int, width: int, quality: int) -> bytes:
    """A whole JPEG file from one frame's coefficients [nblocks, 64]."""
    return encode_coefs_batch(coef[None], height, width, quality)[0]


def encode_i420(frames_u8: torch.Tensor, quality: int = 90) -> list[bytes]:
    """Packed I420 frames [B, H·3/2, W] uint8 (the layout of video/i420.py
    and SDXLHolder.to_i420_device) → one JPEG file per frame (one J1 and
    one J3 call for the B frames)."""
    h, w = _check_frames("encode_i420", frames_u8, "i420")
    return encode_coefs_batch(fdct_quant(frames_u8.contiguous(), quality, "i420"), h, w, quality)


def encode_rgb(frames_u8: torch.Tensor, quality: int = 90) -> list[bytes]:
    """RGB frames [B, H, W, 3] uint8 → one JPEG file per frame (libjpeg's
    color conversion and 2×2 downsampling first, as cv2.imencode does; one
    J1 and one J3 call for the B frames)."""
    h, w = _check_frames("encode_rgb", frames_u8, "rgb")
    return encode_coefs_batch(fdct_quant(frames_u8.contiguous(), quality, "rgb"), h, w, quality)


# the coefficients one CoefFrames.lerp_many call hands J2 and J3 at most: 128
# MiB, 170 frames at 512² and 42 at 1024² (a gap of the 12 s 512² movie codes
# up to ~33), so a long gap's memory stays bounded
MAX_CALL_COEF_BYTES = 128 << 20


class CoefFrames:
    """Two keyframes' quantized coefficients kept on their device, for the
    in-between frames of a gap: lerp_many(ts) encodes round((1-t)·a + t·b)
    for every fraction t with one J2 and one J3 call (the counterpart of
    the JAX package's JpegPair, which does the same a frame at a time on
    the host through libjpeg). Both keyframes were quantized with one
    quality, so the lerp is that of the same JPEG tables."""

    def __init__(self, coef_a: torch.Tensor, coef_b: torch.Tensor, height: int, width: int, quality: int):
        if coef_a.shape != coef_b.shape or coef_a.shape != (num_blocks(height, width), 64):
            raise ValueError(f"CoefFrames: coefficients {tuple(coef_a.shape)} and {tuple(coef_b.shape)} "
                             f"do not both fit a {height}x{width} frame")
        self.a, self.b = coef_a, coef_b
        self._hwq = (height, width, quality)
        self._per_call = max(1, MAX_CALL_COEF_BYTES // (coef_a.numel() * 2))

    def lerp_many(self, ts) -> list[bytes]:
        """The frames at fractions ts, in order: one J2 and one J3 call for
        every MAX_CALL_COEF_BYTES of coefficients. J2 at t = 1 gives b's
        coefficients exactly (fmaf(0, a, 1·b) = b), so a gap's fractions up
        to 1 give its in-between frames and then b's own sample."""
        ts = [float(t) for t in ts]
        out: list[bytes] = []
        for i in range(0, len(ts), self._per_call):
            out += encode_coefs_batch(coef_lerp_batch(self.a, self.b, ts[i:i + self._per_call]), *self._hwq)
        return out

    def lerp(self, t: float) -> bytes:
        return self.lerp_many([t])[0]
