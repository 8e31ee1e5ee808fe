"""I420 (planar YCbCr 4:2:0) keyframe helpers — host side.

The movie path's keyframes can leave the device as packed I420 planes
(holder.to_i420_device) instead of RGB: 1.5 B/px instead of 3 halves the
device→host transfer (the largest remaining term of the turbo wall,
BENCH.md), and the native JPEG encoder consumes the planes directly via
libjpeg raw-data mode (_jpeg_lerp.encode_i420) — no host color conversion
or subsampling pass. JPEG itself encodes from 4:2:0 YCbCr anyway, so for
movie output the format change is exactly the subsampling the encoder
would have performed (reference output path anchor:
/root/reference/latentblending/blending_engine.py:684-706).

Layout (matches OpenCV's I420 convention for a [H*3/2, W] uint8 buffer):
rows [0, H) = Y; rows [H, H+H/4) = Cb as (H/2 × W/2) row-major packed two
chroma rows per buffer row; rows [H+H/4, H*3/2) = Cr likewise.
Color math is JFIF full-range BT.601 (ITU-T T.871 §7) — what JPEG uses.
"""
from __future__ import annotations

import numpy as np


def is_i420(arr) -> bool:
    """I420 keyframes are 2-D uint8 buffers; RGB keyframes are HWC 3-D."""
    return getattr(arr, "ndim", 0) == 2


def i420_hw(arr) -> tuple[int, int]:
    """(H, W) of the image packed in an I420 buffer [H*3/2, W]."""
    rows, w = arr.shape
    assert rows % 3 == 0, f"not an I420 buffer: {arr.shape}"
    return rows * 2 // 3, w


def split_planes(arr) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[H*3/2, W] → (Y [H,W], Cb [H/2,W/2], Cr [H/2,W/2])."""
    h, w = i420_hw(arr)
    y = arr[:h]
    cb = arr[h : h + h // 4].reshape(h // 2, w // 2)
    cr = arr[h + h // 4 :].reshape(h // 2, w // 2)
    return y, cb, cr


def i420_to_rgb(arr) -> np.ndarray:
    """Packed I420 → uint8 RGB [H,W,3]: nearest-neighbor chroma upsample +
    exact JFIF inverse. Used to materialize API-facing keyframe images
    (tree_final_imgs) and the pixel-lerp fallback paths; the JPEG encode
    path never round-trips through RGB."""
    y, cb, cr = split_planes(np.asarray(arr))
    yf = y.astype(np.float32)
    cbf = np.repeat(np.repeat(cb, 2, axis=0), 2, axis=1).astype(np.float32) - 128.0
    crf = np.repeat(np.repeat(cr, 2, axis=0), 2, axis=1).astype(np.float32) - 128.0
    r = yf + 1.402 * crf
    g = yf - 0.344136286 * cbf - 0.714136286 * crf
    b = yf + 1.772 * cbf
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb + 0.5, 0.0, 255.0).astype(np.uint8)


def rgb_to_i420(rgb) -> np.ndarray:
    """uint8 RGB [H,W,3] → packed I420 [H*3/2, W] — the host reference for
    holder.to_i420_device (same math: JFIF forward + 2×2 mean-pool chroma);
    differential-tested against it."""
    img = np.asarray(rgb, dtype=np.float32)
    h, w = img.shape[:2]
    assert h % 4 == 0 and w % 2 == 0, f"I420 needs H%4==0, W%2==0: {(h, w)}"
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    pool = lambda c: c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))  # noqa: E731
    u8 = lambda x: np.clip(x + 0.5, 0.0, 255.0).astype(np.uint8)  # noqa: E731
    return np.concatenate(
        [u8(y), u8(pool(cb)).reshape(h // 4, w), u8(pool(cr)).reshape(h // 4, w)], axis=0
    )


def to_rgb(arr) -> np.ndarray:
    """Keyframe of either format → uint8 RGB."""
    a = np.asarray(arr)
    return i420_to_rgb(a) if is_i420(a) else a
