"""ops/resize.py (the port's INTER_AREA resize) against OpenCV's
cv2.resize(..., interpolation=cv2.INTER_AREA), which the JAX package's
image2latent calls: uint8 within 1 LSB at shrinking, enlarging, mixed and
integer factors (cv2 computes its linear rule in 11-bit fixed point), and
exactly equal at 2×2 and 3-fold shrink factors (a box mean)."""
import cv2
import numpy as np
import pytest
import torch

from latentblending_tpu_torch.ops.resize import area_weights, resize_area


def _images(h: int, w: int, seed: int):
    """A noise image and a smooth one (sinusoids), uint8 [h, w, 3]."""
    noise = np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([127.5 + 127.5 * np.sin(xx / 7.3 + c) * np.cos(yy / 5.1) for c in range(3)], -1)
    return noise, smooth.round().astype(np.uint8)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((200, 300), (128, 128)),   # shrink, fractional factors
    ((640, 768), (512, 512)),   # shrink (chip_smoke's second keyframe)
    ((129, 131), (128, 128)),   # shrink by less than a pixel
    ((37, 91), (128, 128)),     # enlarge (tests/test_image_keyframes.py's size)
    ((384, 384), (512, 512)),   # enlarge by 4/3
    ((100, 60), (128, 128)),    # enlarge both, unequal factors
    ((300, 50), (128, 128)),    # mixed: rows shrink, columns grow
    ((1000, 333), (512, 512)),  # mixed
    ((128, 96), (128, 128)),    # one axis kept, one enlarged
])
def test_resize_area_matches_cv2(in_hw, out_hw):
    for img in _images(*in_hw, seed=sum(in_hw)):
        want = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_AREA)
        got = resize_area(torch.from_numpy(img), *out_hw)
        assert got.dtype == torch.uint8 and tuple(got.shape) == out_hw + (3,)
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("in_hw,out_hw", [((256, 256), (128, 128)), ((384, 128), (128, 128)), ((128, 384), (128, 128))])
def test_resize_area_integer_shrink_is_exact(in_hw, out_hw):
    """2×2 (halves rounded up in both) and 3-fold factors (no halves).
    At other even cell sizes cv2 may round a half to even instead."""
    for img in _images(*in_hw, seed=1):
        want = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area(torch.from_numpy(img), *out_hw).numpy(), want)


def test_area_weights_rows_sum_to_one_and_float_input_stays_unrounded():
    """Every output pixel is a convex combination of source pixels; a float
    image comes back as float32 (cv2 returns float for float input)."""
    for in_hw, out_hw in (((200, 300), (128, 128)), ((37, 91), (128, 128)), ((300, 50), (128, 128))):
        for m in area_weights(in_hw, out_hw):
            assert (m >= 0).all()
            np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-12)
    img = np.random.default_rng(2).uniform(0, 255, (37, 91, 3)).astype(np.float32)
    got = resize_area(torch.from_numpy(img), 128, 128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), cv2.resize(img, (128, 128), interpolation=cv2.INTER_AREA), atol=0.6)
    with pytest.raises(ValueError):
        resize_area(torch.from_numpy(img[..., 0]), 64, 64)


def test_resize_area_follows_its_input_device():
    """The op has no device of its own: the output lies where the input
    does (a tensor on the card is resized on the card), and its weights
    follow it there."""
    img = torch.from_numpy(_images(300, 50, seed=3)[0])
    assert resize_area(img, 128, 128).device == img.device
    meta = resize_area(img.to("meta"), 128, 128)
    assert meta.device.type == "meta" and tuple(meta.shape) == (128, 128, 3) and meta.dtype == torch.uint8
