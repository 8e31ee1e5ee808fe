"""The yardstick pinned to the published numbers (PERF.md's kernel table,
the port's ops/flops.py at the time the benchmark was defined)."""
from __future__ import annotations

import json
import os

import pytest

from benchmark.tests.tiny import REPO
from benchmark.yardstick import flops, roofline, sdxl, work


def _cfg(name):
    with open(os.path.join(REPO, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def test_unet_and_decode_flops():
    turbo, base = _cfg("sdxl-turbo-512"), _cfg("sdxl-base-1024")
    assert flops.unet_forward_flops(turbo["unet"], 64, 64, 1) / 1e12 == pytest.approx(1.589, abs=5e-4)
    assert flops.unet_forward_flops(base["unet"], 128, 128, 1) / 1e12 == pytest.approx(6.761, abs=5e-4)
    assert flops.vae_decode_flops(turbo["vae"], 512, 512) / 1e12 == pytest.approx(2.515, abs=5e-4)
    assert flops.vae_decode_flops(base["vae"], 1024, 1024) / 1e12 == pytest.approx(10.470, abs=5e-4)


def test_attention_bounds():
    # K2 bf16 [12,1024,10,64] and K3 f32 (3xTF32) [4,4096,1,512]
    assert roofline.attention_bound_s(12, 1024, 10, 64, "bfloat16") * 1e6 == pytest.approx(32.57, abs=5e-3)
    assert roofline.attention_bound_s(4, 4096, 1, 512, "float32") * 1e6 == pytest.approx(832.96, abs=5e-3)


def test_transition_work():
    turbo, base = _cfg("sdxl-turbo-512"), _cfg("sdxl-base-1024")
    assert (work.row_steps(turbo), work.image_evals(turbo), work.keyframes(turbo)) == (28, 28, 12)
    assert (work.row_steps(base), work.image_evals(base), work.keyframes(base)) == (147, 294, 10)
    # flash-gated self-attention: L=1024 at 512^2; L=4096 and 1024 at 1024^2
    assert roofline.unet_attention_sites(turbo["unet"], 64, 64) == [(1024, 10, 10)]
    assert roofline.unet_attention_sites(base["unet"], 128, 128) == [(4096, 10, 10), (1024, 20, 60)]
    # 28 needed row-steps of 40 K2 calls at B=12 (10 per eval), and 12 decodes
    want = 28 / 12 * 32.57e-6 * 10 + 3 * 832.96e-6
    assert sdxl.attention_bound_seconds(turbo) == pytest.approx(want, rel=1e-3)
    want_mfu = 28 * 1.589e12 / 989e12 + 12 * 2.515e12 / 165e12
    assert sdxl.model_seconds_at_peak(turbo) == pytest.approx(want_mfu, rel=1e-3)


def test_decode_flops_read_post_quant_conv_and_shift():
    """post_quant_conv is one 1x1 conv of the latent channels, 2·h·w·c², left
    out where `use_post_quant_conv` is false; the shift is not counted."""
    vae = dict(_cfg("sdxl-turbo-512")["vae"], latent_channels=16)
    full = flops.vae_decode_flops(vae, 1024, 1024)
    assert flops.vae_decode_flops(dict(vae, use_post_quant_conv=True), 1024, 1024) == full
    assert flops.vae_decode_flops(dict(vae, shift_factor=0.0609), 1024, 1024) == full
    assert full - flops.vae_decode_flops(dict(vae, use_post_quant_conv=False), 1024, 1024) == 2 * 128 * 128 * 16 * 16
