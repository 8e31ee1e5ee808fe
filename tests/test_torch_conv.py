"""C1 (latentblending_tpu_torch/ops/conv.py, csrc/conv3x3_f32.cu) on the CPU:
the plain version against F.conv2d, the module's route over the SDXL VAE's
and UNet's convolutions at full size (meta tensors: shapes only), the
state-dict keys, and the kernel's arithmetic emulated in numpy against the
error bound chip_smoke.py holds it to on the card.

The kernel itself runs only on the card (chip_smoke.py's C1 cases)."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from latentblending_tpu_torch.models import configs, layers
from latentblending_tpu_torch.models.unet import UNet2DCondition
from latentblending_tpu_torch.models.vae import VAE
from latentblending_tpu_torch.ops import conv

# several test workers share the cores (see tests/torch_port_util.py)
torch.set_num_threads(1)

# chip_smoke.py's C1 bound: max |C1 - F.conv2d in float64| <= C1_REL_BOUND *
# max |the float64 result|
C1_REL_BOUND = 1e-5
C1_CIN_BLOCK = 8  # input channels a K block (one fresh accumulator)


@pytest.mark.parametrize("B,cin,cout,h,w,bias", [
    (2, 8, 64, 5, 8, True), (1, 16, 128, 7, 20, False), (3, 4, 3, 6, 6, True), (1, 32, 64, 1, 1, True),
])
def test_plain_version_matches_conv2d(B, cin, cout, h, w, bias):
    g = torch.Generator().manual_seed(B * 1000 + cin)
    x = torch.randn((B, cin, h, w), generator=g)
    wt = torch.randn((cout, cin, 3, 3), generator=g) * (9 * cin) ** -0.5
    b = torch.randn((cout,), generator=g) if bias else None
    want = F.conv2d(x.double(), wt.double(), None if b is None else b.double(), padding=1)
    got = conv.conv3x3_reference(x, wt, b)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got.double() - want).abs().max().item() <= 1e-6 * max(1.0, want.abs().max().item())
    # a CPU tensor takes the plain version, and the module keeps F.conv2d
    assert torch.equal(conv.conv3x3_f32(x, wt, b), got)
    mod = layers.conv3x3(cin, cout)
    with torch.no_grad():
        mod.weight.copy_(wt)
        if b is not None:
            mod.bias.copy_(b)
        assert not conv.route(mod, x)
        assert torch.equal(mod(x), F.conv2d(x, mod.weight, mod.bias, padding=1))
    with pytest.raises(ValueError):
        conv.conv3x3_f32(x, wt, b, stride=2)


def _conv_calls(module: nn.Module, run) -> list:
    """(name, module, input) of every nn.Conv2d call of run()."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, args, n=n: calls.append((n, m, args[0])))
             for n, m in module.named_modules() if isinstance(m, nn.Conv2d)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return calls


def _vae(dtype):
    with torch.device("meta"):
        return layers.cast_keep_norms_f32(VAE(configs.SDXL_VAE), dtype)


def _unet(dtype, sample_size):
    import dataclasses

    with torch.device("meta"):
        unet = UNet2DCondition(dataclasses.replace(configs.SDXL_TURBO_UNET, sample_size=sample_size), 1280)
        return layers.cast_keep_norms_f32(unet, dtype)


def _decode(B: int, hw: int, dtype=torch.float32):
    vae = _vae(dtype)
    return vae, lambda: vae.decode(torch.empty((B, 4, hw, hw), device="meta", dtype=dtype))


def _encode(hw: int):
    vae = _vae(torch.float32)
    return vae, lambda: vae.encode(torch.empty((1, 3, hw, hw), device="meta"))


def _denoise(B: int, hw: int, dtype):
    unet = _unet(dtype, hw)
    meta = {"device": "meta", "dtype": dtype}
    return unet, lambda: unet(torch.empty((B, 4, hw, hw), **meta), torch.empty((B,), device="meta"),
                              torch.empty((B, 77, unet.cfg.cross_attention_dim), **meta),
                              torch.empty((B, 1280), **meta), torch.empty((B, 6), **meta))


def _is_stride1_3x3(name: str, m: nn.Module, prefix: str) -> bool:
    return (name.startswith(prefix) and isinstance(m, layers.Conv3x3) and tuple(m.stride) == (1, 1)
            and not name.endswith(("conv_in", "conv_out")))


# case: (module and its call, the module prefix under which C1 takes every
# stride-1 3x3 convolution but conv_in and conv_out (None: none), the calls
# C1 takes)
ROUTE_CASES = {
    "decoder 512x512 batch 4 (SDXL-Turbo)": (lambda: _decode(4, 64), "decoder.", 31),
    "decoder 1024x1024 batch 1 (SDXL-base)": (lambda: _decode(1, 128), "decoder.", 31),
    "decoder in bf16": (lambda: _decode(4, 64, torch.bfloat16), None, 0),
    "encoder 512x512": (lambda: _encode(512), "encoder.", 20),
    "f32 UNet 512x512 batch 2": (lambda: _denoise(2, 64, torch.float32), "", 36),
    "bf16 UNet 512x512 batch 2": (lambda: _denoise(2, 64, torch.bfloat16), None, 0),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_picks_exactly_the_stride1_3x3_convolutions(case):
    build, prefix, n_taken = ROUTE_CASES[case]
    module, run = build()
    calls = _conv_calls(module, run)
    taken = [n for n, m, x in calls if conv.takes(m, x.shape, x.dtype)]
    assert len(taken) == n_taken, (case, taken)
    if prefix is not None:
        want = sorted(n for n, m, _ in calls if _is_stride1_3x3(n, m, prefix))
        assert sorted(taken) == want
    # the route also asks for NCHW-contiguous inputs: the residual streams
    # stay NCHW (an attention block's sum once took NHWC strides from its
    # permuted operand, and the convolutions after it fell to cuDNN)
    assert all(x.is_contiguous() for n, m, x in calls if n in taken)
    # what stays on F.conv2d: bf16, stride 2 (downsamplers), conv_in, conv_out, 1x1
    for n, m, x in calls:
        if n.endswith(("conv_in", "conv_out", "shortcut", "quant_conv")) or tuple(m.stride) != (1, 1):
            assert not conv.takes(m, x.shape, x.dtype), n


@pytest.mark.parametrize("model", ["vae", "unet"])
def test_state_dict_keys_unchanged(model, monkeypatch):
    build = (lambda: _vae(torch.float32)) if model == "vae" else (lambda: _unet(torch.float32, 64))
    ours = build().state_dict()
    monkeypatch.setattr(layers, "Conv3x3", nn.Conv2d)  # the module tree with plain convolutions
    plain = build().state_dict()
    assert list(ours) == list(plain)
    assert all(ours[k].shape == plain[k].shape for k in ours)
    if model == "vae":
        assert len(ours) == 248


def _trunc(x: np.ndarray) -> np.ndarray:
    """f32 truncated to TF32 (the top 19 bits: what the tensor core reads)."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _add_rz(acc: np.ndarray, s: np.ndarray) -> np.ndarray:
    """acc + s (f64) rounded toward zero to f32: the tensor core's add into
    its accumulator (tests/test_torch_attention_numerics.py::_add_rz)."""
    r = acc.astype(np.float64) + s
    f = r.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(r), np.nextafter(f, np.float32(0)), f)


def _im2col(x: np.ndarray) -> np.ndarray:
    """x [B, C, H, W] → [B*H*W, 9 taps, C], zero padding 1."""
    B, C, H, W = x.shape
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    cols = np.stack([xp[:, :, r:r + H, s:s + W] for r in range(3) for s in range(3)])
    return cols.transpose(1, 3, 4, 0, 2).reshape(B * H * W, 9, C)


def _c1_emulated(x, w, b, passes: int = 3, fold: bool = True) -> np.ndarray:
    """C1's arithmetic: K blocks of 8 input channels; in each, per tap one
    TF32 k8 step a product (lo*hi, hi*lo, hi*hi, each operand truncated),
    each added into the accumulator rounded toward zero; the block's
    accumulator (fresh each block) folded into the f32 total by f32 adds.
    passes=1: the single TF32 pass (hi*hi); fold=False: one accumulator
    for the whole K. Returns [pixels, Cout]."""
    A = _im2col(x)
    cout, cin = w.shape[:2]
    wt = w.reshape(cout, cin, 9).transpose(2, 1, 0)  # [tap, Cin, Cout], B of the GEMM
    total = acc = np.zeros((A.shape[0], cout), np.float32)
    for cb in range(0, cin, C1_CIN_BLOCK):
        if fold:
            acc = np.zeros_like(total)
        for tap in range(9):
            a, q = A[:, tap, cb:cb + C1_CIN_BLOCK], wt[tap, cb:cb + C1_CIN_BLOCK]
            ah, bh = _trunc(a), _trunc(q)
            al, bl = _trunc(a - ah), _trunc(q - bh)
            for u, v in ([(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]):
                acc = _add_rz(acc, u.astype(np.float64) @ v.astype(np.float64))
        if fold:
            total = total + acc
    return (total if fold else acc) + b


@pytest.mark.parametrize("cin,passes,fold,within", [
    (32, 3, True, True),     # 3xTF32, a fresh accumulator a K block: C1
    (512, 3, True, True),    # the decoder's widest K (9 x 512)
    (512, 1, True, False),   # one TF32 pass (cuDNN's TF32 route reads the same order)
    (512, 3, False, False),  # 3xTF32 into one accumulator over K = 4608: the rounding toward zero adds up
])
def test_c1_arithmetic_against_its_bound(cin, passes, fold, within):
    rng = np.random.default_rng(cin + passes)
    cout = 16
    x = rng.standard_normal((1, cin, 4, 6)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 3)) * (9 * cin) ** -0.5).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    want = np.einsum("ptc,tco->po", _im2col(x.astype(np.float64)),
                     w.astype(np.float64).reshape(cout, cin, 9).transpose(2, 1, 0)) + b
    got = _c1_emulated(x, w, b, passes, fold)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert (rel <= C1_REL_BOUND) == within, rel
    if within:  # with room: the card read 0.9-1.0e-6 at the decoder's shapes
        assert rel <= C1_REL_BOUND / 4
