"""Image keyframes in the port against the JAX package (tiny-turbo, f32
UNet): VAE.encode, SDXLHolder.image2latent (at the holder's size and
resized), BlendingEngine.compute_latents_from_image, and
set_keyframe1/2_image followed by run_transition(recycle_img1/2=True) on
the fused and the per-level path; then one holder pair with a bf16 VAE.
The port draws JAX's noise and JAX's ε (`_image_noise`, injected). Each
test states its tolerance; the f32 tiny bound is rtol 5e-3 / atol 5e-4."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.models.vae import VAE as JVAE
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from tests.torch_port_util import inject_jax_noise, port_holder_from_jax, to_torch

PROMPTS = ("photo of a forest at dawn", "photo of a city at night")
RTOL, ATOL = 5e-3, 5e-4


def _img(seed: int, h: int = 128, w: int = 128) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _jax_eps(seed, shape) -> torch.Tensor:
    """The ε of JAX's compute_latents_from_image."""
    return to_torch(jax.random.normal(jax.random.PRNGKey(int(seed)), tuple(shape), jnp.float32))


@pytest.fixture(scope="module")
def holders():
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    tdh = port_holder_from_jax(jdh, "tiny-turbo")
    inject_jax_noise(tdh, jdh)
    return jdh, tdh


def _engines(jdh, tdh):
    jbe = JEngine(jdh, run_benchmark=False)
    tbe = TEngine(tdh)
    tbe._image_noise = _jax_eps
    for be in (jbe, tbe):
        be.set_prompt1(PROMPTS[0])
        be.set_prompt2(PROMPTS[1])
    return jbe, tbe


def test_vae_encode_matches_jax(holders):
    """mean and logvar of VAE.encode, f32 bound. With the quant_conv's
    logvar biases shifted by +25, -35, +40 and -50, logvar is clipped to
    [-30, 20] in both packages."""
    jdh, tdh = holders
    x = np.random.default_rng(3).uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    shift = np.array([0, 0, 0, 0, 25.0, -35.0, 40.0, -50.0], np.float32)
    jp, tvae = jdh.params["vae"], tdh.vae
    for shifted in (False, True):
        if shifted:
            jp = dict(jp)
            jp["quant_conv"] = dict(jp["quant_conv"], bias=jp["quant_conv"]["bias"] + shift)
            tvae = copy.deepcopy(tdh.vae)
            tvae.quant_conv.bias.data += torch.from_numpy(shift)
        jm, jl = jdh.vae.apply({"params": jp}, jnp.asarray(x), method=JVAE.encode)
        with torch.no_grad():
            tm, tl = tvae.encode(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert tm.shape == tl.shape == (2, 4, 8, 8)
        for t, j in ((tm, jm), (tl, jl)):
            np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    assert tl[:, 0].min().item() == 20.0 and tl[:, 1].max().item() == -30.0
    assert tl[:, 2].min().item() == 20.0 and tl[:, 3].max().item() == -30.0


@pytest.mark.parametrize("hw,atol", [((128, 128), ATOL), ((256, 256), ATOL), ((37, 91), 5e-3)])
def test_image2latent_matches_jax(holders, hw, atol):
    """[1,16,16,4] latents in the holder's dtype. At the holder's size and
    at 256² (an integer shrink, where ops/resize.py rounds as cv2 does):
    the f32 bound. At 37×91 (an enlargement) the resized images may differ
    from cv2's by 1 at a rounding boundary (cv2's fixed-point linear rule),
    which the encoder carries to its output: atol 5e-3 (measured 1.5e-3 on
    latents up to ~0.25)."""
    jdh, tdh = holders
    img = _img(2, *hw)
    want = np.asarray(jdh.image2latent(img))
    got = tdh.image2latent(img)
    assert got.shape == (1, 16, 16, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=atol)


def test_compute_latents_from_image_matches_jax(holders):
    """The synthetic trajectory x0 + σ_{i+1}·ε: f32 bound per entry, the
    last entry x0 itself (σ_N = 0), the distance to x0 falling with σ."""
    jdh, tdh = holders
    jbe, tbe = _engines(jdh, tdh)
    img = _img(1)
    want = jbe.compute_latents_from_image(img, seed=7)
    got = tbe.compute_latents_from_image(img, seed=7)
    N = tbe.num_inference_steps
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert g.shape == (1, 16, 16, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    x0 = tdh.image2latent(img)
    assert torch.equal(got[-1], x0)
    devs = [float((t - x0).std()) for t in got]
    assert all(devs[i] > devs[i + 1] for i in range(N - 1))


@pytest.mark.parametrize("end", [1, 2])
def test_image_keyframe_transition_matches_jax(holders, end, monkeypatch):
    """end 1: set_keyframe1_image, then run_transition(recycle_img1=True):
    the fused path with the image trajectory as its window. end 2: a 256²
    image through set_keyframe2_image, then recycle_img2=True: the
    per-level path. In both packages the same path; tree_fracts equal, the
    12 keyframes within 1 LSB, similarities rtol 1e-4, every branch's
    final latent at the f32 tiny bound; the pinned end's final latent is
    the encoded image."""
    monkeypatch.delenv("LB_FUSED", raising=False)
    jdh, tdh = holders
    img = _img(4) if end == 1 else _img(5, 256, 256)
    out = []
    for be in _engines(jdh, tdh):
        if end == 1:
            be.set_keyframe1_image(img, seed=11)
            imgs = be.run_transition(recycle_img1=True, fixed_seeds=[420, 421])
        else:
            be.set_keyframe2_image(img, seed=12)
            imgs = be.run_transition(recycle_img2=True, fixed_seeds=[420, 421])
        out.append((be, [np.asarray(im) for im in imgs]))
    (jbe, jimgs), (tbe, timgs) = out
    for be in (jbe, tbe):
        assert bool(be.last_report.levels[0].get("fused")) is (end == 1)
    assert tbe.tree_fracts == list(jbe.tree_fracts)
    assert len(timgs) == len(jimgs) == 12
    for t, j in zip(timgs, jimgs):
        assert t.shape == (128, 128, 3) and t.dtype == np.uint8
        assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
    np.testing.assert_allclose(tbe.tree_similarities, jbe.tree_similarities, rtol=1e-4)
    for t, j in zip(tbe.tree_latents, jbe.tree_latents):
        np.testing.assert_allclose(t[-1].numpy(), np.asarray(j[-1]), rtol=RTOL, atol=ATOL)
    pinned = 0 if end == 1 else -1
    assert torch.equal(tbe.tree_latents[pinned][-1], tdh.image2latent(img))


def test_bf16_vae_matches_jax_bf16_vae(holders):
    """A bf16 VAE in both packages: the JAX holder with vae_dtype=bfloat16
    on the same f32 parameters (flax casts them at use), the port's weights
    stored in bf16 with f32 norms, which is the same arithmetic. Both round
    each layer's output to bf16 but sum in other orders, and the random
    tiny VAE carries those differences to its output. So the bound is the
    JAX package's own bf16 effect: the port's bf16 result may lie at most
    twice as far from JAX's bf16 result as that lies from JAX's f32 one
    (decode in [-1,1]: measured 0.041 against a bound of 2 × 0.034;
    image2latent 0.0059 against 2 × 0.0044). That bound alone would pass a
    VAE that computed in f32, so the port's bf16 result must also lie at
    least half that bf16 effect away from the port's own f32 result
    (measured 0.034 and 0.0041), where an f32 computation rounded to bf16
    at its output lies within half a bf16 step (at most 0.002 in [-1,1];
    0.0005 on these latents). The uint8 conversions of the same bf16
    images: RGB within 1 and I420 within 2 of JAX's (the port converts in
    float32, JAX rounds to bf16 after every op and saturates at 255)."""
    jdh32, tdh32 = holders
    jdh = JHolder("tiny-turbo", jdh32.params, dtype=jnp.float32, vae_dtype=jnp.bfloat16)
    tdh = port_holder_from_jax(jdh, "tiny-turbo", vae_dtype=torch.bfloat16)
    assert tdh.vae.post_quant_conv.weight.dtype == torch.bfloat16
    assert tdh.vae.decoder.conv_norm_out.weight.dtype == torch.float32
    assert tdh.decode_chunk == jdh.decode_chunk == 8

    lat = np.random.default_rng(11).normal(size=(5, 16, 16, 4)).astype(np.float32)
    want = np.asarray(jdh.decode_to_pm1_batched(jnp.asarray(lat)), np.float32)
    want32 = np.asarray(jdh32.decode_to_pm1_batched(jnp.asarray(lat)), np.float32)
    got = tdh.decode_to_pm1_batched(torch.from_numpy(lat))
    got32 = tdh32.decode_to_pm1_batched(torch.from_numpy(lat)).numpy()
    assert got.dtype == torch.bfloat16 and got.shape == (5, 128, 128, 3)
    effect = np.abs(want - want32).max()
    assert np.abs(got.float().numpy() - want).max() <= 2 * effect
    assert np.abs(got.float().numpy() - got32).max() >= effect / 2

    same = jnp.asarray(got.float().numpy(), jnp.bfloat16)
    rgb_j = np.asarray(jdh.to_uint8_device(same)).astype(int)
    assert np.abs(tdh.to_uint8_device(got).numpy().astype(int) - rgb_j).max() <= 1
    i420_j = np.asarray(jdh.to_i420_device(same)).astype(int)
    assert np.abs(tdh.to_i420_device(got).numpy().astype(int) - i420_j).max() <= 2

    img = _img(6)
    enc = np.asarray(jdh.image2latent(img), np.float32)
    enc32 = np.asarray(jdh32.image2latent(img), np.float32)
    got_enc = tdh.image2latent(img)
    assert got_enc.dtype == torch.float32  # the UNet's dtype
    effect = np.abs(enc - enc32).max()
    assert np.abs(got_enc.numpy() - enc).max() <= 2 * effect
    assert np.abs(got_enc.numpy() - tdh32.image2latent(img).numpy()).max() >= effect / 2


def test_bf16_vae_runs_every_conv_and_linear_in_bf16(holders):
    """With vae_dtype=bfloat16 every convolution and linear layer of the
    port's VAE takes and returns bf16 tensors, in decode and in encode, and
    each of them runs: nothing is upcast to f32 between the norms."""
    jdh32, _ = holders
    tdh = port_holder_from_jax(jdh32, "tiny-turbo", vae_dtype=torch.bfloat16)
    layers = {m for m in tdh.vae.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    seen = {}

    def hook(mod, args, out):
        seen.setdefault(mod, set()).add((args[0].dtype, out.dtype))

    handles = [m.register_forward_hook(hook) for m in layers]
    try:
        tdh.decode_to_pm1_batched(torch.from_numpy(np.random.default_rng(12).normal(size=(2, 16, 16, 4)).astype(np.float32)))
        tdh.image2latent(_img(7))
    finally:
        for h in handles:
            h.remove()
    assert set(seen) == layers
    assert set().union(*seen.values()) == {(torch.bfloat16, torch.bfloat16)}
