"""Parity of the port's models (latentblending_tpu_torch.models) with the
JAX package, on tiny configs with parameters from a JAX `init` converted by
params_from_jax; plus the full-size structure on the meta device against
the published SDXL parameter/tensor counts, and the weight round trip.

Tolerances: f32 modules rtol 5e-3 / atol 5e-4 (as tests/test_unet_parity.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from latentblending_tpu.models import configs as JC
from latentblending_tpu.models import perceptual as jperc
from latentblending_tpu.models.clip import CLIPTextEncoder as JCLIP
from latentblending_tpu.models.unet import UNet2DCondition as JUNet
from latentblending_tpu.models.vae import VAE as JVAE
from latentblending_tpu.models.weights import (
    convert_clip_state_dict,
    convert_unet_state_dict,
    convert_vae_state_dict,
)
from latentblending_tpu_torch.models import configs as TC
from latentblending_tpu_torch.models import perceptual as tperc
from latentblending_tpu_torch.models.clip import CLIPTextEncoder as TCLIP
from latentblending_tpu_torch.models.layers import init_like_jax_
from latentblending_tpu_torch.models.unet import UNet2DCondition as TUNet
from latentblending_tpu_torch.models.vae import VAE as TVAE
from latentblending_tpu_torch.models.weights import params_from_jax
from tests.torch_port_util import np_tree, port_module

RTOL, ATOL = 5e-3, 5e-4
POOLED = 48


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=atol)


def test_unet_matches_jax():
    """Covers GroupNorm f32 stats, the tanh-GELU GEGLU gate, attention,
    skip order and micro-conditioning in one comparison."""
    ju = JUNet(JC.TINY_UNET)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 64)).astype(np.float32)
    pooled = rng.normal(size=(2, POOLED)).astype(np.float32)
    tids = np.tile(np.array([[128.0, 128.0, 0.0, 0.0, 128.0, 128.0]], np.float32), (2, 1))
    params = jax.jit(ju.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.float32(0.0), jnp.asarray(ctx),
                              jnp.asarray(pooled), jnp.asarray(tids))["params"]
    want = jax.jit(ju.apply)({"params": params}, jnp.asarray(x), jnp.float32(499.0), jnp.asarray(ctx),
                             jnp.asarray(pooled), jnp.asarray(tids))
    tu = port_module(TUNet(TC.TINY_UNET, pooled_dim=POOLED), params)
    with torch.no_grad():
        got = tu(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(499.0), torch.from_numpy(ctx),
                 torch.from_numpy(pooled), torch.from_numpy(tids))
    _close(got.permute(0, 2, 3, 1), want)


def test_geglu_gate_is_tanh_gelu():
    """The JAX GEGLU uses flax nn.gelu (tanh approximation); the exact erf
    GELU differs by far more than the tolerance, so the UNet test above
    would catch a swap. Pin the gate function itself too."""
    from latentblending_tpu_torch.models.layers import GEGLU

    g = GEGLU(4, 4)
    with torch.no_grad():
        g.proj.weight.copy_(torch.cat([torch.zeros(4, 4), torch.eye(4)]))
        g.proj.bias.copy_(torch.cat([torch.ones(4), torch.zeros(4)]))
        x = torch.linspace(-3, 3, 4)[None]
        out = g(x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=True)),
                               rtol=1e-6, atol=1e-6)
    assert (out - F.gelu(x)).abs().max() > 1e-4


def test_vae_decode_matches_jax():
    jv = JVAE(JC.TINY_VAE)
    params = jax.jit(functools.partial(jv.init, method=JVAE.full))(
        jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 64, 64, 3)))["params"]
    z = np.random.default_rng(1).normal(size=(2, 16, 16, 4)).astype(np.float32)
    want = jv.apply({"params": params}, jnp.asarray(z), method=JVAE.decode)
    tv = port_module(TVAE(TC.TINY_VAE), params)
    with torch.no_grad():
        got = tv.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("proj", [False, True])
def test_clip_matches_jax(proj):
    """ViT-L style (quick_gelu, raw pooled) and bigG style (exact gelu,
    projected pooled), with an EOS mid-sequence and at the end."""
    cfg_j = JC.TINY_CLIP_PROJ if proj else JC.TINY_CLIP
    cfg_t = TC.TINY_CLIP_PROJ if proj else TC.TINY_CLIP
    rng = np.random.default_rng(2)
    ids = rng.integers(2, cfg_j.vocab_size - 1, size=(2, 77)).astype(np.int32)
    ids[:, 0] = 0
    ids[0, 10] = cfg_j.eos_token_id
    ids[1, 76] = cfg_j.eos_token_id
    je = JCLIP(cfg_j)
    params = je.init(jax.random.PRNGKey(2), jnp.asarray(ids))["params"]
    want = je.apply({"params": params}, jnp.asarray(ids))
    te = port_module(TCLIP(cfg_t), params)
    with torch.no_grad():
        got = te(torch.from_numpy(ids).long())
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-4, atol=2e-5)


def test_nlpd_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, size=(3, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), -1, 1).astype(np.float32)
    want = jperc.nlpd_distance(jnp.asarray(a), jnp.asarray(b))
    got = tperc.nlpd_distance(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want, rtol=1e-4, atol=1e-6)
    scorer = tperc.NLPDScorer(device="cpu")
    u = ((a[0] + 1) * 127.5).astype(np.uint8)
    assert scorer.distance(u, u) == pytest.approx(1e-6, abs=1e-6)


def test_nlpd_resize_and_blur_match_jax():
    """The pyramid's building blocks: jax.image.resize(linear, 2×) equals
    F.interpolate(bilinear, align_corners=False), and the blur pads by
    reflection, at 1e-6."""
    x = np.random.default_rng(4).normal(size=(2, 9, 7, 1)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 18, 14, 1), method="linear")
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(18, 14), mode="bilinear", align_corners=False)
    _close(got.permute(0, 2, 3, 1), want, rtol=1e-6, atol=1e-6)
    _close(tperc._blur(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
           jperc._blur(jnp.asarray(x)), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- weights / shape

@pytest.mark.parametrize("kind", ["unet", "vae", "clip", "clip_proj"])
def test_weight_round_trip(kind):
    """port state_dict → the JAX converter → params_from_jax gives back the
    same keys and values."""
    mod, conv = {
        "unet": (lambda: TUNet(TC.TINY_UNET, pooled_dim=POOLED), convert_unet_state_dict),
        "vae": (lambda: TVAE(TC.TINY_VAE), convert_vae_state_dict),
        "clip": (lambda: TCLIP(TC.TINY_CLIP), convert_clip_state_dict),
        "clip_proj": (lambda: TCLIP(TC.TINY_CLIP_PROJ), convert_clip_state_dict),
    }[kind]
    m = init_like_jax_(mod(), torch.Generator().manual_seed(5))
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    back = params_from_jax(np_tree(conv(sd)), m)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def _meta(mod_fn):
    with torch.device("meta"):
        return mod_fn()


@pytest.mark.parametrize("name,mod_fn,params,tensors", [
    ("unet", lambda: TUNet(TC.SDXL_TURBO_UNET, pooled_dim=1280), 2_567_463_684, 1680),
    ("vae", lambda: TVAE(TC.SDXL_VAE), 83_653_863, 248),
    ("clip_l", lambda: TCLIP(TC.SDXL_CLIP_L), 123_060_480, None),
    ("clip_bigg", lambda: TCLIP(TC.SDXL_CLIP_BIGG), 694_659_840, None),
])
def test_full_size_structure(name, mod_fn, params, tensors):
    """Published counts (tests/test_param_count_anchors.py,
    tests/test_weight_manifest_anchors.py), built on the meta device."""
    m = _meta(mod_fn)
    assert sum(p.numel() for p in m.parameters()) == params
    if tensors is not None:
        assert len(m.state_dict()) == tensors


def test_full_size_checkpoint_manifest_keys():
    """Every published SDXL unet/vae key of the manifest anchors exists in
    the port module with the published torch shape — the port loads a
    diffusers checkpoint with no renames or transposes."""
    from tests.test_weight_manifest_anchors import UNET_ANCHORS, VAE_ANCHORS

    for mod, anchors in ((_meta(lambda: TUNet(TC.SDXL_BASE_UNET, pooled_dim=1280)), UNET_ANCHORS),
                         (_meta(lambda: TVAE(TC.SDXL_VAE)), VAE_ANCHORS)):
        sd = mod.state_dict()
        bad = {k: (tuple(sd[k].shape) if k in sd else None, s) for k, s in anchors.items()
               if k not in sd or tuple(sd[k].shape) != s}
        assert not bad, bad
