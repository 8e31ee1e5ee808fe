"""The reference's single-branch APIs in the port against the JAX package,
on tiny-turbo (f32, deterministic Euler, the JAX seeded noise injected):

- the loop compute_latents1/2 → get_tree_similarities → (get_mixing_parameters,
  _find_parents, set_guidance_mid_dampening, compute_latents_mix,
  insert_into_tree) × 3: tree_fracts and tree_idx_injection equal, uint8
  keyframes within 1 LSB, latents within the f32 tiny bound (rtol 5e-3,
  atol 5e-4), similarities within rtol 1e-4;
- insert_into_tree after run_transition with the device keyframes aligned
  (they take the new keyframe, get_tree_similarities reads them) and
  misaligned (they are dropped, and the host keyframes are scored);
- get_text_embeddings, run_diffusion (return_image), the
  run_diffusion_sd_xl alias, init_types, prepare_mixing and its errors,
  compute_preview_images (one batched denoise and decode);
- write_imgs_transition: the file names, each JPEG's entropy-coded segment
  byte-equal to PIL's save of the same keyframe (quality 75, 4:2:0), and
  yaml.safe_load of lowres.yaml equal to get_state_dict(), for plain and
  awkward prompts (":", "#", quotes, a leading "-", empty, non-ASCII); for
  plain prompts the text equals PyYAML's.
"""
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.yaml_text import dump
from tests.torch_port_util import inject_jax_noise, port_holder_from_jax

PROMPTS = ("photo of a forest at dawn", "photo of a city at night")


@pytest.fixture(scope="module")
def engines():
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    tdh = port_holder_from_jax(jdh, "tiny-turbo")
    inject_jax_noise(tdh, jdh)
    out = []
    for be in (JEngine(jdh, run_benchmark=False), TEngine(tdh)):
        be.set_prompt1(PROMPTS[0])
        be.set_prompt2(PROMPTS[1])
        be.seed1, be.seed2 = 420, 421
        out.append(be)
    return out


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def _same_tree(jbe, tbe):
    assert tbe.tree_fracts == list(jbe.tree_fracts)
    assert tbe.tree_idx_injection == list(jbe.tree_idx_injection)
    assert len(tbe.tree_final_imgs) == len(jbe.tree_final_imgs)
    for t, j in zip(tbe.tree_final_imgs, jbe.tree_final_imgs):
        assert _lsb(t, j) <= 1
    np.testing.assert_allclose(tbe.tree_similarities, jbe.tree_similarities, rtol=1e-4)


def test_reference_loop_matches_jax(engines):
    jbe, tbe = engines
    for be in engines:
        be.tree_latents = [be.compute_latents1(), be.compute_latents2()]
        be.tree_fracts = [0.0, 1.0]
        be.tree_idx_injection = [0, 0]
        be.tree_final_imgs = [be.dh.latent2image(be.tree_latents[0][-1]), be.dh.latent2image(be.tree_latents[-1][-1])]
        be._imgs_dev = []
        be.tree_similarities = be.get_tree_similarities()
    _same_tree(jbe, tbe)
    idx = 2
    for _ in range(3):
        placed = []
        for be in engines:
            fract, b1, b2 = be.get_mixing_parameters(idx)
            assert be._find_parents(fract, idx) == (b1, b2)
            assert be.get_closest_idx(fract) == tuple(be.get_closest_idx(fract))
            be.set_guidance_mid_dampening(fract)
            lat = be.compute_latents_mix(fract, b1, b2, idx)
            assert lat[:idx] == [None] * idx and len(lat) == be.num_inference_steps
            be.insert_into_tree(fract, idx, lat)
            placed.append((fract, b1, b2, lat))
        (jf, jb1, jb2, jlat), (tf, tb1, tb2, tlat) = placed
        assert (tf, tb1, tb2) == (jf, jb1, jb2)
        np.testing.assert_allclose(tlat[-1].numpy(), np.asarray(jlat[-1]), rtol=5e-3, atol=5e-4)
        assert tbe.guidance_scale == jbe.guidance_scale
    _same_tree(jbe, tbe)
    assert len(tbe.tree_final_imgs) == 5 and tbe._imgs_dev == []
    tsims = tbe.get_tree_similarities()
    np.testing.assert_allclose(tsims, jbe.get_tree_similarities(), rtol=1e-4)
    np.testing.assert_allclose(tsims, tbe.tree_similarities, rtol=1e-5)
    a, b = tbe.tree_final_imgs[:2]
    assert tbe.get_lpips_similarity(a, b) == pytest.approx(jbe.get_lpips_similarity(a, b), rel=1e-4)


@pytest.mark.parametrize("aligned", [True, False])
def test_insert_into_tree_alignment(engines, aligned, monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    jbe, tbe = engines
    for be in engines:
        be.set_branching(nmb_max_branches=2)
        be.run_transition(fixed_seeds=[420, 421])
        if not aligned:
            be._imgs_dev = be._imgs_dev[:-1]
        fract, b1, b2 = be.get_mixing_parameters(3)
        pos = be.get_closest_idx(fract)[0] + 1
        be.set_guidance_mid_dampening(fract)
        be.insert_into_tree(fract, 3, be.compute_latents_mix(fract, b1, b2, 3))
        if aligned:
            assert len(be._imgs_dev) == len(be.tree_final_imgs) == 5
        else:
            assert be._imgs_dev == []
    _same_tree(jbe, tbe)
    if aligned:
        want = tbe.lpips._prep(tbe.tree_final_imgs[pos], tbe.dh.device)[0]
        assert torch.equal(tbe._imgs_dev[pos], want)
    np.testing.assert_allclose(tbe.get_tree_similarities(), jbe.get_tree_similarities(), rtol=1e-4)
    for be in engines:
        be.set_branching()


def test_engine_and_holder_calls_match_jax(engines):
    jbe, tbe = engines
    jte, tte = jbe.get_text_embeddings("a red boat"), tbe.get_text_embeddings("a red boat")
    for j, t in zip(jte, tte):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)
    jimg = jbe.run_diffusion([jte], jbe.get_noise(7), return_image=True)
    timg = tbe.run_diffusion([tte], tbe.get_noise(7), return_image=True)
    assert timg.shape == (128, 128, 3) and _lsb(timg, jimg) <= 1
    jprev, tprev = jbe.compute_preview_images([3, 4, 5]), tbe.compute_preview_images([3, 4, 5])
    assert len(tprev) == 3 and all(_lsb(t, j) <= 1 for t, j in zip(tprev, jprev))
    assert tbe.compute_preview_images([]) == []

    jdh, tdh = jbe.dh, tbe.dh
    assert type(tdh).run_diffusion_sd_xl is type(tdh).run_diffusion
    assert tdh.init_types() == {"dtype": torch.float32, "is_sdxl_turbo": True}
    assert jdh.init_types()["is_sdxl_turbo"] is True
    N = tdh.num_inference_steps
    for dh in (jdh, tdh):
        assert dh.prepare_mixing(0.25, [None] * N) == [0.25] * N
        assert dh.prepare_mixing(np.zeros(N), None) == [0.0] * N
        assert dh.prepare_mixing([0.5] * N, [None] * N) == [0.5] * N
        for coeffs, lats in (([0.5] * (N + 1), [None] * N), ("0.5", None), ([0.5] * N, [None] * (N - 1))):
            with pytest.raises((ValueError, AssertionError)):
                dh.prepare_mixing(coeffs, lats)


def _scan(jpeg: bytes) -> bytes:
    """The entropy-coded segment: the bytes after the SOS segment, EOI excluded."""
    sos = jpeg.index(b"\xff\xda")
    length = int.from_bytes(jpeg[sos + 2 : sos + 4], "big")
    assert jpeg[-2:] == b"\xff\xd9"
    return jpeg[sos + 2 + length : -2]


@pytest.mark.parametrize("prompts,plain", [
    (("photo of a forest at dawn, mist between the trees", "photo of a city at night"), True),
    (("city: skyline #night", "'quoted' \"double\""), False),
    (("- leading dash", ""), False),
    (("héllo wörld, 日本語 😀", "yes"), False),
])
def test_write_imgs_transition(engines, tmp_path, prompts, plain):
    from PIL import Image

    _, tbe = engines
    tbe.tree_final_imgs = list(tbe.compute_preview_images([1, 2, 3]))
    tbe.prompt1, tbe.prompt2 = prompts
    tbe.negative_prompt = prompts[1]
    tbe.write_imgs_transition(str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == ["lowres.yaml", "lowres_img_0000.jpg", "lowres_img_0001.jpg", "lowres_img_0002.jpg"]
    for i, img in enumerate(tbe.tree_final_imgs):
        got = (tmp_path / f"lowres_img_{i:04d}.jpg").read_bytes()
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG")
        assert _scan(got) == _scan(buf.getvalue())
    text = (tmp_path / "lowres.yaml").read_text(encoding="utf-8")
    state = tbe.get_state_dict()
    assert yaml.safe_load(text) == state
    assert text == dump(state)
    if plain:
        assert text == yaml.dump(state, sort_keys=False, default_flow_style=False)
