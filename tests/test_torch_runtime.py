"""Parity of the port's runtime (latentblending_tpu_torch.runtime) with the
JAX package: denoise_scan for each solver, with and without CFG and
crossfeed (the JAX per-step ancestral draws injected), and the holder's
text embedding, chunked VAE decode, decode-chunk rule and return_image. Tiny configs, parameters from a JAX
init; f32 tolerance rtol 5e-3 / atol 5e-4 unless a test says otherwise."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.ops.scheduler import SDXL_TURBO_SCHEDULER, make_schedule
from latentblending_tpu.runtime import denoise as jd
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.models.layers import cast_keep_norms_f32
from latentblending_tpu_torch.runtime import denoise as td
from latentblending_tpu_torch.runtime import holder as th
from tests.torch_port_util import port_holder_from_jax, tiny_unet_pair

POOLED = 48
N = 3


@pytest.fixture(scope="module")
def unets():
    return tiny_unet_pair(POOLED)


@pytest.mark.parametrize("sched,use_cfg,crossfeed,idx_start,rescale", [
    ("euler", False, False, 0, 0.0),
    ("euler", True, True, 1, 0.0),
    ("euler_ancestral", False, True, 0, 0.0),
    ("euler_ancestral", True, False, 1, 0.0),
    ("dpmpp_2m", True, True, 0, 0.7),
    ("dpmpp_2m", False, True, 1, 0.0),
])
def test_denoise_scan_matches_jax(unets, sched, use_cfg, crossfeed, idx_start, rescale):
    j_apply, params, t_apply = unets
    rng = np.random.default_rng(10)
    B = 2
    lat = rng.normal(size=(B, 8, 8, 4)).astype(np.float32) * 4.0
    mix_traj = rng.normal(size=(N, B, 8, 8, 4)).astype(np.float32) * 2.0
    coeffs = rng.uniform(0.2, 0.8, size=(N, B)).astype(np.float32) if crossfeed else None
    pe, ne = (rng.normal(size=(B, 77, 64)).astype(np.float32) for _ in range(2))
    pool, npool = (rng.normal(size=(B, POOLED)).astype(np.float32) for _ in range(2))
    tids = np.tile(np.array([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]], np.float32), (B, 1))
    g = np.array([5.0, 2.0], np.float32)
    sch = make_schedule(SDXL_TURBO_SCHEDULER, N)
    plan_kw = dict(num_steps=N, idx_start=idx_start, batch=B, use_cfg=use_cfg,
                   guidance_rescale=rescale if use_cfg else 0.0, sched=sched)
    M = N - idx_start
    keys = jax.random.split(jax.random.PRNGKey(7), M)
    z = np.stack([np.asarray(jax.random.normal(k, (B, 8, 8, 4), jnp.float32)) for k in keys])

    jmw, jmc = jd.build_mix_inputs(N, idx_start, None if coeffs is None else jnp.asarray(mix_traj), coeffs,
                                   jnp.asarray(lat))
    jcond = jd.Conditioning(*(jnp.asarray(x) for x in (pe, pool, tids, ne, npool, tids)))
    want = jd.denoise_scan(j_apply, params, jd.DenoisePlan(**plan_kw), jnp.asarray(lat), jcond, jmw, jmc,
                           jnp.asarray(sch.sigmas), jnp.asarray(sch.timesteps), jnp.asarray(g), step_keys=keys)

    tmw, tmc = td.build_mix_inputs(N, idx_start, None if coeffs is None else torch.from_numpy(mix_traj), coeffs,
                                   torch.from_numpy(lat))
    np.testing.assert_array_equal(tmc.numpy(), np.asarray(jmc))
    if idx_start == 0:
        assert not tmc[0].any()  # no crossfeed at global step 0
    tcond = td.Conditioning(*(torch.from_numpy(x) for x in (pe, pool, tids, ne, npool, tids)))
    with torch.no_grad():
        got = td.denoise_scan(t_apply, td.DenoisePlan(**plan_kw), torch.from_numpy(lat), tcond, tmw, tmc,
                              sch.sigmas, sch.timesteps, torch.from_numpy(g), noise=torch.from_numpy(z))
    assert got.shape == (M, B, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-4)


def test_ancestral_without_noise_source_raises(unets):
    _, _, t_apply = unets
    plan = td.DenoisePlan(num_steps=2, idx_start=0, batch=1, use_cfg=False, sched="euler_ancestral")
    with pytest.raises(ValueError):
        td.denoise_scan(t_apply, plan, torch.zeros(1, 8, 8, 4), None, torch.zeros(2, 1, 8, 8, 4),
                        torch.zeros(2, 1), np.ones(3, np.float32), np.ones(2, np.float32), torch.ones(1))


@pytest.fixture(scope="module")
def holders():
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    return jdh, port_holder_from_jax(jdh, "tiny-turbo")


def test_holder_text_embedding_matches_jax(holders):
    """The 4-tuple (CLIP-L ++ bigG penultimate states, pooled projection),
    same hash-tokenizer ids on both sides: rtol 1e-4 / atol 2e-5."""
    jdh, tdh = holders
    for h in (jdh, tdh):
        h.set_negative_prompt("blurry, low quality")
    want = jdh.get_text_embedding("photo of a forest at dawn")
    got = tdh.get_text_embedding("photo of a forest at dawn")
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(tdh.default_time_ids(3).numpy(), np.asarray(jdh.default_time_ids(3)))


def test_holder_decode_matches_jax(holders):
    """decode_to_pm1_batched over 5 latents (chunks of 4 + 1) and the uint8
    conversion: f32 tolerance, uint8 within 1 LSB."""
    jdh, tdh = holders
    assert tdh.decode_chunk == jdh.decode_chunk == 4
    lat = np.random.default_rng(11).normal(size=(5, 16, 16, 4)).astype(np.float32)
    want = jdh.decode_to_pm1_batched(jnp.asarray(lat))
    got = tdh.decode_to_pm1_batched(torch.from_numpy(lat))
    assert got.shape == (5, 128, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-4)
    u_want = np.asarray(jdh.to_uint8_device(want)).astype(int)
    u_got = tdh.to_uint8_device(got).numpy().astype(int)
    assert np.abs(u_got - u_want).max() <= 1
    # seeded noise: a torch.Generator draw scaled by init_noise_sigma
    want_noise = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(tdh.get_noise(3), want_noise * tdh.schedule.init_noise_sigma)


@pytest.mark.parametrize("size", [(128, 128), (512, 512), (768, 768), (1024, 1024)])
def test_decode_chunk_rule_matches_jax(holders, size, monkeypatch):
    """decode_chunk: the JAX rule for an f32 and a bf16 VAE at each size
    (base 4 or 8 at ≤512², base // 4 between, 1 at ≥1024²), then
    LB_DECODE_CHUNK, then a value set on the holder, each equal to JAX's."""
    jdh, tdh = holders
    jdh16 = JHolder("tiny-turbo", jdh.params, dtype=jnp.float32, vae_dtype=jnp.bfloat16)
    tdh16 = th.SDXLHolder("tiny-turbo", {"unet": tdh.unet, "clip1": tdh.clip1, "clip2": tdh.clip2,
                                         "vae": cast_keep_norms_f32(copy.deepcopy(tdh.vae), torch.bfloat16)},
                          dtype=torch.float32, vae_dtype=torch.bfloat16, device="cpu")
    monkeypatch.delenv("LB_DECODE_CHUNK", raising=False)
    pairs = ((jdh, tdh), (jdh16, tdh16))
    try:
        for j, t in pairs:
            j.set_dimensions(size)
            t.set_dimensions(size)
            assert t.decode_chunk == j.decode_chunk
        assert tdh16.decode_chunk == {128: 8, 512: 8, 768: 2, 1024: 1}[size[0]]
        monkeypatch.setenv("LB_DECODE_CHUNK", "3")
        for j, t in pairs:
            assert t.decode_chunk == j.decode_chunk == 3
        for j, t in pairs:
            j.decode_chunk = 2
            t.decode_chunk = 2
            assert t.decode_chunk == j.decode_chunk == 2
    finally:
        for j, t in pairs:
            j._decode_chunk_override = t._decode_chunk_override = None
            j.set_dimensions(None)
            t.set_dimensions(None)
    with pytest.raises(ValueError, match="vae_dtype"):
        th.SDXLHolder("tiny-turbo", {"unet": tdh.unet, "vae": tdh.vae, "clip1": tdh.clip1, "clip2": tdh.clip2},
                      dtype=torch.float32, vae_dtype=torch.bfloat16, device="cpu")


def test_return_image_matches_jax(holders):
    """run_diffusion(return_image=True) and the engine's
    compute_latents1/2(return_image=True) give the last latent's uint8
    image (JAX's noise injected): within 1 LSB of JAX's; compute_latents1/2
    still store their trajectories."""
    from latentblending_tpu.engine.blending import BlendingEngine as JEngine
    from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
    from tests.torch_port_util import inject_jax_noise

    jdh, tdh = holders
    inject_jax_noise(tdh, jdh)
    try:
        _return_image_parity(jdh, tdh, JEngine, TEngine)
    finally:  # the module's holder draws its own noise again
        for name in ("get_noise", "ancestral_noise", "ancestral_noise_steps"):
            delattr(tdh, name)


def _return_image_parity(jdh, tdh, JEngine, TEngine):
    te_j = jdh.get_text_embedding("photo of a forest at dawn")
    te_t = tdh.get_text_embedding("photo of a forest at dawn")
    want = jdh.run_diffusion(te_j, jdh.get_noise(5), idx_start=1, return_image=True)
    got = tdh.run_diffusion(te_t, tdh.get_noise(5), idx_start=1, return_image=True)
    assert got.shape == (128, 128, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1
    jbe, tbe = JEngine(jdh, run_benchmark=False), TEngine(tdh)
    for be in (jbe, tbe):
        be.set_prompt1("photo of a forest at dawn")
        be.set_prompt2("photo of a city at night")
        be.set_branch1_crossfeed(0.5, 0.7, 0.2)
        be.seed1, be.seed2 = 420, 421
    for name in ("compute_latents1", "compute_latents2"):
        want, got = getattr(jbe, name)(return_image=True), getattr(tbe, name)(return_image=True)
        assert got.shape == (128, 128, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1
    for t, j in zip(tbe.tree_latents, jbe.tree_latents):
        assert len(t) == len(j) == tdh.num_inference_steps
        np.testing.assert_allclose(t[-1].numpy(), np.asarray(j[-1]), rtol=5e-3, atol=5e-4)


def test_holder_defaults_to_the_card():
    """SDXLHolder, from_random and from_state_dicts default to device
    "cuda"; without a card, a holder built without device= raises instead
    of building on the CPU."""
    import inspect

    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    for fn in (SDXLHolder.__init__, SDXLHolder.from_random, SDXLHolder.from_state_dicts):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDXLHolder.from_random("tiny-turbo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDXLHolder.from_state_dicts("tiny-turbo", {})
