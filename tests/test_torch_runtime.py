"""Parity of the port's runtime (latentblending_tpu_torch.runtime) with the
JAX package: denoise_scan for each solver, with and without CFG and
crossfeed (the JAX per-step ancestral draws injected), and the holder's
text embedding and chunked VAE decode. Tiny configs, parameters from a JAX
init; f32 tolerance rtol 5e-3 / atol 5e-4 unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.models import configs as JC
from latentblending_tpu.models.unet import UNet2DCondition as JUNet
from latentblending_tpu.ops.scheduler import SDXL_TURBO_SCHEDULER, make_schedule
from latentblending_tpu.runtime import denoise as jd
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.models import configs as TC
from latentblending_tpu_torch.models.unet import UNet2DCondition as TUNet
from latentblending_tpu_torch.runtime import denoise as td
from tests.torch_port_util import port_holder_from_jax, port_module

POOLED = 48
N = 3


@pytest.fixture(scope="module")
def unets():
    ju = JUNet(JC.TINY_UNET)
    params = jax.jit(ju.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 4)), jnp.float32(0.0), jnp.zeros((1, 77, 64)),
        jnp.zeros((1, POOLED)), jnp.zeros((1, 6)),
    )["params"]
    tu = port_module(TUNet(TC.TINY_UNET, pooled_dim=POOLED), params)

    def t_apply(lat, t, pe, pool, tids):
        return tu(lat.permute(0, 3, 1, 2), t, pe, pool, tids).permute(0, 2, 3, 1).contiguous()

    return (lambda p, lat, t, pe, pool, tids: ju.apply({"params": p}, lat, t, pe, pool, tids)), params, t_apply


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
