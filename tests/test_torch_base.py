"""The SDXL-base engine of the port against the JAX package (tiny-base, 8
steps): CFG at guidance 4 with a negative prompt, the time-based branching
plan, the speed benchmark, the measured placement policy over several
levels, stem_batch rounds, EngineConfig and extend_transition.

Bounds as in tests/test_torch_slice.py: tree_fracts and tree_idx_injection
exactly equal, uint8 keyframes within 1 LSB, similarities rtol 1e-4, final
latents rtol 5e-3 / atol 5e-4 (the repo's f32 tiny bound)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.engine.config import EngineConfig
from latentblending_tpu_torch.runtime.holder import SDXLHolder as THolder
from tests.torch_port_util import inject_jax_noise, port_holder_from_jax

PROMPTS = ("a painting of a mountain", "a photo of the ocean", "blurry, low quality")
STEPS = 8


def _setup(be):
    be.set_num_inference_steps(STEPS)
    be.set_negative_prompt(PROMPTS[2])  # read by the next embeddings
    be.set_prompt1(PROMPTS[0])
    be.set_prompt2(PROMPTS[1])
    return be


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on tiny-base with the same weights and noise."""
    jdh = JHolder.from_random("tiny-base", seed=0, dtype=jnp.float32)
    tdh = port_holder_from_jax(jdh, "tiny-base")
    inject_jax_noise(tdh, jdh)
    return _setup(JEngine(jdh, run_benchmark=False)), _setup(TEngine(tdh, run_benchmark=False))


def _assert_same_tree(jbe, tbe, jimgs, timgs):
    assert tbe.tree_fracts == list(jbe.tree_fracts)
    assert tbe.tree_idx_injection == list(jbe.tree_idx_injection)
    assert len(timgs) == len(jimgs) == len(tbe.tree_fracts) == 2 + sum(tbe.list_nmb_stems)
    for t, j in zip(timgs, jimgs):
        assert t.shape == (128, 128, 3) and t.dtype == np.uint8
        assert np.abs(t.astype(int) - np.asarray(j).astype(int)).max() <= 1
    np.testing.assert_allclose(tbe.tree_similarities, jbe.tree_similarities, rtol=1e-4)
    for t, j in zip(tbe.tree_latents, jbe.tree_latents):
        np.testing.assert_allclose(t[-1].numpy(), np.asarray(j[-1]), rtol=5e-3, atol=5e-4)


def test_base_engine_defaults_match_jax(engines):
    jbe, tbe = engines
    assert not tbe.dh.is_sdxl_turbo and tbe.dh.do_classifier_free_guidance
    assert tbe.guidance_scale_base == jbe.guidance_scale_base == 4.0
    assert tbe.placement_policy == "measured" and tbe.stem_batch == 0 and tbe.cost_model == "batched"
    crossfeed = ("parental_crossfeed_power", "parental_crossfeed_range", "parental_crossfeed_decay")
    assert [getattr(tbe, a) for a in crossfeed] == [getattr(jbe, a) for a in crossfeed] == [0.3, 0.6, 0.9]
    # no benchmark: the placeholders, and the default 20 s time-based plan
    assert (tbe.dt_unet_step, tbe.dt_vae, tbe.dt_sync) == (0.01, 0.01, None)
    assert (tbe.list_idx_injection, tbe.list_nmb_stems) == (list(jbe.list_idx_injection), list(jbe.list_nmb_stems))


@pytest.mark.parametrize("cost_model", ["batched", "reference"])
def test_benchmark_speed_fills_the_calibration(cost_model):
    """The constructor of a base engine runs benchmark_speed (port only:
    the timings are walls). 'batched' times the B=2 edge denoise and
    decode and the sync round trip; 'reference' the single-branch step and
    one decode, and leaves the per-batch table and dt_sync unmeasured, as
    the JAX package does."""
    dh = THolder.from_random("tiny-base", seed=0, dtype=torch.float32, device="cpu")
    be = TEngine(dh, cost_model=cost_model)
    assert be._dt_unet_step_measured and 0 < be.dt_unet_step != 0.01 and 0 < be.dt_vae != 0.01
    if cost_model == "batched":
        assert be._dt_step_by_batch == {2: be.dt_unet_step} and be.dt_sync is not None and be.dt_sync >= 0
    else:
        assert be._dt_step_by_batch == {} and be.dt_sync is None
    assert len(be.list_idx_injection) == len(be.list_nmb_stems) >= 1
    with pytest.raises(ValueError, match="cost_model"):
        TEngine(dh, run_benchmark=False, cost_model="fast")


def test_time_based_plan_matches_jax(engines):
    jbe, tbe = engines
    cases = [
        ((0.05, 0.1), dict(depth_strength=0.5, t_compute_max_allowed=10)),
        ((0.2, 0.3), dict(depth_strength=0.3, t_compute_max_allowed=20)),
        ((0.01, 0.02), dict(depth_strength=0.65, t_compute_max_allowed=3)),
        ((0.05, 0.1), dict(depth_strength=0.5, nmb_max_branches=4)),
        ((0.05, 0.1), dict(depth_strength=0.25, nmb_max_branches=10)),
        ((0.05, 0.1), dict()),
    ]
    try:
        for (dt_step, dt_vae), kw in cases:
            for be in (jbe, tbe):
                be.dt_unet_step, be.dt_vae = dt_step, dt_vae
                be.set_branching(**kw)
            assert tbe.list_idx_injection == list(jbe.list_idx_injection), kw
            assert tbe.list_nmb_stems == list(jbe.list_nmb_stems), kw
        with pytest.raises(ValueError, match="Either"):
            tbe.set_branching(t_compute_max_allowed=5, nmb_max_branches=4)
    finally:
        for be in (jbe, tbe):
            be.dt_unet_step, be.dt_vae = 0.01, 0.01


def test_measured_multilevel_cfg_transition_matches_jax(engines, monkeypatch):
    """The default (measured) policy over a two-level plan: per-level
    rounds, gap similarities measured between levels, CFG with guidance
    mid-dampening."""
    monkeypatch.delenv("LB_FUSED", raising=False)
    jbe, tbe = engines
    for be in (jbe, tbe):
        be.set_branching(depth_strength=0.5, nmb_max_branches=4)
    assert tbe.list_idx_injection == [4, 7] and tbe.list_nmb_stems == [1, 1]
    jimgs = jbe.run_transition(fixed_seeds=[10, 20])
    timgs = tbe.run_transition(fixed_seeds=[10, 20])
    for be in (jbe, tbe):
        assert [e["idx_injection"] for e in be.last_report.levels] == [4, 7]
        assert not any(e.get("fused") for e in be.last_report.levels)
    _assert_same_tree(jbe, tbe, jimgs, timgs)
    assert tbe._guidance_at(0.5) < tbe.guidance_scale_base


def test_stem_batch_rounds_match_jax(engines, monkeypatch):
    """stem_batch=1: a level of 2 stems runs as 2 rounds of one (the
    reference's policy: argmax over measured similarities before each)."""
    monkeypatch.delenv("LB_FUSED", raising=False)
    jbe, tbe = engines
    calls = []
    run = tbe.dh.run_diffusion_batched
    monkeypatch.setattr(tbe.dh, "run_diffusion_batched",
                        lambda cond, lat, *a, **kw: calls.append(lat.shape[0]) or run(cond, lat, *a, **kw))
    try:
        for be in (jbe, tbe):
            be.stem_batch = 1
            be.list_idx_injection, be.list_nmb_stems = [3, 5], [2, 1]
        jimgs = jbe.run_transition(fixed_seeds=[3, 4])
        timgs = tbe.run_transition(fixed_seeds=[3, 4])
    finally:
        for be in (jbe, tbe):
            be.stem_batch = 0
    assert calls == [2, 1, 1, 1]  # the edges, then three rounds of one stem
    assert not any(e.get("fused") for e in tbe.last_report.levels)
    _assert_same_tree(jbe, tbe, jimgs, timgs)


def test_config_round_trip(engines):
    jbe, tbe = engines
    assert tbe.get_config().to_dict() == jbe.get_config().to_dict()
    cfg = dataclasses.replace(tbe.get_config(), stem_batch=2, cost_model="reference",
                              placement_policy="predictive", guidance_scale=5.0, nmb_max_branches=6,
                              depth_strength=0.4, t_compute_max_allowed=None, seed1=7)
    other = TEngine(THolder.from_random("tiny-base", seed=1, dtype=torch.float32, device="cpu"),
                    run_benchmark=False, config=cfg)
    assert other.get_config() == cfg
    assert (other.stem_batch, other.cost_model, other.placement_policy) == (2, "reference", "predictive")
    assert other.guidance_scale_base == 5.0 and other.num_inference_steps == STEPS
    with pytest.raises(NotImplementedError, match="NLPD"):
        other.apply_config(dataclasses.replace(cfg, similarity_metric="lpips"))
    with pytest.raises(ValueError, match="placement_policy"):
        other.apply_config(dataclasses.replace(cfg, placement_policy="fast"))
    assert EngineConfig.defaults(False).to_dict()["num_inference_steps"] == 30


@pytest.mark.parametrize("policy", ["measured", "predictive"])
def test_extend_transition(policy, monkeypatch):
    """run([a]) + extend([b]) runs ONE new denoise call at the new depth.
    Under the measured policy it gives the tree of run([a, b]) exactly;
    under the predictive one, level b is placed from the measured
    similarities of the finished tree (they have landed), so only the
    tree's shape is checked."""
    monkeypatch.setenv("LB_FUSED", "0")
    dh = THolder.from_random("tiny-base", seed=0, dtype=torch.float32, device="cpu")

    def engine(plan):
        be = _setup(TEngine(dh, run_benchmark=False))
        be.placement_policy = policy
        be.list_idx_injection, be.list_nmb_stems = plan
        return be

    be = engine(([3], [2]))
    be.run_transition(fixed_seeds=[10, 11])
    calls = []
    run = dh.run_diffusion_batched
    monkeypatch.setattr(dh, "run_diffusion_batched",
                        lambda cond, lat, idx_start=0, **kw: calls.append(idx_start) or run(cond, lat, idx_start, **kw))
    imgs = [im.copy() for im in be.extend_transition([5], [2])]
    monkeypatch.undo()
    assert calls == [5]
    assert len(imgs) == 6 and be.tree_fracts == sorted(be.tree_fracts) and be.tree_idx_injection.count(5) == 2
    assert be.last_report.levels == [{"idx_injection": 5, "stems": 2, "extended": True,
                                      "wall_s": be.last_report.levels[0]["wall_s"]}]
    assert len(be.tree_similarities) == 5
    if policy == "measured":
        monkeypatch.setenv("LB_FUSED", "0")
        be2 = engine(([3, 5], [2, 2]))
        imgs2 = be2.run_transition(fixed_seeds=[10, 11])
        assert be2.tree_fracts == be.tree_fracts and be2.tree_idx_injection == be.tree_idx_injection
        for a, b in zip(imgs, imgs2):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="idx_injection"):
        be.extend_transition([STEPS], [1])
    with pytest.raises(RuntimeError, match="existing tree"):
        engine(([3], [1])).extend_transition([5], [1])


def test_predictive_multilevel_base_transition(engines, monkeypatch):
    """A predictive base engine's default run_transition reports the
    segmented path on every level (CFG on, tiny-base)."""
    monkeypatch.delenv("LB_FUSED", raising=False)
    _, tbe = engines
    tbe.placement_policy = "predictive"
    try:
        tbe.list_idx_injection, tbe.list_nmb_stems = [2, 4, 6], [2, 1, 1]
        imgs = tbe.run_transition(fixed_seeds=[1, 2])
    finally:
        tbe.placement_policy = "measured"
    assert len(imgs) == 6 and all(e.get("fused") and e.get("seg") for e in tbe.last_report.levels)
    assert len(tbe.tree_similarities) == 5 and all(np.isfinite(tbe.tree_similarities))
