"""The segmented multi-level transition of the port against the JAX package.

- runtime: denoise_scan_tree_seg, port vs JAX, segment by segment, for
  euler, euler_ancestral (JAX's per-step draws of the live batch injected)
  and dpmpp_2m, with and without a recycled-edge window, CFG on and off.
  Trajectories within rtol 5e-3 / atol 5e-4, the repo's f32 tiny bound.
- planning: _seg_plan, _plan_multilevel and _multilevel_fusable give the
  JAX package's results over several plans, recycled included.
- engine: run_transition under the predictive policy takes the segmented
  path in both packages on the plan ([1,2,3],[2,2,1]) (default, recycled
  chain, branch1 crossfeed, dpmpp_2m). tree_fracts and
  tree_idx_injection exactly equal, uint8 keyframes within 1 LSB,
  similarities rtol 1e-4, final latents of every branch within the f32
  tiny bound.
- the port's segmented path equals its own predictive per-level path
  (LB_FUSED=0): keyframes within 1 LSB, final latents rtol/atol 2e-4, as
  tests/test_fused_tree_multi.py holds the JAX package.
- the cost model: predict_transition_time, planner_calibrated and the
  gate give the JAX package's results under LB_FUSED auto/0/1 for the same
  calibration inputs, the predictive policy's single sync included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.ops.scheduler import SDXL_TURBO_SCHEDULER, make_schedule
from latentblending_tpu.runtime import denoise as jd
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.runtime import denoise as td
from latentblending_tpu_torch.runtime.holder import SDXLHolder as THolder
from tests.torch_port_util import inject_jax_noise, port_holder_from_jax, tiny_unet_pair

POOLED = 48
PLAN = ([1, 2, 3], [2, 2, 1])
PROMPTS = ("photo of a forest at dawn", "photo of a city at night")


# ---------------------------------------------------------------- runtime


@pytest.fixture(scope="module")
def unets():
    return tiny_unet_pair(POOLED)


@pytest.mark.parametrize("sched,use_cfg,window", [
    ("euler", False, False),
    ("euler", True, True),
    ("euler_ancestral", True, False),
    ("dpmpp_2m", True, False),
    ("dpmpp_2m", False, True),
])
def test_denoise_scan_tree_seg_matches_jax(unets, sched, use_cfg, window):
    """Segments (0,2), (1,4), (3,5): edges 0-1 live from step 0, stems 2-3
    enter at step 1 (parents: the edges), stem 4 at step 3 (parents: stems
    2 and 3), each pinned by coefficient 1.0 at its entry step. With a
    window, rows 1, 2 and 4 read their parent-1 state from it."""
    j_apply, params, t_apply = unets
    rng = np.random.default_rng(21)
    N, B = 4, 5
    segs = ((0, 2), (1, 4), (3, 5))
    live = [2, 4, 4, 5]
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32) * 4.0
    parent_idx = np.array([[0, 0], [0, 0], [0, 1], [0, 1], [2, 3]], np.int32)
    parent_fract = np.array([0.0, 0.0, 0.3, 0.7, 0.5], np.float32)
    pins = np.array([0, 0, 1, 1, 3], np.int32)
    coeffs = rng.uniform(0.2, 0.8, size=(N, B)).astype(np.float32)
    coeffs[0] = 0.0
    coeffs[1, 2:4] = 1.0
    coeffs[3, 4] = 1.0
    win = rng.normal(size=(N, 8, 8, 4)).astype(np.float32) * 3.0 if window else None
    win_mask = np.array([False, True, True, False, True]) if window else None
    pe, ne = (rng.normal(size=(B, 77, 64)).astype(np.float32) for _ in range(2))
    pool, npool = (rng.normal(size=(B, POOLED)).astype(np.float32) for _ in range(2))
    tids = np.tile(np.array([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]], np.float32), (B, 1))
    g = np.array([5.0, 2.0, 3.0, 4.0, 6.0], np.float32)
    sch = make_schedule(SDXL_TURBO_SCHEDULER, N)
    plan_kw = dict(num_steps=N, idx_start=0, batch=B, use_cfg=use_cfg,
                   guidance_rescale=0.7 if use_cfg else 0.0, sched=sched, segs=segs)
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    z = [np.asarray(jax.random.normal(k, (b, 8, 8, 4), jnp.float32)) for k, b in zip(keys, live)]

    jcond = jd.Conditioning(*(jnp.asarray(x) for x in (pe, pool, tids, ne, npool, tids)))
    want = jd.denoise_scan_tree_seg(
        j_apply, params, jd.DenoisePlan(tree=True, win=window, **plan_kw), jnp.asarray(lat), jcond,
        jnp.asarray(parent_idx), jnp.asarray(parent_fract), jnp.asarray(coeffs), jnp.asarray(sch.sigmas),
        jnp.asarray(sch.timesteps), jnp.asarray(g), step_keys=keys,
        win_steps=None if win is None else jnp.asarray(win),
        win_mask=None if win_mask is None else jnp.asarray(win_mask), pin_steps=jnp.asarray(pins),
    )
    tcond = td.Conditioning(*(torch.from_numpy(x) for x in (pe, pool, tids, ne, npool, tids)))
    with torch.no_grad():
        got = td.denoise_scan_tree_seg(
            t_apply, td.DenoisePlan(**plan_kw), torch.from_numpy(lat), tcond, parent_idx,
            torch.from_numpy(parent_fract), torch.from_numpy(coeffs), sch.sigmas, sch.timesteps,
            torch.from_numpy(g), noise=[torch.from_numpy(x) for x in z],
            win_steps=None if win is None else torch.from_numpy(win), win_mask=win_mask, pin_steps=pins,
        )
    assert [tuple(t.shape) for t in got] == [(1, 2, 8, 8, 4), (2, 4, 8, 8, 4), (1, 5, 8, 8, 4)]
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=5e-3, atol=5e-4)


def test_seg_ancestral_without_noise_raises():
    plan = td.DenoisePlan(num_steps=2, idx_start=0, batch=1, use_cfg=False, sched="euler_ancestral",
                          segs=((0, 1),))
    with pytest.raises(ValueError, match="noise"):
        td.denoise_scan_tree_seg(None, plan, torch.zeros(1, 8, 8, 4), None, np.zeros((1, 2), np.int64),
                                 torch.zeros(1), torch.zeros(2, 1), np.ones(3, np.float32),
                                 np.ones(2, np.float32), torch.ones(1))


# ------------------------------------------------------------- planning


@pytest.fixture(scope="module")
def holders():
    """The tiny-turbo JAX holder and a port holder with its weights and noise."""
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    tdh = port_holder_from_jax(jdh, "tiny-turbo")
    inject_jax_noise(tdh, jdh)
    return jdh, tdh


def _set_plan(be, plan, policy="predictive", stem_batch=0):
    be.placement_policy = policy
    be.stem_batch = stem_batch
    be.list_idx_injection, be.list_nmb_stems = [list(x) for x in plan]
    return be


def test_plans_match_jax(holders):
    jdh, tdh = holders
    jbe, tbe = JEngine(jdh, run_benchmark=False), TEngine(tdh)
    fusable = [([1, 2, 3], [2, 2, 1]), ([1, 3], [3, 2]), ([2, 3], [1, 4]), ([1, 2], [5, 1])]
    refused = [([2, 2], [1, 1]), ([1, 2], [2, 0]), ([0, 2], [1, 1]), ([2], [3])]
    for plan in fusable + refused:
        for policy in ("predictive", "measured"):
            for stem_batch in (0, 1):
                for be in (jbe, tbe):
                    _set_plan(be, plan, policy, stem_batch)
                assert tbe._multilevel_fusable() == jbe._multilevel_fusable()
        assert tbe._multilevel_fusable() is False  # measured policy, stem_batch 1
    try:
        for be in (jbe, tbe):
            be.set_num_inference_steps(30)
        plans = fusable + [([15, 18, 21, 24, 27], [3, 2, 1, 1, 1]), ([9, 14, 19], [4, 2, 1])]
        for plan in plans:
            for be in (jbe, tbe):
                _set_plan(be, plan)
            assert tbe._multilevel_fusable() and jbe._multilevel_fusable()
            for recycled1 in (False, True):
                assert tbe._seg_plan(recycled1) == jbe._seg_plan(recycled1)
                assert tbe._plan_multilevel(recycled1) == jbe._plan_multilevel(recycled1)
        # the smoke run's plan: 6 segments, 147 useful row-steps
        _set_plan(tbe, ([15, 18, 21, 24, 27], [3, 2, 1, 1, 1]))
        assert tbe._seg_plan(False) == ([(0, 2), (15, 5), (18, 7), (21, 8), (24, 9), (27, 10)], 147)
    finally:
        for be in (jbe, tbe):
            be.set_num_inference_steps(4)


# ----------------------------------------------------------------- engine


def _setup(be, plan=PLAN):
    be.set_prompt1(PROMPTS[0])
    be.set_prompt2(PROMPTS[1])
    # partial parental crossfeed: each stem's own solver state and history
    # reach its keyframe
    be.set_parental_crossfeed(0.3, 0.6, 0.9)
    return _set_plan(be, plan)


def _assert_seg_report(be, recycled=False):
    lv = be.last_report.levels
    assert [e["idx_injection"] for e in lv] == PLAN[0] and [e["stems"] for e in lv] == PLAN[1]
    assert all(e.get("fused") is True and e.get("seg") is True and e.get("recycled") is recycled for e in lv)


@pytest.mark.parametrize("variant", ["default", "recycled", "branch1", "dpmpp_2m"])
def test_fused_multi_matches_jax(variant, holders, monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    jdh, tdh = holders
    saved = (jdh.schedule, tdh.schedule)
    try:
        if variant == "dpmpp_2m":
            jdh.set_scheduler_type("dpmpp_2m")
            tdh.set_scheduler_type("dpmpp_2m")
        out = []
        for be in (JEngine(jdh, run_benchmark=False), TEngine(tdh)):
            _setup(be)
            if variant == "branch1":
                be.set_branch1_crossfeed(0.5, 0.7, 0.2)
            imgs = be.run_transition(fixed_seeds=[5, 6])
            if variant == "recycled":
                be.swap_forward()
                be.set_prompt2("photo of a bird")
                imgs = be.run_transition(recycle_img1=True, fixed_seeds=[6, 7])
            out.append((be, [np.asarray(im) for im in imgs]))
    finally:
        jdh.schedule, tdh.schedule = saved
    (jbe, jimgs), (tbe, timgs) = out
    for be in (jbe, tbe):
        _assert_seg_report(be, recycled=variant == "recycled")
    assert tbe.tree_fracts == list(jbe.tree_fracts)
    assert tbe.tree_idx_injection == list(jbe.tree_idx_injection)
    assert sorted(tbe.tree_idx_injection) == [0, 0, 1, 1, 2, 2, 3]
    assert len(timgs) == len(jimgs) == 7
    for t, j in zip(timgs, jimgs):
        assert t.shape == (128, 128, 3) and t.dtype == np.uint8
        assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
    np.testing.assert_allclose(tbe.tree_similarities, jbe.tree_similarities, rtol=1e-4)
    for t, j in zip(tbe.tree_latents, jbe.tree_latents):
        assert len(t) == len(j) == 4
        np.testing.assert_allclose(t[-1].numpy(), np.asarray(j[-1]), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("scheduler", [None, "dpmpp_2m"])
def test_port_fused_multi_equals_predictive_per_level(scheduler, monkeypatch):
    tdh = THolder.from_random("tiny-turbo", seed=0, dtype=torch.float32, device="cpu")
    if scheduler is not None:
        tdh.set_scheduler_type(scheduler)
    be = _setup(TEngine(tdh))
    monkeypatch.setenv("LB_FUSED", "0")
    imgs_ref = [im.copy() for im in be.run_transition(fixed_seeds=[5, 6])]
    fr_ref, idx_ref = list(be.tree_fracts), list(be.tree_idx_injection)
    lat_ref = [t[-1].clone() for t in be.tree_latents]
    assert not any(e.get("fused") for e in be.last_report.levels)
    monkeypatch.delenv("LB_FUSED")
    imgs = be.run_transition(fixed_seeds=[5, 6])
    _assert_seg_report(be)
    assert be.tree_fracts == fr_ref and be.tree_idx_injection == idx_ref
    for a, b in zip(imgs_ref, imgs):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    for a, t in zip(lat_ref, be.tree_latents):
        np.testing.assert_allclose(a.numpy(), t[-1].numpy(), rtol=2e-4, atol=2e-4)


def test_seg_ancestral_draws_follow_the_live_batch(monkeypatch):
    """euler_ancestral in the segmented call: ONE draw call per transition,
    step i of the live batch's shape (JAX draws step_keys[i] at that shape,
    which tests/torch_port_util.py injects), deterministic on a re-run."""
    monkeypatch.delenv("LB_FUSED", raising=False)
    tdh = THolder.from_random("tiny-ancestral", seed=0, dtype=torch.float32, device="cpu")
    calls = []
    draw = tdh.ancestral_noise_steps
    tdh.ancestral_noise_steps = lambda shapes: calls.append([s[0] for s in shapes]) or draw(shapes)
    be = _setup(TEngine(tdh))
    a = [im.copy() for im in be.run_transition(fixed_seeds=[1, 2])]
    _assert_seg_report(be)
    assert calls == [[2, 4, 6, 7]]
    for x, y in zip(a, be.run_transition(fixed_seeds=[1, 2])):
        np.testing.assert_array_equal(x, y)


def test_measured_policy_refuses_the_segmented_path(monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    be = _setup(TEngine(THolder.from_random("tiny-turbo", seed=1, dtype=torch.float32, device="cpu")))
    be.placement_policy = "measured"
    assert not be._multilevel_fusable()
    be.run_transition(fixed_seeds=[5, 6])
    assert not any(e.get("fused") for e in be.last_report.levels)
    with pytest.raises(ValueError, match="placement_policy"):
        be.placement_policy = "greedy"


def test_fused_multi_calibration_is_warm_only(monkeypatch):
    """The first segmented call of a holder is cold (no sample); the second
    calibrates dt_unet_step_fused_multi and the output tail only."""
    monkeypatch.delenv("LB_FUSED", raising=False)
    be = _setup(TEngine(THolder.from_random("tiny-turbo", seed=1, dtype=torch.float32, device="cpu")))
    be.run_transition(fixed_seeds=[1, 2])
    assert not be.dh.last_run_was_warm and be.dt_unet_step_fused_multi is None
    be.run_transition(fixed_seeds=[1, 2])
    assert be.dh.last_run_was_warm and be.dt_unet_step_fused_multi > 0 and be._dt_fused_output > 0
    assert be.dt_unet_step_fused is None and be._dt_step_by_batch == {}
    assert be.planner_calibrated()
    # a resolution change drops the segmented calibration too
    be.set_dimensions((256, 256))
    assert be.dt_unet_step_fused_multi is None


# ------------------------------------------------------------- cost model


@pytest.mark.parametrize("gate", ["auto", "0", "1"])
def test_cost_model_matches_jax(gate, holders, monkeypatch):
    """predict_transition_time / planner_calibrated / the gate's choice with
    the same calibration inputs in both packages: equal results, for
    multi-level plans under both policies and stem batches 0, 1 and 2."""
    if gate == "auto":
        monkeypatch.delenv("LB_FUSED", raising=False)
    else:
        monkeypatch.setenv("LB_FUSED", gate)
    jdh, tdh = holders
    jbe, tbe = JEngine(jdh, run_benchmark=False), TEngine(tdh)
    cal = dict(dt_unet_step=0.10, dt_vae=0.01, dt_sync=0.05)
    cases = [
        # fused-multi priced cheap, calibrated
        (PLAN, dict(cal, dt_unet_step_fused_multi=0.02), {1: 0.30, 2: 0.10}, 0.03),
        # fused-multi priced prohibitively: per-level wins when calibrated
        (PLAN, dict(cal, dt_unet_step_fused_multi=10.0), {1: 0.30, 2: 0.10}, 0.03),
        # uncalibrated segmented path (falls back to the fused / step cost)
        (([1, 3], [3, 2]), dict(cal, dt_unet_step_fused_multi=None, dt_unet_step_fused=0.04), {2: 0.1, 3: 0.2},
         None),
        (([1, 3], [3, 2]), dict(cal, dt_sync=None, dt_unet_step_fused_multi=None), {}, None),
        # a single-level plan beside them
        (([2], [5]), dict(cal, dt_unet_step_fused=0.02, dt_unet_step_fused_multi=0.01), {2: 0.1, 5: 0.11}, 0.2),
    ]
    for plan, dts, by_batch, out_tail in cases:
        for policy in ("measured", "predictive"):
            for stem_batch in (0, 1, 2):
                for be in (jbe, tbe):
                    _set_plan(be, plan, policy, stem_batch)
                    be.dt_unet_step_fused = None
                    for k, v in dts.items():
                        setattr(be, k, v)
                    be._dt_step_by_batch = dict(by_batch)
                    be._dt_fused_output = out_tail
                for recycled1 in (False, True):
                    got, want = tbe.predict_transition_time(recycled1), jbe.predict_transition_time(recycled1)
                    assert got == want, (plan, policy, stem_batch, recycled1)
                    assert tbe.planner_calibrated(recycled1) == jbe.planner_calibrated(recycled1)
                    assert tbe._fused_predicted_faster(recycled1) == jbe._fused_predicted_faster(recycled1)
    # the predictive policy charges ONE sync, the measured two per round
    for be in (jbe, tbe):
        _set_plan(be, PLAN, "measured")
        be.dt_sync, be.dt_vae, be._dt_step_by_batch = 0.05, 0.0, {}
        be.dt_unet_step = 0.0
    t_measured = tbe.predict_transition_time()["t_per_level_s"]
    tbe.placement_policy = "predictive"
    assert t_measured == pytest.approx(2 * 0.05 * 3)
    assert tbe.predict_transition_time()["t_per_level_s"] == pytest.approx(0.05)
